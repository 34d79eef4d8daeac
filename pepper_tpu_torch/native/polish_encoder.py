"""ctypes wrapper for the fused native polish pileup encoder
(src/polish_encode.cpp).

Returns the (image, positions, indices) arrays of one region's expanded
pileup — the same values as the Python PolishSummary oracle
(pepper_tpu_torch/polish/summary.py); tests/test_polish_native.py asserts
bit-equality between the two backends.
"""
import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from pepper_tpu_torch.native import bamio
from pepper_tpu_torch.options import AlignerOptions


class _PolishEncodeResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("image", ctypes.POINTER(ctypes.c_uint8)),
        ("positions", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("n_reads", ctypes.c_int64),
    ]


_bound = False
_bind_lock = threading.Lock()


def _lib():
    global _bound
    bamio._load()
    lib = bamio._lib
    if lib is None:
        raise RuntimeError(
            f"native polish encoder unavailable: {bamio._build_error}")
    if _bound:
        return lib
    with _bind_lock:
        if _bound:
            return lib
        lib.polish_encode_region.restype = ctypes.POINTER(_PolishEncodeResult)
        lib.polish_encode_region.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_uint32]
        lib.polish_encode_result_free.argtypes = [
            ctypes.POINTER(_PolishEncodeResult)]
        lib.polish_encode_result_free.restype = None
        _bound = True
    return lib


def available() -> bool:
    return bamio.available()


def polish_encode_native(
        bam, chromosome: str, region_start: int, region_end: int,
        realign_ref: str, realignment_flag: bool,
        band: int = 128, max_reads: int = 1500,
        random_seed: int = AlignerOptions.RANDOM_SEED
        ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One region's expanded pileup: (image uint8 [P,10], positions
    int64 [P], indices int32 [P]), or None when the region has no reads.

    `bam` is an open pepper_tpu_torch.io.bam_reader.BamReader; `realign_ref` is
    the reference slice anchored at region_start covering
    [region_start, region_end + ALIGNMENT_SAFE_BASES). Region bounds are
    inclusive (the PolishSummary convention)."""
    lib = _lib()
    ref_id = bam._ref_ids[chromosome]
    chunks = bam._index.chunks_for(ref_id, max(0, region_start), region_end)
    flat = np.asarray(chunks, dtype=np.uint64).reshape(-1)
    ref_b = realign_ref.encode()
    res_ptr = lib.polish_encode_region(
        bam.path.encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(chunks),
        ref_id, region_start, region_end, ref_b, len(ref_b),
        1 if realignment_flag else 0, band, max_reads, random_seed)
    if not res_ptr:
        raise MemoryError("polish_encode_region failed")
    try:
        res = res_ptr.contents
        n = int(res.n)
        if res.n_reads == 0:
            return None
        image = np.ctypeslib.as_array(res.image, (n, 10)).copy()
        positions = np.ctypeslib.as_array(res.positions, (n,)).copy()
        indices = np.ctypeslib.as_array(res.indices, (n,)).copy()
    finally:
        lib.polish_encode_result_free(res_ptr)
    return image, positions, indices


def _bind_multi(lib) -> None:
    if getattr(lib, "_polish_multi_bound", False):
        return
    c = ctypes
    lib.polish_encode_multi.restype = ctypes.POINTER(
        ctypes.POINTER(_PolishEncodeResult))
    lib.polish_encode_multi.argtypes = [
        c.c_char_p, c.POINTER(c.c_uint64), c.c_int, c.c_int32,
        c.c_int64, c.c_int64, c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_char_p,
        c.c_int64, c.POINTER(c.c_int64),
        c.c_int, c.c_int, c.c_int64, c.c_uint32]
    lib.polish_encode_multi_free.argtypes = [
        ctypes.POINTER(ctypes.POINTER(_PolishEncodeResult)), c.c_int]
    lib.polish_encode_multi_free.restype = None
    lib._polish_multi_bound = True


def polish_encode_multi_native(
        bam, chromosome: str, intervals, span_ref: str, span_start: int,
        ref_lens, realignment_flag: bool, band: int = 128,
        max_reads: int = 1500,
        random_seed: int = AlignerOptions.RANDOM_SEED):
    """Per-interval pileups for a group of contiguous intervals sharing
    ONE BAM fetch (polish_encode_multi): removes the ~read_length /
    interval_length decode amplification of per-interval fetches.
    `intervals` is [(start, end), ...] (inclusive bounds, ascending) on
    one contig; `span_ref` is anchored at span_start and covers
    [span_start, max_end + ALIGNMENT_SAFE_BASES) clipped to the contig;
    ref_lens[i] is the per-interval realignment reference length exactly
    as polish_encode_native would pass it. Returns a list of
    (image, positions, indices) or None per interval — bit-identical to
    per-interval polish_encode_native calls. None means no reads (or no
    length); a failed allocation raises MemoryError."""
    lib = _lib()
    _bind_multi(lib)
    ref_id = bam._ref_ids[chromosome]
    span_end = max(e for _s, e in intervals)
    chunks = bam._index.chunks_for(ref_id, max(0, span_start), span_end)
    flat = np.asarray(chunks, dtype=np.uint64).reshape(-1)
    starts = np.asarray([s for s, _e in intervals], np.int64)
    ends = np.asarray([e for _s, e in intervals], np.int64)
    lens = np.asarray(ref_lens, np.int64)
    n = len(intervals)
    arr_ptr = lib.polish_encode_multi(
        bam.path.encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(chunks),
        ref_id, span_start, span_end, n,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        span_ref.encode(), span_start,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if realignment_flag else 0, band, max_reads, random_seed)
    if not arr_ptr:
        raise MemoryError("polish_encode_multi failed")
    try:
        out = []
        for i in range(n):
            res_ptr = arr_ptr[i]
            if not res_ptr:
                # the C code leaves NULL only for an interval of no length;
                # for any other it returns a result (n_reads 0 when empty),
                # so a NULL there is a failed allocation, not "no reads"
                if ends[i] - starts[i] + 1 > 0:
                    raise MemoryError(f"polish_encode_multi failed on "
                                      f"{chromosome}:{starts[i]}-{ends[i]}")
                out.append(None)
                continue
            res = res_ptr.contents
            if res.n_reads == 0:
                out.append(None)
                continue
            m = int(res.n)
            out.append((np.ctypeslib.as_array(res.image, (m, 10)).copy(),
                        np.ctypeslib.as_array(res.positions, (m,)).copy(),
                        np.ctypeslib.as_array(res.indices, (m,)).copy()))
        return out
    finally:
        lib.polish_encode_multi_free(arr_ptr, n)
