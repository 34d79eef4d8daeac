"""ctypes wrapper for the fused native region encoder (src/region_encode.cpp).

Returns the same candidates as the Python RegionalSummary path, as a
CandidateBatch whose arrays are views of the encoder's own result block;
tests/test_torch_native_encode.py asserts bit-equality between the two
backends.
"""
import ctypes
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.region_encoder import (CandidateBatch, CandidateImage,
                                              TruthRecord)
from pepper_tpu_torch.native import bamio
from pepper_tpu_torch.options import AlignerOptions, ImageOptions


class _EncodeResult(ctypes.Structure):
    # every array lies in `block`, one allocation the arrays' views borrow
    _fields_ = [
        ("n", ctypes.c_int32),
        ("positions", ctypes.c_void_p),
        ("depths", ctypes.c_void_p),
        ("type_labels", ctypes.c_void_p),
        ("base_labels", ctypes.c_void_p),
        ("cand_freqs", ctypes.c_void_p),
        ("cand_buf", ctypes.c_void_p),   # candidates separated by '\n'
        ("images", ctypes.c_void_p),
        ("cand_buf_len", ctypes.c_int64),
        ("window1", ctypes.c_int32),
        ("features", ctypes.c_int32),
        ("seconds", ctypes.c_double * 4),
        ("block", ctypes.c_void_p),
        ("block_len", ctypes.c_int64),
    ]


# the thread CPU seconds of encode_region's sections, in EncodeResult order:
# the window's records decoded (BGZF inflate included), the event walk, the
# image rows and thresholds (and train labels), the gates and windows
SECTIONS = ("(encode_fetch)", "(encode_walk)", "(encode_site)",
            "(encode_render)")


_bound = False
_bind_lock = threading.Lock()


def _lib():
    global _bound
    bamio._load()
    lib = bamio._lib
    if lib is None:
        raise RuntimeError(f"native encoder unavailable: {bamio._build_error}")
    if _bound:
        return lib
    with _bind_lock:
        if _bound:
            return lib
        lib.encode_region.restype = ctypes.POINTER(_EncodeResult)
        lib.encode_region.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64, ctypes.c_double, ctypes.c_uint32,
            # truth hap1
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
            # truth hap2
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ]
        lib.encode_region_hp.restype = ctypes.POINTER(_EncodeResult)
        # same signature as encode_region
        lib.encode_region_hp.argtypes = lib.encode_region.argtypes
        lib.encode_result_free.argtypes = [ctypes.POINTER(_EncodeResult)]
        lib.encode_result_free.restype = None
        _bound = True
    return lib


def available() -> bool:
    return bamio.available()


def _flatten_truth(records: Sequence[TruthRecord]):
    n = len(records)
    pos = np.array([r.pos_start for r in records] or [0], dtype=np.int64)
    end = np.array([r.pos_end for r in records] or [0], dtype=np.int64)
    ref_off, alt_off = [0], [0]
    ref_buf, alt_buf = [], []
    for r in records:
        ref_buf.append(r.ref)
        alt_buf.append(r.alt)
        ref_off.append(ref_off[-1] + len(r.ref))
        alt_off.append(alt_off[-1] + len(r.alt))
    return (n, pos, end,
            np.array(ref_off, dtype=np.int32), "".join(ref_buf).encode(),
            np.array(alt_off, dtype=np.int32), "".join(alt_buf).encode())


def encode_region_native(
        bam_path: str, chunks: List[Tuple[int, int]], ref_id: int,
        contig: str, fetch_start: int, fetch_stop: int,
        region_start: int, region_end: int, ref_seq: str,
        include_supplementary: bool, min_mapq: int,
        min_snp_baseq: float, min_indel_baseq: float,
        snp_freq_threshold: float, insert_freq_threshold: float,
        delete_freq_threshold: float, min_coverage_threshold: float,
        snp_candidate_freq_threshold: float,
        indel_candidate_freq_threshold: float,
        candidate_support_threshold: float, skip_indels: bool,
        candidate_region_start: int, candidate_region_end: int,
        train_mode: bool = False,
        hap1: Sequence[TruthRecord] = (), hap2: Sequence[TruthRecord] = (),
        downsample_rate: float = 1.0,
        max_reads: int = AlignerOptions.MAX_READS_IN_REGION,
        random_seed: int = AlignerOptions.RANDOM_SEED,
        window_size: int = ImageOptions.CANDIDATE_WINDOW_SIZE,
        feature_size: int = ImageOptions.IMAGE_HEIGHT,
        hp_mode: bool = False) -> CandidateBatch:
    lib = _lib()
    flat = np.asarray(chunks, dtype=np.uint64).reshape(-1)
    t1 = _flatten_truth(hap1)
    t2 = _flatten_truth(hap2)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    fn = lib.encode_region_hp if hp_mode else lib.encode_region
    res_ptr = fn(
        bam_path.encode(),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(chunks),
        ref_id, fetch_start, fetch_stop, region_start, region_end,
        ref_seq.encode(), 1 if include_supplementary else 0, min_mapq,
        float(min_snp_baseq), float(min_indel_baseq),
        float(snp_freq_threshold), float(insert_freq_threshold),
        float(delete_freq_threshold), float(min_coverage_threshold),
        float(snp_candidate_freq_threshold),
        float(indel_candidate_freq_threshold),
        float(candidate_support_threshold), 1 if skip_indels else 0,
        candidate_region_start, candidate_region_end, window_size,
        feature_size, 1 if train_mode else 0,
        max_reads, float(downsample_rate), random_seed,
        t1[0], p64(t1[1]), p64(t1[2]), p32(t1[3]), t1[4], p32(t1[5]), t1[6],
        t2[0], p64(t2[1]), p64(t2[2]), p32(t2[3]), t2[4], p32(t2[5]), t2[6])
    if not res_ptr:
        raise OSError(f"native encode failed for {bam_path}")
    res = res_ptr.contents
    n, block = res.n, res.block
    win1, feat = res.window1, res.features
    # the 21x48 encoder keeps no section timers
    sections = None if hp_mode else dict(zip(SECTIONS, res.seconds))
    if n == 0:
        lib.encode_result_free(res_ptr)
        empty_i = np.zeros(0, np.int64)
        empty = np.zeros(0, np.int32)
        return CandidateBatch(contig, empty_i, empty, [], empty,
                              np.zeros((0, win1, feat), np.int8),
                              empty, empty, sections)
    # the arrays are views of the native block, freed with their last view
    raw = (ctypes.c_char * res.block_len).from_address(block)
    weakref.finalize(raw, lib.encode_result_free, res_ptr)

    def view(addr, dtype, shape):
        count = int(np.prod(shape))
        return np.frombuffer(raw, dtype, count, addr - block).reshape(shape)

    cands = ctypes.string_at(res.cand_buf, res.cand_buf_len).decode() \
        .split("\n")
    return CandidateBatch(
        contig, view(res.positions, np.int64, (n,)),
        view(res.depths, np.int32, (n,)), cands,
        view(res.cand_freqs, np.int32, (n,)),
        view(res.images, np.int8, (n, win1, feat)),
        view(res.base_labels, np.int32, (n,)),
        view(res.type_labels, np.int32, (n,)), sections)
