"""ctypes wrapper for the fused native region encoder (src/region_encode.cpp).

Returns the same CandidateImage objects as the Python RegionalSummary path;
tests/test_native_encode.py asserts bit-equality between the two backends.
"""
import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.region_encoder import (CandidateBatch, CandidateImage,
                                              TruthRecord)
from pepper_tpu_torch.native import bamio
from pepper_tpu_torch.options import AlignerOptions, ImageOptions


class _EncodeResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int32),
        ("positions", ctypes.POINTER(ctypes.c_int64)),
        ("depths", ctypes.POINTER(ctypes.c_int32)),
        ("type_labels", ctypes.POINTER(ctypes.c_int32)),
        ("base_labels", ctypes.POINTER(ctypes.c_int32)),
        ("cand_freqs", ctypes.POINTER(ctypes.c_int32)),
        ("cand_offsets", ctypes.POINTER(ctypes.c_int32)),
        ("cand_buf", ctypes.c_char_p),
        ("images", ctypes.POINTER(ctypes.c_int8)),
        ("cand_buf_len", ctypes.c_int64),
        ("window1", ctypes.c_int32),
        ("features", ctypes.c_int32),
    ]


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
    try:
        n = res.n
        win1, feat = res.window1, res.features
        if n == 0:
            empty_i = np.zeros(0, np.int64)
            empty = np.zeros(0, np.int32)
            return CandidateBatch(contig, empty_i, empty, [], empty,
                                  np.zeros((0, win1, feat), np.int8),
                                  empty, empty)
        positions = np.ctypeslib.as_array(res.positions, (n,)).copy()
        depths = np.ctypeslib.as_array(res.depths, (n,)).copy()
        type_labels = np.ctypeslib.as_array(res.type_labels, (n,)).copy()
        base_labels = np.ctypeslib.as_array(res.base_labels, (n,)).copy()
        cand_freqs = np.ctypeslib.as_array(res.cand_freqs, (n,)).copy()
        cand_off = np.ctypeslib.as_array(res.cand_offsets, (n + 1,))
        cand_buf = ctypes.string_at(res.cand_buf, res.cand_buf_len)
        images = np.ctypeslib.as_array(res.images, (n, win1, feat)).copy()
        offs = cand_off.tolist()
        cands = [cand_buf[offs[i]:offs[i + 1]].decode() for i in range(n)]
        return CandidateBatch(contig, positions, depths, cands, cand_freqs,
                              images, base_labels, type_labels)
    finally:
        lib.encode_result_free(res_ptr)
