"""ctypes wrapper for the native BAM region fetcher (src/bamio.cpp).

Builds libbamio.so with g++ -O3 at first use into
build/pepper_tpu_torch/native/ at the root of the checkout (git-ignored;
rebuilt when a source is newer). Concurrent first uses serialize on a file
lock and the library is renamed into place only when complete. Falls back if
no toolchain (or no zlib) — callers check `available()` and use the
pure-Python reader otherwise; `build_error()` says why.
"""
import ctypes
import fcntl
import os
import subprocess
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "src", "bamio.cpp"),
         os.path.join(_DIR, "src", "region_encode.cpp"),
         os.path.join(_DIR, "src", "polish_encode.cpp"),
         os.path.join(_DIR, "src", "align.cpp"),
         os.path.join(_DIR, "src", "vcf_write.cpp")]
_HDRS = [os.path.join(_DIR, "src", "bam_common.h")]
_LIB = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                    "pepper_tpu_torch", "native", "libbamio.so")

_lib = None
_build_error: Optional[str] = None
# seconds this process spent building the library (0.0 when it was current)
build_seconds: Optional[float] = None
_load_lock = threading.Lock()


class _ReadSet(ctypes.Structure):
    _fields_ = [
        ("n_reads", ctypes.c_int32),
        ("pos", ctypes.POINTER(ctypes.c_int64)),
        ("pos_end", ctypes.POINTER(ctypes.c_int64)),
        ("seq_offset", ctypes.POINTER(ctypes.c_int64)),
        ("cigar_offset", ctypes.POINTER(ctypes.c_int64)),
        ("bad_offset", ctypes.POINTER(ctypes.c_int64)),
        ("name_offset", ctypes.POINTER(ctypes.c_int64)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("flags", ctypes.POINTER(ctypes.c_int32)),
        ("hp", ctypes.POINTER(ctypes.c_int32)),
        ("seq_len", ctypes.POINTER(ctypes.c_int32)),
        ("cigar_len", ctypes.POINTER(ctypes.c_int32)),
        ("bad_len", ctypes.POINTER(ctypes.c_int32)),
        ("name_len", ctypes.POINTER(ctypes.c_int32)),
        ("cigar_lens", ctypes.POINTER(ctypes.c_int32)),
        ("bad_buf", ctypes.POINTER(ctypes.c_int32)),
        ("cigar_ops", ctypes.POINTER(ctypes.c_uint8)),
        ("qual_buf", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_buf", ctypes.c_char_p),
        ("name_buf", ctypes.c_char_p),
        ("seq_buf_len", ctypes.c_int64),
        ("cigar_buf_len", ctypes.c_int64),
        ("bad_buf_len", ctypes.c_int64),
        ("name_buf_len", ctypes.c_int64),
    ]


def _stale() -> bool:
    return (not os.path.isfile(_LIB)
            or any(os.path.getmtime(f) > os.path.getmtime(_LIB)
                   for f in _SRCS + _HDRS))


def _build() -> Optional[str]:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    # the .so is always built on this machine, so -march=native is safe;
    # retry portably if the compiler rejects it
    for extra in (["-march=native"], []):
        cmd = (["g++", "-O3", "-std=c++17", "-shared", "-fPIC"] + extra
               + _SRCS + ["-o", tmp, "-lz"])
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            return f"{type(exc).__name__}: {exc}"
        if proc.returncode == 0:
            os.replace(tmp, _LIB)
            return None
    return proc.stderr[-2000:]


def _build_locked() -> Optional[str]:
    """Build under an exclusive file lock unless another process already
    brought the library up to date while this one waited."""
    global build_seconds
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    with open(_LIB + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _stale():
                build_seconds = 0.0
                return None
            t0 = time.time()
            err = _build()
            build_seconds = time.time() - t0
            return err
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load():
    # a single assignment of the fully-bound CDLL: concurrent first calls
    # must not race to create two CDLL objects (only one would get argtypes)
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return
    with _load_lock:
        _load_locked()


def _tune_malloc() -> None:
    """Raise glibc's mmap/trim thresholds so the encoder's large per-region
    scratch buffers are recycled inside the arena instead of being
    mmap'd/munmap'd on every call.

    Without this, worker THREADS (whose glibc arenas route big blocks to
    mmap) spend more time in munmap-triggered TLB shootdowns than in the
    encode itself — measured 5-10x wall-time inflation and ~90% sys time
    for the 2-thread encode on a 2-vCPU VM. A few hundred MB of cached
    arena per encode thread is the explicit trade."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        threshold = 256 * 1024 * 1024
        libc.mallopt(-3, threshold)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, threshold)   # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass   # non-glibc: nothing to tune


def _load_locked():
    global _lib, _build_error, build_seconds
    if _lib is not None or _build_error is not None:
        return
    if _stale():
        _build_error = _build_locked()
        if _build_error is not None:
            return
    else:
        build_seconds = 0.0
    _tune_malloc()
    lib = ctypes.CDLL(_LIB)
    lib.bam_fetch_region.restype = ctypes.POINTER(_ReadSet)
    lib.bam_fetch_region.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.readset_free.argtypes = [ctypes.POINTER(_ReadSet)]
    lib.readset_free.restype = None
    _lib = lib


def available() -> bool:
    _load()
    return _lib is not None


def polish_prof() -> Optional[dict]:
    """Drain the native polish encoder's cumulative section timers
    (seconds). Returns {fetch, realign, pileup, calls} or None."""
    _load()
    if _lib is None:
        return None
    buf = (ctypes.c_double * 4)()
    _lib.polish_prof_get(buf)
    return dict(fetch=buf[0], realign=buf[1], pileup=buf[2],
                calls=int(buf[3]))


def build_error() -> Optional[str]:
    _load()
    return _build_error


def fetch_region_reads(bam_path: str, chunks: List[Tuple[int, int]],
                       ref_id: int, start: int, stop: int,
                       include_supplementary: bool, min_mapq: int,
                       min_baseq: int):
    """Native region fetch -> list[TrimmedRead] (drop-in for the Python
    reader's get_reads body)."""
    from pepper_tpu_torch.io.bam_reader import TrimmedRead
    _load()
    if _lib is None:
        raise RuntimeError(f"native bamio unavailable: {_build_error}")
    flat = np.asarray(chunks, dtype=np.uint64).reshape(-1)
    rs_ptr = _lib.bam_fetch_region(
        bam_path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(chunks), ref_id, start, stop,
        1 if include_supplementary else 0, min_mapq, min_baseq)
    if not rs_ptr:
        raise OSError(f"native bamio failed to open {bam_path}")
    rs = rs_ptr.contents
    try:
        n = rs.n_reads
        if n == 0:
            return []
        pos = np.ctypeslib.as_array(rs.pos, (n,))
        pos_end = np.ctypeslib.as_array(rs.pos_end, (n,))
        mapq = np.ctypeslib.as_array(rs.mapq, (n,))
        flags = np.ctypeslib.as_array(rs.flags, (n,))
        hp = np.ctypeslib.as_array(rs.hp, (n,))
        seq_off = np.ctypeslib.as_array(rs.seq_offset, (n,))
        seq_len = np.ctypeslib.as_array(rs.seq_len, (n,))
        cig_off = np.ctypeslib.as_array(rs.cigar_offset, (n,))
        cig_len = np.ctypeslib.as_array(rs.cigar_len, (n,))
        bad_off = np.ctypeslib.as_array(rs.bad_offset, (n,))
        bad_len = np.ctypeslib.as_array(rs.bad_len, (n,))
        name_off = np.ctypeslib.as_array(rs.name_offset, (n,))
        name_len = np.ctypeslib.as_array(rs.name_len, (n,))
        seq_buf = ctypes.string_at(rs.seq_buf, rs.seq_buf_len)
        name_buf = ctypes.string_at(rs.name_buf, rs.name_buf_len)
        qual_buf = np.ctypeslib.as_array(rs.qual_buf, (max(1, rs.seq_buf_len),))
        cigar_ops = np.ctypeslib.as_array(rs.cigar_ops,
                                          (max(1, rs.cigar_buf_len),))
        cigar_lens = np.ctypeslib.as_array(rs.cigar_lens,
                                           (max(1, rs.cigar_buf_len),))
        bad_buf = np.ctypeslib.as_array(rs.bad_buf, (max(1, rs.bad_buf_len),))

        reads = []
        for i in range(n):
            s0, sl = int(seq_off[i]), int(seq_len[i])
            c0, cl = int(cig_off[i]), int(cig_len[i])
            b0, bl = int(bad_off[i]), int(bad_len[i])
            n0, nl = int(name_off[i]), int(name_len[i])
            reads.append(TrimmedRead(
                query_name=name_buf[n0:n0 + nl].decode(),
                pos=int(pos[i]), pos_end=int(pos_end[i]),
                sequence=seq_buf[s0:s0 + sl].decode(),
                base_qualities=qual_buf[s0:s0 + sl].tolist(),
                cigar_tuples=list(zip(cigar_ops[c0:c0 + cl].tolist(),
                                      cigar_lens[c0:c0 + cl].tolist())),
                mapping_quality=int(mapq[i]), flags=int(flags[i]),
                hp_tag=int(hp[i]), bad_indices=bad_buf[b0:b0 + bl].tolist()))
        return reads
    finally:
        _lib.readset_free(rs_ptr)
