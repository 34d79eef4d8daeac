"""Per-region resume journal for the streamed call_variant path.

SURVEY §5.4: the reference's only pipeline "checkpoint" is the stage
directory — a crashed 3 Gbp run re-encodes everything. Here the stream
appends every flushed prediction batch (plus per-interval row totals) to
an append-only journal; after a crash, the re-run replays the journal,
feeds the completed intervals' predictions straight into stage 3, and
re-encodes ONLY the intervals that never finished. The journal is
crash-safe by construction: records are length-prefixed and
CRC-guarded, so a torn tail write is detected and dropped rather than
corrupting the resume (unlike the HDF5 store, which has no
crash-consistency story). Deleted on successful completion.

Resume correctness invariants:
  * The fingerprint covers the interval list, the model, the run's
    setting (the runner's effective dtype and mesh size and, for polish,
    the realignment flag: each changes the predictions), AND the identity
    (abspath + size + mtime) of the input BAM/FASTA — a journal written
    against different inputs or under another setting is rejected, never
    silently replayed into a fresh VCF.
  * On resume the journal is COMPACTED before any new appends: it is
    atomically rewritten to hold only the completed intervals' totals
    and batch rows. Without this, a second crash would leave old
    partial rows + new rows for the same interval double-counting
    toward its total, falsely marking it complete.
  * Records are a fixed binary framing (type byte + typed arrays +
    length-prefixed strings) — loading a corrupted or attacker-written
    journal can fail, but it cannot execute code (no pickle).

Record types (logical tuples):
  ("total", interval_idx, n_rows)                   - encode-side counts
  ("batch", contigs, positions, depths, cand_lists, freqs, probs, runs)
  ("pseq", interval_idx, start, end, chunk_id, position, index, bases)
                                                    - one polish sequence

The same journal machinery serves both pipelines: the variant stream
journals prediction batches ("batch"), the polish stream one record per
flushed consensus sequence ("pseq").
"""
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def run_setting(dtype, mesh_size: int, **flags) -> Tuple[str, ...]:
    """The part of a run's setting that changes its predictions, for the
    fingerprint: the runner's effective dtype (bf16 only on a card), its
    mesh size (a batch split over N replicas can round otherwise in bf16)
    and any pipeline flag (polish: realignment_flag)."""
    return ((f"dtype={dtype}", f"mesh={mesh_size}")
            + tuple(f"{k}={v}" for k, v in sorted(flags.items())))


def _fingerprint(intervals, model_path: str,
                 inputs: Sequence[str] = (),
                 setting: Sequence[str] = ()) -> bytes:
    import hashlib
    h = hashlib.md5()
    for contig, start, end in intervals:
        h.update(f"{contig}:{start}-{end};".encode())
    h.update(os.path.abspath(model_path or "").encode())
    for item in setting:
        h.update(f"{item};".encode())
    for path in inputs:
        # identity, not content: abspath + size + mtime is cheap and
        # catches re-basecalled/re-aligned/replaced inputs (VERDICT r4)
        apath = os.path.abspath(path or "")
        h.update(apath.encode())
        try:
            st = os.stat(apath)
            h.update(struct.pack("<qq", st.st_size, st.st_mtime_ns))
        except OSError:
            h.update(b"<missing>")
    return h.hexdigest().encode()


# ---- safe (non-executable) record serialization ---------------------------

_REC_TOTAL = 1
_REC_BATCH = 2
_REC_PSEQ = 3


def _pack_arr(a) -> bytes:
    a = np.ascontiguousarray(a)
    if a.dtype.hasobject:
        raise TypeError(f"refusing to journal object dtype {a.dtype}")
    ds = a.dtype.str.encode()
    return (struct.pack("<B", len(ds)) + ds
            + struct.pack("<B", a.ndim)
            + struct.pack(f"<{a.ndim}q", *a.shape)
            + a.tobytes())


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise ValueError("truncated journal record")
        out = self.buf[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]


def _unpack_arr(cur: _Cursor) -> np.ndarray:
    ds = cur.take(cur.u8()).decode("ascii")
    dt = np.dtype(ds)
    if dt.hasobject:
        raise ValueError("object dtype in journal")
    ndim = cur.u8()
    shape = struct.unpack(f"<{ndim}q", cur.take(8 * ndim))
    count = 1
    for d in shape:
        if d < 0:
            raise ValueError("negative dim in journal")
        count *= d
    raw = cur.take(count * dt.itemsize)
    return np.frombuffer(raw, dt).reshape(shape).copy()


def _encode_record(record) -> bytes:
    kind = record[0]
    if kind == "total":
        return struct.pack("<Bqq", _REC_TOTAL, int(record[1]),
                           int(record[2]))
    if kind == "pseq":
        _, idx, start, end, chunk_id, position, index, bases = record
        return (struct.pack("<Bqqqq", _REC_PSEQ, int(idx), int(start),
                            int(end), int(chunk_id))
                + _pack_arr(np.asarray(position, np.int64))
                + _pack_arr(np.asarray(index, np.int32))
                + _pack_arr(np.asarray(bases).astype(np.uint8)))
    if kind != "batch":
        raise ValueError(f"unknown journal record {kind!r}")
    contigs, positions, depths, cand_lists, freqs, probs, runs = record[1:]
    parts = [struct.pack("<B", _REC_BATCH)]
    # contigs as run-length (name, count) pairs: batches are contig-grouped
    rle: List[Tuple[bytes, int]] = []
    for name in contigs:
        nb = name.encode()
        if rle and rle[-1][0] == nb:
            rle[-1] = (nb, rle[-1][1] + 1)
        else:
            rle.append((nb, 1))
    parts.append(struct.pack("<I", len(rle)))
    for nb, count in rle:
        parts.append(struct.pack("<I", len(nb)) + nb
                     + struct.pack("<I", count))
    parts.append(_pack_arr(np.asarray(positions)))
    parts.append(_pack_arr(np.asarray(depths)))
    counts = np.fromiter((len(c) for c in cand_lists), np.int32,
                         count=len(cand_lists))
    strs = [s.encode() for row in cand_lists for s in row]
    lens = np.fromiter((len(s) for s in strs), np.int32, count=len(strs))
    blob = b"".join(strs)
    parts.append(_pack_arr(counts))
    parts.append(_pack_arr(lens))
    parts.append(struct.pack("<Q", len(blob)) + blob)
    parts.append(_pack_arr(np.asarray(freqs)))
    parts.append(_pack_arr(np.asarray(probs)))
    runs_arr = np.asarray([(int(i), int(k)) for i, k in runs],
                          np.int64).reshape(-1, 2)
    parts.append(_pack_arr(runs_arr))
    return b"".join(parts)


def _decode_record(raw: bytes):
    cur = _Cursor(raw)
    kind = cur.u8()
    if kind == _REC_TOTAL:
        return ("total", cur.i64(), cur.i64())
    if kind == _REC_PSEQ:
        idx, start, end, chunk_id = (cur.i64(), cur.i64(), cur.i64(),
                                     cur.i64())
        return ("pseq", idx, start, end, chunk_id, _unpack_arr(cur),
                _unpack_arr(cur), _unpack_arr(cur))
    if kind != _REC_BATCH:
        raise ValueError(f"unknown journal record type {kind}")
    contigs: List[str] = []
    for _ in range(cur.u32()):
        name = cur.take(cur.u32()).decode()
        contigs.extend([name] * cur.u32())
    positions = _unpack_arr(cur)
    depths = _unpack_arr(cur)
    counts = _unpack_arr(cur)
    lens = _unpack_arr(cur)
    blob = cur.take(struct.unpack("<Q", cur.take(8))[0])
    strs: List[str] = []
    off = 0
    for ln in lens.tolist():
        strs.append(blob[off:off + ln].decode())
        off += ln
    cand_lists: List[List[str]] = []
    si = 0
    for c in counts.tolist():
        cand_lists.append(strs[si:si + c])
        si += c
    freqs = _unpack_arr(cur)
    probs = _unpack_arr(cur)
    runs = [tuple(r) for r in _unpack_arr(cur).tolist()]
    return ("batch", contigs, positions, depths, cand_lists, freqs,
            probs, runs)


class ResumeJournal:
    """Append-only writer. One instance per stream; append() is called
    from the flusher thread and the main loop — guarded by the caller
    (writes happen only under the flush path's ordering)."""

    MAGIC = b"PTRJ2"

    def __init__(self, path: str, intervals, model_path: str,
                 inputs: Sequence[str] = (), setting: Sequence[str] = ()):
        self.path = path
        self._lock = threading.Lock()   # flusher + main loop both append
        # truncate to the last VALID record first: appending after a torn
        # tail would hide everything written from then on
        valid_end = _valid_length(path) if os.path.isfile(path) else 0
        self._fh = open(path, "r+b" if valid_end else "wb")
        self._fh.truncate(valid_end)
        self._fh.seek(valid_end)
        if valid_end == 0:
            self._raw(self.MAGIC + _fingerprint(intervals, model_path,
                                                inputs, setting))

    def _raw(self, payload: bytes) -> None:
        crc = zlib.crc32(payload)
        self._fh.write(struct.pack("<II", len(payload), crc))
        self._fh.write(payload)
        # flush to the OS, no fsync: page-cache data survives kill -9 (the
        # resume threat model); a record lost to an OS crash only means
        # one interval re-encodes — the CRC framing drops any torn tail
        self._fh.flush()

    def append(self, record) -> None:
        with self._lock:
            self._raw(_encode_record(record))

    def close(self) -> None:
        self._fh.close()

    def delete(self) -> None:
        self.close()
        try:
            os.remove(self.path)
        except OSError:
            pass


def _read_records(path: str) -> List[bytes]:
    out = []
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            n, crc = struct.unpack("<II", hdr)
            payload = fh.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                break   # torn tail write: drop it and everything after
            out.append(payload)
    return out


def _valid_length(path: str) -> int:
    """Byte offset just past the last CRC-valid record."""
    end = 0
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            n, crc = struct.unpack("<II", hdr)
            payload = fh.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                break
            end += 8 + n
    return end


def load_journal(path: str, intervals, model_path: str,
                 inputs: Sequence[str] = (), setting: Sequence[str] = ()
                 ) -> Optional[Tuple[Dict[int, int], List[tuple]]]:
    """Replay a journal. Returns (interval totals, tagged data records)
    or None when absent / unreadable / written for different intervals,
    model, input files (the fingerprint covers BAM/FASTA identity) or
    setting (`run_setting`)."""
    if not os.path.isfile(path):
        return None
    raws = _read_records(path)
    want = ResumeJournal.MAGIC + _fingerprint(intervals, model_path, inputs,
                                              setting)
    if not raws or raws[0] != want:
        return None
    totals: Dict[int, int] = {}
    records: List[tuple] = []
    for raw in raws[1:]:
        try:
            rec = _decode_record(raw)
        except Exception:
            break
        if rec[0] == "total":
            totals[rec[1]] = rec[2]
        else:
            records.append(rec)   # full tagged tuple
    return totals, records


def compact_journal(path: str, intervals, model_path: str,
                    inputs: Sequence[str], completed: Dict[int, int],
                    records: List[tuple], setting: Sequence[str] = ()
                    ) -> None:
    """Atomically rewrite the journal to hold ONLY the completed
    intervals' totals + their (already replay-filtered) batch rows.

    Called on resume BEFORE the new run appends anything. Incomplete
    intervals' stale partial rows are dropped here; without this a
    second crash would leave old + new partial rows for the same
    interval jointly exceeding its total — falsely "complete", emitting
    duplicated rows and silently losing never-flushed ones."""
    tmp = path + ".compact"
    fh = open(tmp, "wb")

    def raw(payload: bytes) -> None:
        fh.write(struct.pack("<II", len(payload), zlib.crc32(payload)))
        fh.write(payload)

    raw(ResumeJournal.MAGIC + _fingerprint(intervals, model_path, inputs,
                                           setting))
    for idx in sorted(completed):
        raw(_encode_record(("total", idx, completed[idx])))
    for rec in records:   # full tagged tuples ("batch", ...) / ("pseq", ...)
        raw(_encode_record(rec))
    fh.flush()
    os.fsync(fh.fileno())   # the replace must never expose an empty file
    fh.close()
    os.replace(tmp, path)


def completed_intervals(totals: Dict[int, int],
                        records: List[tuple]) -> Dict[int, int]:
    """Interval idx -> total rows, for intervals whose every row reached
    a flushed batch (safe to skip re-encoding). Variant layout: counts
    come from each batch record's interval runs."""
    flushed: Dict[int, int] = {}
    for rec in records:
        if rec[0] != "batch":
            continue
        for idx, k in rec[7]:
            flushed[idx] = flushed.get(idx, 0) + k
    return {idx: n for idx, n in totals.items()
            if flushed.get(idx, 0) >= n}


def completed_polish_intervals(totals: Dict[int, int],
                               records: List[tuple]) -> Dict[int, int]:
    """Polish layout: one "pseq" record per flushed consensus sequence;
    an interval is complete when all its sequences reached the journal."""
    flushed: Dict[int, int] = {}
    for rec in records:
        if rec[0] == "pseq":
            flushed[rec[1]] = flushed.get(rec[1], 0) + 1
    return {idx: n for idx, n in totals.items()
            if flushed.get(idx, 0) >= n}


def replay_slices(records: List[tuple], completed: Dict[int, int]):
    """Yield (contigs, positions, depths, cand_lists, freqs, probs, runs)
    restricted to completed intervals, in original flush order (so
    within-interval candidate order — and therefore the final VCF — is
    byte-identical to an uninterrupted run)."""
    for rec in records:
        if rec[0] != "batch":
            continue
        _, contigs, positions, depths, cand_lists, freqs, probs, runs = rec
        lo = 0
        keep = []
        keep_runs = []
        for idx, k in runs:
            if idx in completed:
                keep.append((lo, lo + k))
                keep_runs.append((idx, k))
            lo += k
        if not keep:
            continue
        sel = np.concatenate([np.arange(a, b) for a, b in keep])
        yield ([contigs[i] for i in sel], np.asarray(positions)[sel],
               np.asarray(depths)[sel], [cand_lists[i] for i in sel],
               np.asarray(freqs)[sel], np.asarray(probs)[sel], keep_runs)
