"""Read -> flat event-array decomposition for the region encoder.

The reference encoder (region_summary.cpp:337-566) walks each read's CIGAR
and mutates a count matrix in place. We split that walk into two phases so
the accumulation can run as one dense scatter-add on the TPU:

  phase 1 (host, this module): per-read CIGAR walk emitting flat numpy
    event arrays (matrix events, coverage events, site-type counts) plus
    host-side allele-string observations;
  phase 2 (pepper_tpu/encode/region_encoder.py | jax_encoder.py): a single
    vectorized scatter-add builds the [L+1, 26] matrix from the events.

Semantics are bit-for-bit the reference's, including its quirks:
  - counts accumulate NEGATIVE (matrix[i][col] -= 1)
  - the match base that anchors an IN/DEL skips the REFF/REFR decrement
    but still counts toward coverage (region_summary.cpp:381-391)
  - insert coverage is only added when the anchor base failed the SNP
    base-quality gate but the insert passes the indel gate (:453)
  - deletes have no base-quality gate; the anchor 'D' decrement happens
    regardless of the <=61 candidate-length gate (:497)
"""
from dataclasses import dataclass, field
from itertools import repeat as _repeat
from typing import Dict, List, Tuple

import numpy as np

from pepper_tpu_torch.io.bam_reader import TrimmedRead
from pepper_tpu_torch.io.sam import OP_M, OP_EQ, OP_X, OP_I, OP_D, OP_N, OP_S, OP_P
from pepper_tpu_torch.options import AlleleType

_MATCH_OPS = (OP_M, OP_EQ, OP_X)
_SNP_CAND = ["1" + chr(b) for b in range(256)]  # "1"+base lookup by byte

# feature-column math (region_summary.cpp:201-230): for a valid ref base,
# fwd columns start at 7+1, rev at 18+1, order A C G T I D other.
_BASE_OFFSET = {ord("A"): 1, ord("C"): 2, ord("G"): 3, ord("T"): 4}
_INS_OFFSET = 5
_DEL_OFFSET = 6
_STAR_OFFSET = 7
_FWD_START = 7
_REV_START = 18

REF_VALUE = {ord("A"): 1, ord("C"): 2, ord("G"): 3, ord("T"): 4}  # else 5


def ref_feature_value(base: str) -> int:
    """region_summary.cpp:165-172."""
    return REF_VALUE.get(ord(base.upper()), 5)


def feature_index(ref_base: str, base: str, is_reverse: bool) -> int:
    """region_summary.cpp:201-230; -1 when the ref base is not ACGT."""
    if ref_base.upper() not in "ACGT":
        return -1
    start = _REV_START if is_reverse else _FWD_START
    b = base.upper()
    if b == "I":
        return start + _INS_OFFSET
    if b == "D":
        return start + _DEL_OFFSET
    return start + _BASE_OFFSET.get(ord(b), _STAR_OFFSET)


@dataclass
class RegionEvents:
    """Flat event arrays for one region (concatenated over reads)."""
    # scatter-add targets: matrix[row, col] -= 1 for each event
    matrix_rows: np.ndarray
    matrix_cols: np.ndarray
    # coverage[i] += 1 for each event
    coverage_idx: np.ndarray
    # site counters
    snp_idx: np.ndarray
    insert_idx: np.ndarray
    delete_idx: np.ndarray
    # host-side allele observations: (region_index, candidate_string, is_reverse)
    alleles: List[Tuple[int, str, bool]]


class _EventBuffer:
    def __init__(self):
        self.matrix_rows: List[np.ndarray] = []
        self.matrix_cols: List[np.ndarray] = []
        self.coverage: List[np.ndarray] = []
        self.snp: List[np.ndarray] = []
        self.insert: List[np.ndarray] = []
        self.delete: List[np.ndarray] = []
        self.alleles: List[Tuple[int, str, bool]] = []

    def finish(self) -> RegionEvents:
        def cat(parts):
            # every part is created int32; copy=False makes this a no-op
            # cast (large-array astype copies are pathologically slow here)
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dtype=np.int32)).astype(np.int32,
                                                             copy=False)
        return RegionEvents(
            matrix_rows=cat(self.matrix_rows), matrix_cols=cat(self.matrix_cols),
            coverage_idx=cat(self.coverage), snp_idx=cat(self.snp),
            insert_idx=cat(self.insert), delete_idx=cat(self.delete),
            alleles=self.alleles)


def _seq_codes(seq: str) -> np.ndarray:
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def read_events(buf: "_EventBuffer", read: TrimmedRead, ref_codes: np.ndarray,
                ref_start: int, ref_end: int,
                min_snp_baseq: float, min_indel_baseq: float) -> None:
    """Emit the reference encoder's updates for one read into `buf`.

    Mirrors region_summary.cpp:337-566 exactly (see module docstring).
    ref_codes: uint8 codes of the region reference sequence.
    """
    seq = _seq_codes(read.sequence)
    quals = np.asarray(read.base_qualities, dtype=np.int32)
    is_rev = read.is_reverse
    start_col = _REV_START if is_rev else _FWD_START
    ref_col = 15 if is_rev else 4  # REFR / REFF

    ref_valid = np.isin(ref_codes, (65, 67, 71, 84))  # A C G T

    read_index = 0
    ref_position = read.pos
    cigars = read.cigar_tuples
    n_ops = len(cigars)

    for ci, (op, length) in enumerate(cigars):
        if ref_position > ref_end:
            break
        if op in _MATCH_OPS:
            skip = 0
            if ref_position < ref_start:
                skip = min(ref_start - ref_position, length)
                read_index += skip
                ref_position += skip
            n = length - skip
            if n <= 0:
                continue
            # clip to region (per-base gate ref_position <= ref_end)
            n_in = min(n, ref_end - ref_position + 1)
            if n_in > 0:
                rpos = np.arange(ref_position, ref_position + n_in, dtype=np.int64)
                ridx = (rpos - ref_start).astype(np.int32)
                bases = seq[read_index:read_index + n_in]
                q = quals[read_index:read_index + n_in]
                qual_ok = q >= min_snp_baseq
                rbases = ref_codes[ridx]

                # coverage for every qual-passing base
                buf.coverage.append(ridx[qual_ok])

                # REFF/REFR decrement — skipped for the base anchoring IN/DEL:
                # only the op's last base, when a next op exists and is IN/DEL,
                # and only when that base is the op's last (i == length-1).
                ref_mask = qual_ok.copy()
                anchors_indel = (
                    n_in == n  # the op's true last base is inside the region
                    and ci != n_ops - 1
                    and cigars[ci + 1][0] in (OP_I, OP_D))
                if anchors_indel and ref_mask.shape[0] > 0:
                    ref_mask[-1] = False
                buf.matrix_rows.append(ridx[ref_mask])
                buf.matrix_cols.append(np.full(int(ref_mask.sum()), ref_col, np.int32))

                # per-base feature column (only when ref base valid)
                offs = np.full(n_in, _STAR_OFFSET, dtype=np.int32)
                offs[bases == 65] = 1
                offs[bases == 67] = 2
                offs[bases == 71] = 3
                offs[bases == 84] = 4
                offs[bases == 68] = 6   # a 'D' base: feature_index's column
                cols = start_col + offs
                feat_mask = qual_ok & ref_valid[ridx]
                buf.matrix_rows.append(ridx[feat_mask])
                buf.matrix_cols.append(cols[feat_mask])

                # SNP observations: mismatches passing qual
                mm = qual_ok & (bases != rbases)
                buf.snp.append(ridx[mm])
                if mm.any():
                    mi = np.flatnonzero(mm)
                    buf.alleles.extend(zip(
                        ridx[mi].tolist(),
                        (_SNP_CAND[b] for b in bases[mi].tolist()),
                        _repeat(is_rev)))
            read_index += n
            ref_position += n
        elif op == OP_I:
            anchor = ref_position - 1
            if ref_start <= anchor <= ref_end and read_index - 1 >= 0:
                aidx = anchor - ref_start
                alt = read.sequence[read_index - 1:read_index + length]
                alen = length + 1
                start_index = read_index - 1
                qsum = float(quals[start_index:start_index + alen].sum())
                if (qsum >= min_indel_baseq * alen
                        and quals[start_index] < min_snp_baseq):
                    buf.coverage.append(np.array([aidx], dtype=np.int32))
                cand = chr(AlleleType.INSERT + ord("0")) + alt
                if len(cand) <= 61 and qsum >= min_indel_baseq * alen:
                    if ref_valid[aidx]:
                        buf.matrix_rows.append(np.array([aidx], np.int32))
                        buf.matrix_cols.append(
                            np.array([start_col + _INS_OFFSET], np.int32))
                    buf.insert.append(np.array([aidx], dtype=np.int32))
                    buf.alleles.append((aidx, cand, is_rev))
            read_index += length
        elif op == OP_D:
            anchor = ref_position - 1
            if ref_start <= anchor <= ref_end:
                aidx = anchor - ref_start
                if ref_valid[aidx]:
                    buf.matrix_rows.append(np.array([aidx], np.int32))
                    buf.matrix_cols.append(
                        np.array([start_col + _DEL_OFFSET], np.int32))
                # reference substr clamps at the region's end, and the length
                # gate applies to the CLAMPED string (region_summary.cpp:513)
                ref_str = bytes(ref_codes[aidx:aidx + length + 1]).decode()
                cand = chr(AlleleType.DELETE + ord("0")) + ref_str
                if len(cand) <= 61:
                    buf.delete.append(np.array([aidx], dtype=np.int32))
                    buf.alleles.append((aidx, cand, is_rev))
            # '*' decrement for each deleted base inside the region
            lo = max(ref_position, ref_start)
            hi = min(ref_position + length - 1, ref_end)
            if hi >= lo:
                didx = np.arange(lo - ref_start, hi - ref_start + 1, dtype=np.int32)
                dmask = ref_valid[didx]
                buf.matrix_rows.append(didx[dmask])
                buf.matrix_cols.append(
                    np.full(int(dmask.sum()), start_col + _STAR_OFFSET, np.int32))
            ref_position += length
        elif op in (OP_N, OP_P):
            # reference quirk: REF_SKIP/PAD fall through to SOFT_CLIP in the
            # switch (region_summary.cpp:556-561) advancing BOTH indices
            ref_position += length
            read_index += length
        elif op == OP_S:
            read_index += length
        # OP_H: nothing


def collect_region_events(reads, ref_seq: str, ref_start: int, ref_end: int,
                          min_snp_baseq: float, min_indel_baseq: float) -> RegionEvents:
    """Phase-1 walk over all reads with mapping_quality > 0
    (region_summary.cpp:617-623)."""
    ref_codes = _seq_codes(ref_seq)
    buf = _EventBuffer()
    for read in reads:
        if read.mapping_quality > 0:
            read_events(buf, read, ref_codes, ref_start, ref_end,
                        min_snp_baseq, min_indel_baseq)
    return buf.finish()
