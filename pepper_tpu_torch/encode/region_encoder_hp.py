"""PEPPER-HP region encoder — 48-feature dual-haplotype candidate windows.

Parity: pepper_variant/modules/cpp/region_summary_hp.cpp. Differences from
the base encoder (region_encoder.py), preserved deliberately:
  - 48 columns: col 0 = reference base value; HP1 blocks REFF=4/REFR=15,
    counts fwd 8-14 / rev 19-25; HP2 blocks REFF2=26/REFR2=37, counts fwd
    30-36 / rev 41-47 (region_summary_hp.h:23-70). Reads route by hp_tag
    (0 -> both blocks, 1 -> HP1, 2 -> HP2, :395-415).
  - counts accumulate POSITIVE for insert/delete/gap columns; the match
    base column is DECREMENTED only for bases matching the reference
    (mismatches write no per-base column, :454-460).
  - the REFF/REFR decrement has NO indel-anchor skip (:393-401).
  - insert quality gate sums the INSERT bases only (len = cigar length, no
    anchor base, :500-506); failing inserts whose anchor passed the SNP
    gate DECREMENT coverage (:510).
  - clamp [-125,125] applies to ALL 48 columns (:765-770).
  - candidate window is 21x48 (CANDIDATE_WINDOW_SIZE=20); the midpoint
    re-encoding writes per-haplotype supports with NO sign flips
    (:964-1006).
`generate_summary` also keeps the clamped full-region matrix [L,48] as
`self.matrix` for the legacy chunked-HP chain (pipelines/hp_legacy.py);
otherwise this is the JAX package's module with its imports rewritten.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.region_encoder import (CandidateImage, TruthRecord,
                                              _truth_candidate_string,
                                              get_label_index,
                                              get_variant_type_label_index)
from pepper_tpu_torch.io.sam import OP_M, OP_EQ, OP_X, OP_I, OP_D, OP_N, OP_S, OP_P
from pepper_tpu_torch.options import AlleleType, ImageOptionsHP, VariantTypes

MAXV, MINV = 125, -125
_MATCH = (OP_M, OP_EQ, OP_X)


def _feature_index_hp(ref_base: str, base: str, is_reverse: bool,
                      hp_block: int) -> int:
    """region_summary_hp.cpp:191-243; hp_block is 1 or 2."""
    if ref_base.upper() not in "ACGT":
        return -1
    if hp_block == 1:
        start = 18 if is_reverse else 7
    else:
        start = 40 if is_reverse else 29
    b = base.upper()
    offs = {"A": 1, "C": 2, "G": 3, "T": 4, "I": 5, "D": 6}
    return start + offs.get(b, 7)


def _hp_blocks(hp_tag: int) -> Tuple[int, ...]:
    if hp_tag == 1:
        return (1,)
    if hp_tag == 2:
        return (2,)
    return (1, 2)


def _ref_value(base: str) -> int:
    return {"A": 1, "C": 2, "G": 3, "T": 4}.get(base.upper(), 5)


class RegionalSummaryHP:
    """Parity: RegionalSummaryGeneratorHP (live path, no insert expansion)."""

    def __init__(self, contig: str, ref_start: int, ref_end: int, ref_seq: str):
        self.contig = contig
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.ref_seq = ref_seq
        self.L = ref_end - ref_start + 1
        self._labels_hp = None
        self._types_hp = None
        self._truth_alleles = None
        self.labels = np.zeros(self.L + 1, dtype=np.uint16)
        self.labels_variant_type = np.zeros(self.L + 1, dtype=np.uint16)

    def generate_labels(self, hap1: Sequence[TruthRecord],
                        hap2: Sequence[TruthRecord]) -> None:
        """region_summary_hp.cpp:247-352 — same shape as the base encoder."""
        size = self.L + 1
        labels_hp = [np.full(size, ord("*"), np.uint8),
                     np.full(size, ord("*"), np.uint8)]
        types_hp = [np.zeros(size, np.int32), np.zeros(size, np.int32)]
        truth_alleles = [[[] for _ in range(size)], [[] for _ in range(size)]]
        for hap_labels in labels_hp:
            hap_labels[: self.L] = ord("R")
        for h, records in enumerate((hap1, hap2)):
            for rec in records:
                idx = rec.pos_start - self.ref_start
                if len(rec.ref) > len(rec.alt):
                    if 0 <= idx < self.L:
                        types_hp[h][idx] = VariantTypes.DELETE
                        labels_hp[h][idx] = ord("#")
                        truth_alleles[h][idx].append(rec)
                elif len(rec.ref) < len(rec.alt):
                    if 0 <= idx < self.L:
                        types_hp[h][idx] = VariantTypes.INSERT
                        labels_hp[h][idx] = ord("*")
                        truth_alleles[h][idx].append(rec)
                else:
                    if 0 <= idx < self.L:
                        types_hp[h][idx] = VariantTypes.SNP
                        truth_alleles[h][idx].append(rec)
                    for pos in range(rec.pos_start, rec.pos_end):
                        if self.ref_start <= pos <= self.ref_end:
                            i = pos - self.ref_start
                            alt_base = rec.alt[pos - rec.pos_start]
                            labels_hp[h][i] = (ord("R")
                                               if self.ref_seq[i] == alt_base
                                               else ord(alt_base))
        self._labels_hp = labels_hp
        self._types_hp = types_hp
        self._truth_alleles = truth_alleles

    def generate_summary(self, reads, min_snp_baseq: float,
                         min_indel_baseq: float, snp_freq_threshold: float,
                         insert_freq_threshold: float,
                         delete_freq_threshold: float,
                         min_coverage_threshold: float,
                         snp_candidate_freq_threshold: float,
                         indel_candidate_freq_threshold: float,
                         candidate_support_threshold: float,
                         skip_indels: bool, candidate_region_start: int,
                         candidate_region_end: int,
                         candidate_window_size: int =
                         ImageOptionsHP.CANDIDATE_WINDOW_SIZE,
                         feature_size: int = ImageOptionsHP.IMAGE_HEIGHT,
                         train_mode: bool = False) -> List[CandidateImage]:
        """Parity: region_summary_hp.cpp:664-1010."""
        L = self.L
        rs, re_ = self.ref_start, self.ref_end
        matrix = np.zeros((L + 1, feature_size), dtype=np.int64)
        for i in range(L):
            matrix[i, 0] = _ref_value(self.ref_seq[i])
        coverage = np.zeros(L, np.int64)
        snp_count = np.zeros(L, np.int64)
        insert_count = np.zeros(L, np.int64)
        delete_count = np.zeros(L, np.int64)
        # idx -> {cand: [total, fwd1, fwd2, rev1, rev2]}
        freq: Dict[int, Dict[str, List[int]]] = {}

        def add_allele(idx, cand, rev, hp_tag):
            site = freq.setdefault(idx, {})
            e = site.setdefault(cand, [0, 0, 0, 0, 0])
            e[0] += 1
            for b in _hp_blocks(hp_tag):
                e[(2 + b) if rev else b] += 1

        for read in reads:
            if read.mapping_quality <= 0:
                continue
            rev = read.is_reverse
            blocks = _hp_blocks(read.hp_tag)
            read_index = 0
            ref_position = read.pos
            cigars = read.cigar_tuples
            for op, length in cigars:
                if ref_position > re_:
                    break
                if op in _MATCH:
                    start_i = 0
                    if ref_position < rs:
                        start_i = min(rs - ref_position, length)
                        read_index += start_i
                        ref_position += start_i
                    for _ in range(start_i, length):
                        if rs <= ref_position <= re_:
                            idx = ref_position - rs
                            base = read.sequence[read_index]
                            rbase = self.ref_seq[idx]
                            bq = read.base_qualities[read_index]
                            if bq >= min_snp_baseq:
                                coverage[idx] += 1
                                for b in blocks:
                                    if b == 1:
                                        matrix[idx, 15 if rev else 4] -= 1
                                    else:
                                        matrix[idx, 37 if rev else 26] -= 1
                                if rbase != base:
                                    snp_count[idx] += 1
                                    add_allele(idx, "1" + base, rev,
                                               read.hp_tag)
                                else:
                                    for b in blocks:
                                        fi = _feature_index_hp(rbase, base,
                                                               rev, b)
                                        if fi >= 0:
                                            matrix[idx, fi] -= 1
                        read_index += 1
                        ref_position += 1
                elif op == OP_I:
                    anchor = ref_position - 1
                    if rs <= anchor <= re_ and read_index - 1 >= 0:
                        aidx = anchor - rs
                        alt = read.sequence[read_index - 1:
                                            read_index + length]
                        qsum = float(sum(
                            read.base_qualities[read_index:
                                                read_index + length]))
                        if (qsum < min_indel_baseq * length
                                and read.base_qualities[read_index - 1]
                                >= min_snp_baseq):
                            coverage[aidx] -= 1
                        cand = "2" + alt
                        if (len(cand) <= 61
                                and qsum >= min_indel_baseq * length):
                            for b in blocks:
                                fi = _feature_index_hp(self.ref_seq[aidx],
                                                       "I", rev, b)
                                if fi >= 0:
                                    matrix[aidx, fi] += 1
                            insert_count[aidx] += 1
                            add_allele(aidx, cand, rev, read.hp_tag)
                    read_index += length
                elif op == OP_D:
                    anchor = ref_position - 1
                    if rs <= anchor <= re_:
                        aidx = anchor - rs
                        for b in blocks:
                            fi = _feature_index_hp(self.ref_seq[aidx], "D",
                                                   rev, b)
                            if fi >= 0:
                                matrix[aidx, fi] += 1
                        ref_str = self.ref_seq[aidx: aidx + length + 1]
                        cand = "3" + ref_str
                        if len(cand) <= 61:
                            delete_count[aidx] += 1
                            add_allele(aidx, cand, rev, read.hp_tag)
                    for p in range(max(ref_position, rs),
                                   min(ref_position + length - 1, re_) + 1):
                        idx = p - rs
                        for b in blocks:
                            fi = _feature_index_hp(self.ref_seq[idx], "*",
                                                   rev, b)
                            if fi >= 0:
                                matrix[idx, fi] += 1
                    ref_position += length
                elif op in (OP_N, OP_P):
                    ref_position += length
                    read_index += length
                elif op == OP_S:
                    read_index += length

        # site thresholds + clamp ALL columns
        cov = np.maximum(1.0, coverage.astype(np.float64))
        snp_pass = snp_count / cov >= snp_freq_threshold
        ins_pass = insert_count / cov >= insert_freq_threshold
        del_pass = delete_count / cov >= delete_freq_threshold
        positions = np.arange(rs, re_ + 1)
        in_region = ((positions >= candidate_region_start)
                     & (positions <= candidate_region_end)
                     & (coverage >= min_coverage_threshold))
        selected = (snp_pass | ins_pass | del_pass) & in_region
        snp_pass &= selected
        ins_pass &= selected
        del_pass &= selected
        np.clip(matrix[:L], MINV, MAXV, out=matrix[:L])
        # the full-region matrix, which the legacy chunked-HP chain chunks
        # (pipelines/hp_legacy.py::make_chunked_hp_images)
        self.matrix = matrix[:L]

        if train_mode and self._labels_hp is not None:
            for i in range(L + 1):
                self.labels[i] = get_label_index(
                    chr(self._labels_hp[0][i]), chr(self._labels_hp[1][i]))
                self.labels_variant_type[i] = get_variant_type_label_index(
                    int(self._types_hp[0][i]), int(self._types_hp[1][i]))

        out: List[CandidateImage] = []
        half = candidate_window_size // 2
        win = candidate_window_size + 1
        for idx in np.flatnonzero(selected):
            idx = int(idx)
            pos = rs + idx
            depth = min(int(coverage[idx]), MAXV)
            for cand in sorted(freq.get(idx, {})):
                total, f1, f2, r1, r2 = freq[idx][cand]
                cfreq = total / max(1.0, float(depth))
                ctype = cand[0]
                if total < candidate_support_threshold:
                    continue
                if ctype != "1" and cfreq < indel_candidate_freq_threshold:
                    continue
                if ctype == "1" and cfreq < snp_candidate_freq_threshold:
                    continue
                if ctype != "1" and skip_indels:
                    continue
                if ((ctype == "1" and not snp_pass[idx])
                        or (ctype == "2" and not ins_pass[idx])
                        or (ctype == "3" and not del_pass[idx])):
                    continue

                base_label, type_label = 0, 0
                if train_mode and self._truth_alleles is not None:
                    found = [False, False]
                    for h in range(2):
                        for rec in self._truth_alleles[h][idx]:
                            if _truth_candidate_string(rec) == cand:
                                found[h] = True
                    type_label = (2 if all(found)
                                  else (1 if any(found) else 0))
                    base_label = int(self.labels[idx])

                image = np.zeros((win, feature_size), dtype=np.int32)
                lo = idx - half
                src_lo = max(lo, 0)
                src_hi = min(idx + half, L) + 1
                if src_hi > src_lo:
                    image[src_lo - lo: src_hi - lo] = matrix[src_lo:src_hi]

                mid = half
                c = [min(v, MAXV) for v in (f1, f2, r1, r2)]
                if ctype == "1":
                    image[mid, 1] = _ref_value(cand[1])
                    image[mid, 5], image[mid, 27] = c[0], c[1]
                    image[mid, 16], image[mid, 38] = c[2], c[3]
                elif ctype == "2":
                    image[mid, 2] = min(len(cand) - 1, MAXV)
                    image[mid, 6], image[mid, 28] = c[0], c[1]
                    image[mid, 17], image[mid, 39] = c[2], c[3]
                else:
                    image[mid, 3] = min(len(cand) - 1, MAXV)
                    image[mid, 7], image[mid, 29] = c[0], c[1]
                    image[mid, 18], image[mid, 40] = c[2], c[3]

                out.append(CandidateImage(
                    contig=self.contig, position=pos, depth=depth,
                    candidates=[cand],
                    candidate_frequency=[min(total, MAXV)],
                    image=image, base_label=base_label,
                    type_label=type_label))
        return out
