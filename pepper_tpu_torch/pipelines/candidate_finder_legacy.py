"""Legacy pileup-driven candidate finders (dormant in the reference r0.8).

Functional equivalents of the reference's C++ `CandidateFinder` /
`CandidateFinderHP` (pepper_variant/modules/cpp/candidate_finder.cpp:10-756,
candidate_finder_hp.cpp) and their Python wrapper
(pepper_variant/modules/python/CandidateFinderCPP.py:6-94). These are
API-parity components: the r0.8 main path uses the live Python candidate
finder (our pipelines/find_candidates.py); this pair backs the older
prediction-map workflow and the HP re-genotyping experiments.

Kept in Python deliberately — there are no callers on the throughput path, so
parity and auditability beat native speed here. Reference quirks preserved:

- `find_candidates` (non-HP): the insert-expansion machinery is disabled in
  the reference (candidate_finder.cpp:378-388 commented out), so cumulative
  insert offsets are all zero; only the SNP branch assigns probabilities
  (candidate_finder.cpp:475-502); the per-candidate frequency gate is
  commented out (candidate_finder.cpp:462), so every observed allele marks
  its site as candidate_found.
- the consensus site scan iterates pos_index over [0, region_end -
  region_start) — the final position is never scanned
  (candidate_finder.cpp:329-341).
- `alt_freq` is truncated to int before the >= freq_threshold compare
  (candidate_finder_hp.cpp / candidate_finder.cpp:458).
- HP DELETE scoring: two consecutive `if` blocks share the same
  inside-the-deletion condition (both run), and the `else` of the second
  covers positions at/after the allele end (candidate_finder_hp.cpp).
- `Candidate.pos` is published as `pos_start` (pybind_api.h:257).

The port's copy of pepper_tpu/pipelines/candidate_finder_legacy.py, with its
imports rewritten to pepper_tpu_torch.*.
"""
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from pepper_tpu_torch.io.bam_reader import TrimmedRead
from pepper_tpu_torch.io.sam import (OP_D, OP_EQ, OP_H, OP_I, OP_M, OP_N, OP_P,
                               OP_S, OP_X)

_MATCH_OPS = (OP_M, OP_EQ, OP_X)

# AlleleType (candidate_finder.h:23-27)
SNP_ALLELE = 1
INSERT_ALLELE = 2
DELETE_ALLELE = 3

# 28-class base-pair label decode (candidate_finder.cpp:361)
DECODED_BASE_LABELS = [
    "RR", "RA", "RC", "RT", "RG", "R*", "R#", "AA", "AC", "AT", "AG", "A*",
    "A#", "CC", "CT", "CG", "C*", "C#", "TT", "TG", "T*", "T#", "GG", "G*",
    "G#", "**", "*#", "##"]


class CandidateFinderLegacyOptions:
    """CandidateFinder_options (candidate_finder.h:15-21)."""
    MIN_MAPPING_QUALITY = 1
    MIN_BASE_QUALITY = 0
    FREQ_THRESHOLD = 4
    MIN_COUNT_THRESHOLD = 2
    REPORT_INDELS = True


class ONTLinearRegression:
    """HP logistic gate coefficients (candidate_finder_hp.h:23-47)."""
    SNP_NON_REF_PROB_COEF = -0.002397
    SNP_ALLELE_WEIGHT_COEF = 1.008378
    SNP_BIAS_TERM = 0.001291
    SNP_THRESHOLD = 0.01
    SNP_LOWER_FREQ_THRESHOLD = 0.10

    INSERT_NON_REF_PROB_COEF = 0.239488
    INSERT_ALLELE_WEIGHT_COEF = 0.822283
    INSERT_BIAS_TERM = 0.000298
    INSERT_THRESHOLD = 0.2
    IN_LOWER_FREQ_THRESHOLD = 0.10

    DELETE_NON_REF_PROB_COEF = 0.039434
    DELETE_ALLELE_WEIGHT_COEF = 0.765909
    DELETE_BIAS_TERM = -0.003304
    DELETE_THRESHOLD = 0.15
    DEL_LOWER_FREQ_THRESHOLD = 0.10


@dataclass(frozen=True)
class LegacyAllele:
    ref: str
    alt: str
    alt_type: int


@dataclass
class LegacyCandidate:
    """Candidate struct (candidate_finder.h:78+, pybind_api.h:253-268)."""
    pos: int
    pos_end: int
    allele: LegacyAllele
    depth: int = 0
    read_support: int = 0
    allele_probability: float = 0.0
    genotype_probability: float = 0.0
    alt_prob: float = 0.0
    alt_prob_h1: float = 0.0
    alt_prob_h2: float = 0.0
    non_ref_prob: float = 0.0
    genotype: int = 0

    @property
    def pos_start(self) -> int:
        return self.pos

    def _key(self) -> Tuple:
        return (self.pos, self.pos_end, self.allele.ref, self.allele.alt,
                self.allele.alt_type)

    def set_depth_values(self, depth: int, read_support: int) -> None:
        self.depth = depth
        self.read_support = read_support


@dataclass
class LegacyPositionalRecord:
    """PositionalCandidateRecord (pybind_api.h:270-277)."""
    chromosome_name: str = ""
    pos_start: int = 0
    pos_end: int = 0
    candidates: List[LegacyCandidate] = field(default_factory=list)

    def _sort_key(self):
        return (self.chromosome_name, self.pos_start, self.pos_end)


def get_index_from_base(base: str) -> int:
    """candidate_finder.cpp:160-172."""
    return {"*": 0, "A": 1, "C": 2, "G": 3, "T": 4}.get(base, -1)


def get_index_from_type(kind: str) -> int:
    """candidate_finder.cpp:174-184."""
    return {"R": 0, "S": 1, "I": 2, "D": 3}.get(kind, -1)


def get_genotype(type_predicted: str) -> int:
    """candidate_finder.cpp:186-195."""
    if "R" in type_predicted[:2]:
        return 0 if type_predicted[0] == type_predicted[1] else 1
    return 2 if type_predicted[0] == type_predicted[1] else 1


def get_genotype_from_base(ref_base: str, pred1: str, pred2: str) -> int:
    """candidate_finder.cpp:197-213."""
    if pred1 == "R":
        pred1 = ref_base
    if pred2 == "R":
        pred2 = ref_base
    if ref_base == pred1 or ref_base == pred2:
        return 0 if pred1 == pred2 else 1
    return 2 if pred1 == pred2 else 1


class _AlleleCollector:
    """Shared CIGAR-walk allele collection (candidate_finder.cpp:25-158 ==
    candidate_finder_hp.cpp add_read_alleles; they differ only in that the
    non-HP SNP anchor check is additionally gated on report_indels)."""

    def __init__(self, reference_sequence: str, chromosome_name: str,
                 region_start: int, region_end: int, ref_start: int,
                 ref_end: int):
        self.reference_sequence = reference_sequence
        self.chromosome_name = chromosome_name
        self.region_start = region_start
        self.region_end = region_end
        self.ref_start = ref_start
        self.ref_end = ref_end
        size = region_end - region_start + 1
        self.allele_map: List[Set[LegacyCandidate]] = [set()
                                                       for _ in range(size)]
        self.allele_frequency_map: Dict[Tuple, int] = defaultdict(int)
        self._canonical: Dict[Tuple, LegacyCandidate] = {}

    def _register(self, cand: LegacyCandidate, region_index: int) -> None:
        key = cand._key()
        self.allele_frequency_map[key] += 1
        self._canonical.setdefault(key, cand)
        self.allele_map[region_index].add(key)

    def add_read_alleles(self, read: TrimmedRead, coverage: List[int],
                         anchor_gated_on_report_indels: bool) -> None:
        opts = CandidateFinderLegacyOptions
        read_index = 0
        ref_position = read.pos
        seq = read.sequence
        quals = read.base_qualities
        ref = self.reference_sequence
        tuples = read.cigar_tuples
        for cigar_i, (op, length) in enumerate(tuples):
            if op in _MATCH_OPS:
                start_i = 0
                if ref_position < self.region_start:
                    start_i = min(self.region_start - ref_position, length)
                    read_index += start_i
                    ref_position += start_i
                for i in range(start_i, length):
                    reference_index = ref_position - self.ref_start
                    region_index = ref_position - self.region_start
                    in_region = (self.region_start <= ref_position
                                 <= self.region_end)
                    if (in_region
                            and ref[reference_index] != seq[read_index]
                            and quals[read_index] >= opts.MIN_BASE_QUALITY):
                        check_this_base = True
                        anchor_gate = (opts.REPORT_INDELS
                                       if anchor_gated_on_report_indels
                                       else True)
                        if (i == length - 1 and cigar_i + 1 < len(tuples)
                                and anchor_gate):
                            next_op = tuples[cigar_i + 1][0]
                            if next_op in (OP_I, OP_D):
                                coverage[region_index] += 1
                                check_this_base = False
                        if check_this_base:
                            cand = LegacyCandidate(
                                ref_position, ref_position + 1,
                                LegacyAllele(ref[reference_index],
                                             seq[read_index], SNP_ALLELE))
                            self._register(cand, region_index)
                            coverage[region_index] += 1
                    elif (ref_position <= self.region_end
                          and quals[read_index] >= opts.MIN_BASE_QUALITY):
                        coverage[region_index] += 1
                    read_index += 1
                    ref_position += 1
            elif op == OP_I:
                reference_index = ref_position - self.ref_start - 1
                region_index = ref_position - self.region_start - 1
                if (self.region_start <= ref_position - 1 <= self.region_end
                        and (opts.REPORT_INDELS
                             if anchor_gated_on_report_indels else True)):
                    ref_a = ref[reference_index:reference_index + 1]
                    if read_index - 1 >= 0:
                        alt = seq[read_index - 1:read_index + length]
                    else:
                        alt = ref_a + seq[read_index:read_index + length]
                    cand = LegacyCandidate(
                        ref_position - 1, ref_position,
                        LegacyAllele(ref_a, alt, INSERT_ALLELE))
                    self._register(cand, region_index)
                read_index += length
            elif op == OP_D:
                region_index = ref_position - self.region_start - 1
                if (self.region_start <= ref_position - 1 <= self.region_end
                        and ref_position + length < self.ref_end
                        and (opts.REPORT_INDELS
                             if anchor_gated_on_report_indels else True)):
                    rstart = ref_position - self.ref_start - 1
                    ref_a = ref[rstart:rstart + length + 1]
                    if read_index - 1 >= 0:
                        alt = seq[read_index - 1:read_index]
                    else:
                        alt = ref[rstart:rstart + 1]
                    cand = LegacyCandidate(
                        ref_position - 1, ref_position - 1 + length + 1,
                        LegacyAllele(ref_a, alt, DELETE_ALLELE))
                    self._register(cand, region_index)
                ref_position += length
            elif op == OP_S:
                read_index += length
            elif op in (OP_N, OP_P):
                ref_position += length
            elif op == OP_H:
                pass

    def alleles_at(self, region_index: int) -> List[LegacyCandidate]:
        return sorted((self._canonical[k]
                       for k in self.allele_map[region_index]),
                      key=lambda c: c._key())

    def support(self, cand: LegacyCandidate) -> int:
        return self.allele_frequency_map[cand._key()]


class LegacyCandidateFinder:
    """CandidateFinder (candidate_finder.cpp:10-343,353-756)."""

    def __init__(self, reference_sequence: str, chromosome_name: str,
                 region_start: int, region_end: int, ref_start: int,
                 ref_end: int):
        self._c = _AlleleCollector(reference_sequence, chromosome_name,
                                   region_start, region_end, ref_start,
                                   ref_end)

    # ---------------------------------------------------------- consensus
    def _add_read_alleles_consensus(self, read: TrimmedRead, coverage,
                                    insert_count, delete_count, snp_count):
        """candidate_finder.cpp:221-310 — counts only, no allele strings."""
        opts = CandidateFinderLegacyOptions
        c = self._c
        read_index = 0
        ref_position = read.pos
        seq, quals = read.sequence, read.base_qualities
        ref = c.reference_sequence
        tuples = read.cigar_tuples
        for cigar_i, (op, length) in enumerate(tuples):
            if op in _MATCH_OPS:
                start_i = 0
                if ref_position < c.region_start:
                    start_i = min(c.region_start - ref_position, length)
                    read_index += start_i
                    ref_position += start_i
                for i in range(start_i, length):
                    reference_index = ref_position - c.ref_start
                    region_index = ref_position - c.region_start
                    if (c.region_start <= ref_position <= c.region_end
                            and ref[reference_index] != seq[read_index]
                            and quals[read_index] >= opts.MIN_BASE_QUALITY):
                        check_this_base = True
                        if i == length - 1 and cigar_i + 1 < len(tuples):
                            if tuples[cigar_i + 1][0] in (OP_I, OP_D):
                                coverage[region_index] += 1
                                check_this_base = False
                        if check_this_base:
                            snp_count[region_index] += 1
                            coverage[region_index] += 1
                    elif (ref_position <= c.region_end
                          and quals[read_index] >= opts.MIN_BASE_QUALITY):
                        coverage[region_index] += 1
                    read_index += 1
                    ref_position += 1
            elif op == OP_I:
                # the reference counts unconditionally (candidate_finder.cpp
                # :275 — out-of-bounds UB when a read opens with an insert at
                # region_start); we bound-check instead of wrapping
                region_index = ref_position - c.region_start - 1
                if 0 <= region_index < len(insert_count):
                    insert_count[region_index] += 1
                read_index += length
            elif op == OP_D:
                region_index = ref_position - c.region_start - 1
                if c.region_start <= ref_position - 1 <= c.region_end:
                    delete_count[region_index] += 1
                ref_position += length
            elif op == OP_S:
                read_index += length
            elif op in (OP_N, OP_P):
                ref_position += length

    def find_candidates_consensus(self, reads: List[TrimmedRead],
                                  snp_freq_threshold: float,
                                  insert_freq_threshold: float,
                                  delete_freq_threshold: float
                                  ) -> List[int]:
        """candidate_finder.cpp:312-343. NOTE: scans [0, region_size) — the
        final region position is never tested (reference quirk)."""
        c = self._c
        size = c.region_end - c.region_start + 1
        coverage = [0] * size
        insert_count = [0] * size
        snp_count = [0] * size
        delete_count = [0] * size
        for read in reads:
            self._add_read_alleles_consensus(read, coverage, insert_count,
                                             delete_count, snp_count)
        positions = []
        for pos_index in range(c.region_end - c.region_start):
            if coverage[pos_index] == 0:
                continue
            cov = float(coverage[pos_index])
            if (snp_count[pos_index] / cov >= snp_freq_threshold
                    or insert_count[pos_index] / cov >= insert_freq_threshold
                    or delete_count[pos_index] / cov
                    >= delete_freq_threshold):
                positions.append(c.region_start + pos_index)
        return positions

    # ------------------------------------------------------- find_candidates
    def find_candidates(self, reads: List[TrimmedRead], positions: List[int],
                        predictions: List[List[float]],
                        base_labels: List[int], freq_based: bool = False,
                        freq: float = 0.0) -> List[LegacyPositionalRecord]:
        """candidate_finder.cpp:353-756 — only the SNP branch is live; the
        insert-offset machinery is disabled (all-zero cumulative inserts);
        no frequency gate (commented out in the reference)."""
        del freq_based, freq  # accepted for API parity; unused (see filter_
        # candidate, candidate_finder.cpp:215-218 — returns false always)
        c = self._c
        local_start, local_end = c.region_start, c.region_end
        local_size = local_end - local_start + 1

        pred_base_map = [0] * (local_size + 1)
        pred_values_map = [[0.0] * len(DECODED_BASE_LABELS)
                           for _ in range(local_size + 1)]
        for i, position in enumerate(positions):
            if position < 0:
                continue
            idx = position - local_start  # cumulative inserts are all zero
            pred_base_map[idx] = base_labels[i]
            pred_values_map[idx] = list(predictions[i])

        coverage = [0] * local_size
        for read in reads:
            c.add_read_alleles(read, coverage,
                               anchor_gated_on_report_indels=True)

        all_records = []
        for i in range(len(coverage)):
            allele_end = 1
            for cand in c.alleles_at(i):
                if cand.allele.alt_type == DELETE_ALLELE:
                    allele_end = max(allele_end, len(cand.allele.ref))
            record = LegacyPositionalRecord(
                chromosome_name=c.chromosome_name,
                pos_start=c.region_start + i,
                pos_end=c.region_start + i + allele_end)
            candidate_found = False
            for cand in c.alleles_at(i):
                if cand.pos > local_end or cand.pos < local_start:
                    continue
                candidate_found = True
                cand.set_depth_values(coverage[i], c.support(cand))
                if cand.allele.alt_type == SNP_ALLELE:
                    idx = cand.pos - local_start
                    base_label = pred_base_map[idx]
                    bases_predicted = DECODED_BASE_LABELS[base_label]
                    value = pred_values_map[idx][base_label]
                    genotype = get_genotype_from_base(
                        cand.allele.ref[0], bases_predicted[0],
                        bases_predicted[1])
                    if cand.allele.alt[0] in bases_predicted[:2]:
                        cand.allele_probability = value
                        cand.genotype_probability = value
                        cand.genotype = genotype
                        record.candidates.append(cand)
            if not candidate_found:
                continue
            all_records.append(record)
        return all_records


class LegacyCandidateFinderHP:
    """CandidateFinderHP (candidate_finder_hp.cpp) — merges per-haplotype
    5-class prediction maps into scored candidates, gated by the ONT
    logistic regression (candidate_finder_hp.h:23-47)."""

    def __init__(self, reference_sequence: str, chromosome_name: str,
                 region_start: int, region_end: int, ref_start: int,
                 ref_end: int):
        self._c = _AlleleCollector(reference_sequence, chromosome_name,
                                   region_start, region_end, ref_start,
                                   ref_end)

    @staticmethod
    def filter_candidate(cand: LegacyCandidate, freq_based: bool,
                         freq: float) -> bool:
        """candidate_finder_hp.cpp filter_candidate."""
        lr = ONTLinearRegression
        allele_frequency = cand.read_support / max(1.0, float(cand.depth))
        if freq_based:
            return allele_frequency >= freq
        weight = max(cand.alt_prob_h1, cand.alt_prob_h2)
        if cand.allele.alt_type == SNP_ALLELE:
            if allele_frequency < lr.SNP_LOWER_FREQ_THRESHOLD:
                return False
            val = (weight * lr.SNP_ALLELE_WEIGHT_COEF
                   + cand.non_ref_prob * lr.SNP_NON_REF_PROB_COEF
                   + lr.SNP_BIAS_TERM)
            return val >= lr.SNP_THRESHOLD
        if cand.allele.alt_type == INSERT_ALLELE:
            if allele_frequency < lr.IN_LOWER_FREQ_THRESHOLD:
                return False
            val = (weight * lr.INSERT_ALLELE_WEIGHT_COEF
                   + cand.non_ref_prob * lr.INSERT_NON_REF_PROB_COEF
                   + lr.INSERT_BIAS_TERM)
            return val >= lr.INSERT_THRESHOLD
        if cand.allele.alt_type == DELETE_ALLELE:
            if allele_frequency < lr.DEL_LOWER_FREQ_THRESHOLD:
                return False
            val = (weight * lr.DELETE_ALLELE_WEIGHT_COEF
                   + cand.non_ref_prob * lr.DELETE_NON_REF_PROB_COEF
                   + lr.DELETE_BIAS_TERM)
            return val >= lr.DELETE_THRESHOLD
        return False

    def find_candidates(self, reads: List[TrimmedRead], positions: List[int],
                        indices: List[int],
                        base_predictions_h1: List[List[int]],
                        base_predictions_h2: List[List[int]],
                        freq_based: bool = False, freq: float = 0.0
                        ) -> List[LegacyPositionalRecord]:
        c = self._c
        opts = CandidateFinderLegacyOptions

        local_start = local_end = positions[0]
        for position in positions:
            if position < 0:
                continue
            local_start = min(local_start, position)
            local_end = max(local_end, position)
        local_size = local_end - local_start + 1

        max_insert = [0] * (local_size + 1)
        for position, index in zip(positions, indices):
            if position < 0:
                continue
            off = position - local_start
            max_insert[off] = max(max_insert[off], index)
        cumulative = [0] * (local_size + 1)
        for i in range(1, local_size + 1):
            cumulative[i] = cumulative[i - 1] + max_insert[i - 1]
        total_inserts = sum(max_insert)

        n_slots = local_size + total_inserts + 1
        pred_h1 = [[0] * 5 for _ in range(n_slots)]
        pred_h2 = [[0] * 5 for _ in range(n_slots)]
        for i, (position, index) in enumerate(zip(positions, indices)):
            if position < 0:
                continue
            slot = position - local_start + cumulative[position
                                                       - local_start] + index
            pred_h1[slot] = list(base_predictions_h1[i])
            pred_h2[slot] = list(base_predictions_h2[i])

        def slot_of(position: int, index: int = 0) -> int:
            return (position - local_start
                    + cumulative[position - local_start] + index)

        coverage = [0] * (c.region_end - c.region_start + 1)
        for read in reads:
            c.add_read_alleles(read, coverage,
                               anchor_gated_on_report_indels=False)

        all_records = []
        for i in range(len(coverage)):
            allele_end = 1
            max_del_length = 0
            for cand in c.alleles_at(i):
                support = c.support(cand)
                freq_can = (100.0 * support / coverage[i]
                            if coverage[i] > 0 else 0.0)
                if (freq_can >= opts.FREQ_THRESHOLD
                        and support >= opts.MIN_COUNT_THRESHOLD
                        and cand.allele.alt_type == DELETE_ALLELE):
                    allele_end = max(allele_end, len(cand.allele.ref))
                    max_del_length = max(max_del_length,
                                         len(cand.allele.ref))
            record = LegacyPositionalRecord(
                chromosome_name=c.chromosome_name,
                pos_start=c.region_start + i,
                pos_end=c.region_start + i + allele_end)
            candidate_found = False
            for cand in c.alleles_at(i):
                if cand.pos > local_end or cand.pos < local_start:
                    continue
                alt_freq = int(100.0 * c.support(cand)
                               / max(1.0, float(coverage[i])))
                supported = c.support(cand)
                if (alt_freq < opts.FREQ_THRESHOLD
                        or supported < opts.MIN_COUNT_THRESHOLD):
                    continue
                candidate_found = True
                cand.set_depth_values(coverage[i], supported)

                if cand.allele.alt_type == SNP_ALLELE:
                    slot = slot_of(cand.pos)
                    alt_idx = get_index_from_base(cand.allele.alt[0])
                    s1 = max(1.0, float(sum(pred_h1[slot])))
                    s2 = max(1.0, float(sum(pred_h2[slot])))
                    prob_h1 = pred_h1[slot][alt_idx] / s1
                    prob_h2 = pred_h2[slot][alt_idx] / s2
                    non_ref = 0.0
                    for index in range(
                            max_insert[cand.pos - local_start] + 1):
                        ref_idx = (get_index_from_base(cand.allele.ref[0])
                                   if index == 0
                                   else get_index_from_base("*"))
                        slot_i = slot_of(cand.pos, index)
                        s1 = max(1.0, float(sum(pred_h1[slot_i])))
                        s2 = max(1.0, float(sum(pred_h2[slot_i])))
                        nr1 = (s1 - pred_h1[slot_i][ref_idx]) / s1
                        nr2 = (s2 - pred_h2[slot_i][ref_idx]) / s2
                        non_ref = max(non_ref, nr1, nr2)
                    cand.alt_prob_h1 = max(0.0001, prob_h1)
                    cand.alt_prob_h2 = max(0.0001, prob_h2)
                    cand.non_ref_prob = non_ref

                elif cand.allele.alt_type == INSERT_ALLELE:
                    alt = cand.allele.alt
                    p1 = p2 = 1.0
                    for index in range(
                            1, max_insert[cand.pos - local_start] + 1):
                        alt_idx = (get_index_from_base(alt[index])
                                   if index < len(alt)
                                   else get_index_from_base("*"))
                        slot_i = slot_of(cand.pos, index)
                        s1 = max(1.0, float(sum(pred_h1[slot_i])))
                        s2 = max(1.0, float(sum(pred_h2[slot_i])))
                        prob1 = (pred_h1[slot_i][alt_idx] + 0.1) / s1
                        prob2 = (pred_h2[slot_i][alt_idx] + 0.1) / s2
                        p1 *= max(0.0001, prob1)
                        p2 *= max(0.0001, prob2)
                    p1, p2 = max(0.0001, p1), max(0.0001, p2)
                    nr1 = nr2 = 0.0
                    length = 0
                    for index in range(
                            min(max_insert[cand.pos - local_start],
                                len(alt) - 1) + 1):
                        ref_idx = (get_index_from_base(cand.allele.ref[0])
                                   if index == 0
                                   else get_index_from_base("*"))
                        slot_i = slot_of(cand.pos, index)
                        s1 = max(1.0, float(sum(pred_h1[slot_i])))
                        s2 = max(1.0, float(sum(pred_h2[slot_i])))
                        nr1 += (s1 - pred_h1[slot_i][ref_idx]) / s1
                        nr2 += (s2 - pred_h2[slot_i][ref_idx]) / s2
                        length += 1
                    cand.alt_prob_h1 = p1
                    cand.alt_prob_h2 = p2
                    cand.non_ref_prob = max(nr1 / max(1, length),
                                            nr2 / max(1, length))

                elif cand.allele.alt_type == DELETE_ALLELE:
                    nr1 = nr2 = 0.0
                    non_ref_length = 0.0
                    p1 = p2 = 1.0
                    for pos in range(cand.pos, cand.pos + max_del_length):
                        inside = cand.pos < pos < cand.pos_end
                        if inside:
                            ref_idx = get_index_from_base(
                                cand.allele.ref[pos - cand.pos])
                            slot_i = slot_of(pos)
                            s1 = max(1.0, float(sum(pred_h1[slot_i])))
                            s2 = max(1.0, float(sum(pred_h2[slot_i])))
                            nr1 += (s1 - pred_h1[slot_i][ref_idx]) / s1
                            nr2 += (s2 - pred_h2[slot_i][ref_idx]) / s2
                            non_ref_length += 1.0
                        if inside:
                            del_idx = get_index_from_base("*")
                            slot_i = slot_of(pos)
                            s1 = max(1.0, float(sum(pred_h1[slot_i])))
                            s2 = max(1.0, float(sum(pred_h2[slot_i])))
                            d1 = (pred_h1[slot_i][del_idx] + 0.1) / s1
                            d2 = (pred_h2[slot_i][del_idx] + 0.1) / s2
                            best = max(0.0001, max(d1, d2))
                            p1 *= best
                            p2 *= best
                        elif pos >= cand.pos_end:
                            del_idx = get_index_from_base("*")
                            slot_i = slot_of(pos)
                            s1 = max(1.0, float(sum(pred_h1[slot_i])))
                            s2 = max(1.0, float(sum(pred_h2[slot_i])))
                            nd1 = (s1 - pred_h1[slot_i][del_idx]) / s1
                            nd2 = (s2 - pred_h2[slot_i][del_idx]) / s2
                            p1 *= max(0.0001, nd1)
                            p2 *= max(0.0001, nd2)
                    cand.alt_prob_h1 = max(1e-7, p1)
                    cand.alt_prob_h2 = max(1e-7, p2)
                    cand.non_ref_prob = max(
                        nr1 / max(1.0, non_ref_length),
                        nr2 / max(1.0, non_ref_length))

                if self.filter_candidate(cand, freq_based, freq):
                    record.candidates.append(cand)
            if not candidate_found:
                continue
            all_records.append(record)
        return all_records


class CandidateFinderCPP:
    """Wrapper API parity with CandidateFinderCPP.py:6-94 — fetches reads and
    reference around the region and runs the legacy finders."""

    SAFE_BASES = 20  # CandidateFinderOptions.SAFE_BASES

    def __init__(self, contig: str, start: int, end: int):
        self.contig = contig
        self.region_start = start
        self.region_end = end

    @staticmethod
    def overlap_length_between_ranges(range_a, range_b) -> int:
        return max(0, min(range_a[1], range_b[1])
                   - max(range_a[0], range_b[0]))

    def _load(self, bam_file_path: str, fasta_file_path: str,
              contig_name: str, region_start: int, region_end: int):
        from pepper_tpu_torch.io.bam_reader import BamReader
        from pepper_tpu_torch.io.fasta import FastaReader
        from pepper_tpu_torch.options import ReadFilterOptions
        reads = BamReader(bam_file_path).get_reads(
            contig_name, region_start, region_end,
            include_supplementary=ReadFilterOptions.INCLUDE_SUPPLEMENTARY,
            min_mapq=ReadFilterOptions.MIN_MAPQ,
            min_baseq=ReadFilterOptions.MIN_BASEQ)
        ref_start = max(0, self.region_start - self.SAFE_BASES * 2)
        ref_end = self.region_end + self.SAFE_BASES * 2
        ref = FastaReader(fasta_file_path).get_reference_sequence(
            self.contig, ref_start, ref_end).upper()
        return reads, ref, ref_start, ref_end

    def _collect(self, records: List[LegacyPositionalRecord],
                 region_start: int, region_end: int):
        records = sorted(records, key=lambda r: r._sort_key())
        positional_map = defaultdict(list)
        for rec in records:
            for cand in rec.candidates:
                if (region_start <= cand.pos_start
                        and cand.pos_end <= region_end):
                    positional_map[rec.pos_start].append(cand)
        return positional_map

    def find_candidates(self, bam_file_path, fasta_file_path, contig_name,
                        region_start, region_end, positions, predictions,
                        base_label, freq_based, freq):
        reads, ref, ref_start, ref_end = self._load(
            bam_file_path, fasta_file_path, contig_name, region_start,
            region_end)
        finder = LegacyCandidateFinder(
            ref, contig_name, max(0, region_start - self.SAFE_BASES),
            region_end + self.SAFE_BASES, ref_start, ref_end)
        records = finder.find_candidates(reads, positions, predictions,
                                         base_label, freq_based, freq)
        return self._collect(records, region_start, region_end)

    def find_candidates_hp(self, bam_file_path, fasta_file_path, contig_name,
                           region_start, region_end, all_positions,
                           all_indices, all_predictions_hp1,
                           all_predictions_hp2, freq_based, freq):
        reads, ref, ref_start, ref_end = self._load(
            bam_file_path, fasta_file_path, contig_name, region_start,
            region_end)
        finder = LegacyCandidateFinderHP(
            ref, contig_name, max(0, region_start - self.SAFE_BASES),
            region_end + self.SAFE_BASES, ref_start, ref_end)
        records = finder.find_candidates(reads, all_positions, all_indices,
                                         all_predictions_hp1,
                                         all_predictions_hp2, freq_based,
                                         freq)
        return self._collect(records, region_start, region_end)
