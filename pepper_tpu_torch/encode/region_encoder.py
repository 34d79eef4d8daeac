"""Region summary encoder — behavior parity with the reference's
RegionalSummaryGenerator (pepper_variant/modules/cpp/region_summary.cpp).

Live-path notes (quirks preserved deliberately):
  - GENERATE_INDELS=false in the reference (region_summary.h:50), so insert
    expansion never happens: row i of the matrix is ref_start+i, and
    positions[i]=ref_start+i, index[i]=0 (:69-96 with all-zero inserts).
  - Clamping to [-125,125] applies only to columns 11..24 (:648-653);
    columns 0-10 and 25 are left unclamped.
  - depth for a candidate = min(coverage, 125) BEFORE computing the
    candidate frequency (:682-689).
  - alleles iterate in lexicographic order (std::set<string>).
  - the last matrix row (index L) exists but is never written (:598).
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.events import (RegionEvents, collect_region_events,
                                      feature_index, ref_feature_value)
from pepper_tpu_torch.options import AlleleType, ImageOptions, VariantTypes

MAXV = ImageOptions.MAX_COLOR_VALUE
MINV = ImageOptions.MIN_COLOR_VALUE


@dataclass
class TruthRecord:
    """Truth VCF allele on one haplotype (reference type_truth_record)."""
    contig: str
    pos_start: int
    pos_end: int
    ref: str
    alt: str


@dataclass
class CandidateImage:
    """Parity with reference CandidateImageSummary (region_summary.h:88-111)."""
    contig: str
    position: int
    depth: int
    candidates: List[str]
    candidate_frequency: List[int]
    image: np.ndarray            # int32 [window+1, 26]
    base_label: int = 0
    type_label: int = 0


class CandidateBatch:
    """Array-backed batch of candidate images.

    The native encoder emits whole-region arrays; materializing tens of
    thousands of per-candidate CandidateImage objects dominated the host
    stage. This sequence type keeps the arrays and builds CandidateImage
    views only on item access, so batch consumers (the HDF5 store, the
    inference feed) stay zero-copy while per-item consumers see the same
    objects as before.
    """

    __slots__ = ("contig", "positions", "depths", "candidates",
                 "candidate_frequency", "images", "base_labels",
                 "type_labels", "sections")

    def __init__(self, contig: str, positions: np.ndarray,
                 depths: np.ndarray, candidates: List[str],
                 candidate_frequency: np.ndarray, images: np.ndarray,
                 base_labels: np.ndarray, type_labels: np.ndarray,
                 sections: Optional[Dict[str, float]] = None):
        self.contig = contig
        self.positions = positions
        self.depths = depths
        self.candidates = candidates          # one allele string per record
        self.candidate_frequency = candidate_frequency
        self.images = images                  # int32 [n, window+1, features]
        self.base_labels = base_labels
        self.type_labels = type_labels
        # the native encoder's thread CPU seconds by section (None: not
        # encoded natively)
        self.sections = sections

    def __len__(self) -> int:
        return len(self.positions)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = range(*i.indices(len(self)))
            return [self[j] for j in idx]
        return CandidateImage(
            contig=self.contig, position=int(self.positions[i]),
            depth=int(self.depths[i]), candidates=[self.candidates[i]],
            candidate_frequency=[int(self.candidate_frequency[i])],
            image=self.images[i], base_label=int(self.base_labels[i]),
            type_label=int(self.type_labels[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def select(self, mask: np.ndarray) -> "CandidateBatch":
        keep = np.flatnonzero(mask)
        return CandidateBatch(
            self.contig, self.positions[keep], self.depths[keep],
            [self.candidates[int(j)] for j in keep],
            self.candidate_frequency[keep], self.images[keep],
            self.base_labels[keep], self.type_labels[keep])

    @classmethod
    def concat(cls, batches: Sequence["CandidateBatch"]) -> "CandidateBatch":
        b0 = batches[0]
        cands: List[str] = []
        for b in batches:
            cands.extend(b.candidates)
        return cls(
            b0.contig,
            np.concatenate([b.positions for b in batches]),
            np.concatenate([b.depths for b in batches]), cands,
            np.concatenate([b.candidate_frequency for b in batches]),
            np.concatenate([b.images for b in batches]),
            np.concatenate([b.base_labels for b in batches]),
            np.concatenate([b.type_labels for b in batches]))


_BASE_LABELS = ImageOptions.DECODED_BASE_LABELS


def get_label_index(h1: str, h2: str) -> int:
    """region_summary.cpp:108-120."""
    h1, h2 = h1.upper(), h2.upper()
    for i, pair in enumerate(_BASE_LABELS):
        if (h1 == pair[0] and h2 == pair[1]) or (h2 == pair[0] and h1 == pair[1]):
            return i
    return 0


_TYPE_LABEL = {
    (0, 0): 0, (0, 1): 1, (1, 0): 1, (0, 2): 2, (2, 0): 2, (0, 3): 3, (3, 0): 3,
    (1, 1): 4, (1, 2): 5, (2, 1): 5, (1, 3): 6, (3, 1): 6, (2, 2): 7,
    (2, 3): 8, (3, 2): 8, (3, 3): 9,
}


def get_variant_type_label_index(t1: int, t2: int) -> int:
    """region_summary.cpp:123-153."""
    return _TYPE_LABEL[(t1, t2)]


def _truth_candidate_string(rec: TruthRecord) -> str:
    """Truth allele -> candidate-string form (region_summary.cpp:726-788),
    including the reference's minimal-representation trim."""
    ref, alt = rec.ref, rec.alt
    if len(ref) > len(alt):
        allele, atype = ref, AlleleType.DELETE
        other = alt
    elif len(ref) < len(alt):
        allele, atype = alt, AlleleType.INSERT
        other = ref
    else:
        allele, atype = alt, AlleleType.SNP
        other = ref
    if len(allele) > 1 and len(other) > 1:
        min_len = min(len(allele), len(other))
        allele = allele[: len(allele) - min_len + 1]
    return chr(atype + ord("0")) + allele


class RegionalSummary:
    """One padded region's encoder state (parity: RegionalSummaryGenerator)."""

    def __init__(self, contig: str, ref_start: int, ref_end: int, ref_seq: str):
        self.contig = contig
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.ref_seq = ref_seq
        self.L = ref_end - ref_start + 1
        # live path: no insert expansion
        self.positions = np.arange(ref_start, ref_end + 1, dtype=np.int64)
        self.index = np.zeros(self.L, dtype=np.int32)
        # train-mode label state
        self._labels_hp = None
        self._types_hp = None
        self._truth_alleles = None
        self.labels = np.zeros(self.L + 1, dtype=np.uint16)
        self.labels_variant_type = np.zeros(self.L + 1, dtype=np.uint16)

    # ------------------------------------------------------------------ labels
    def generate_labels(self, hap1: Sequence[TruthRecord],
                        hap2: Sequence[TruthRecord]) -> None:
        """region_summary.cpp:234-334 (no insert expansion in the live path)."""
        size = self.L + 1
        labels_hp = [np.full(size, ord("*"), np.uint8), np.full(size, ord("*"), np.uint8)]
        types_hp = [np.zeros(size, np.int32), np.zeros(size, np.int32)]
        truth_alleles: List[List[List[TruthRecord]]] = [
            [[] for _ in range(size)], [[] for _ in range(size)]]
        for hap_labels in labels_hp:
            hap_labels[: self.L] = ord("R")
        for h, records in enumerate((hap1, hap2)):
            for rec in records:
                if not (self.ref_start <= rec.pos_start <= self.ref_end):
                    # SNP per-base loop below still gated per position
                    if len(rec.ref) != len(rec.alt):
                        continue
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
                            ref_base = self.ref_seq[i]
                            alt_base = rec.alt[pos - rec.pos_start]
                            labels_hp[h][i] = (ord("R") if ref_base == alt_base
                                               else ord(alt_base))
        self._labels_hp = labels_hp
        self._types_hp = types_hp
        self._truth_alleles = truth_alleles

    # ------------------------------------------------------------------ encode
    def generate_summary(self, reads, min_snp_baseq: float, min_indel_baseq: float,
                         snp_freq_threshold: float, insert_freq_threshold: float,
                         delete_freq_threshold: float, min_coverage_threshold: float,
                         snp_candidate_freq_threshold: float,
                         indel_candidate_freq_threshold: float,
                         candidate_support_threshold: float, skip_indels: bool,
                         candidate_region_start: int, candidate_region_end: int,
                         candidate_window_size: int = ImageOptions.CANDIDATE_WINDOW_SIZE,
                         feature_size: int = ImageOptions.IMAGE_HEIGHT,
                         train_mode: bool = False,
                         events: Optional[RegionEvents] = None,
                         matrix: Optional[np.ndarray] = None,
                         ) -> List[CandidateImage]:
        """Parity: region_summary.cpp:568-916.

        `events`/`matrix` may be supplied by an alternative backend (e.g. the
        JAX device encoder) — when given, the host scatter-add is skipped.
        """
        L = self.L
        if events is None:
            events = collect_region_events(reads, self.ref_seq, self.ref_start,
                                           self.ref_end, min_snp_baseq,
                                           min_indel_baseq)
        if matrix is None:
            matrix = accumulate_matrix(events, self.ref_seq, L, feature_size)

        coverage = np.bincount(events.coverage_idx, minlength=L)
        snp_count = np.bincount(events.snp_idx, minlength=L)
        insert_count = np.bincount(events.insert_idx, minlength=L)
        delete_count = np.bincount(events.delete_idx, minlength=L)

        # allele frequency maps (host): idx -> {cand: [total, fwd, rev]}
        allele_maps: Dict[int, Dict[str, List[int]]] = {}
        for idx, cand, is_rev in events.alleles:
            site = allele_maps.setdefault(idx, {})
            entry = site.setdefault(cand, [0, 0, 0])
            entry[0] += 1
            entry[2 if is_rev else 1] += 1

        # site-level thresholds (:634-645)
        cov_div = np.maximum(1.0, coverage.astype(np.float64))
        snp_frac = snp_count / cov_div
        ins_frac = insert_count / cov_div
        del_frac = delete_count / cov_div
        snp_pass = snp_frac >= snp_freq_threshold
        ins_pass = ins_frac >= insert_freq_threshold
        del_pass = del_frac >= delete_freq_threshold
        any_pass = snp_pass | ins_pass | del_pass
        in_cand_region = ((self.positions >= candidate_region_start)
                          & (self.positions <= candidate_region_end)
                          & (coverage >= min_coverage_threshold))
        site_selected = any_pass & in_cand_region
        # threshold_pass arrays are only set for selected sites (:642-644)
        snp_pass = snp_pass & site_selected
        ins_pass = ins_pass & site_selected
        del_pass = del_pass & site_selected
        filtered_positions = np.flatnonzero(site_selected)

        # clamp columns 11..24 on rows 0..L-1 (:648-653)
        clamp = matrix[:L, ImageOptions.BASE_INDEX_START:
                       ImageOptions.BASE_INDEX_START + ImageOptions.BASE_INDEX_SIZE]
        np.clip(clamp, MINV, MAXV, out=clamp)

        # train labels (:657-665)
        if train_mode and self._labels_hp is not None:
            for i in range(self.L + 1):
                self.labels[i] = get_label_index(chr(self._labels_hp[0][i]),
                                                 chr(self._labels_hp[1][i]))
                self.labels_variant_type[i] = get_variant_type_label_index(
                    int(self._types_hp[0][i]), int(self._types_hp[1][i]))

        out: List[CandidateImage] = []
        half = candidate_window_size // 2
        win = candidate_window_size + 1
        for idx in filtered_positions:
            idx = int(idx)
            pos = self.ref_start + idx
            site = allele_maps.get(idx, {})
            depth = min(int(coverage[idx]), MAXV)
            for cand in sorted(site.keys()):
                total, fwd, rev = site[cand]
                freq = total / max(1.0, float(depth))
                ctype = cand[0]
                if total < candidate_support_threshold:
                    continue
                if ctype != "1" and freq < indel_candidate_freq_threshold:
                    continue
                if ctype == "1" and freq < snp_candidate_freq_threshold:
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
                    gt = 2 if (found[0] and found[1]) else (1 if any(found) else 0)
                    base_label = int(self.labels[idx])
                    type_label = gt

                # window crop (:828-841); rows <0 or >L map to zeros
                # (row index L itself is valid: the always-zero extra row)
                image = np.zeros((win, matrix.shape[1]), dtype=np.int32)
                lo = idx - half
                src_lo = max(lo, 0)
                src_hi = min(idx + half, L) + 1
                if src_hi > src_lo:
                    image[src_lo - lo: src_hi - lo] = matrix[src_lo:src_hi]

                ref_base = self.ref_seq[idx]
                mid = half
                fwd_c = min(fwd, MAXV)
                rev_c = min(rev, MAXV)
                if ctype == "1":
                    ffi = feature_index(ref_base, cand[1], False)
                    rfi = feature_index(ref_base, cand[1], True)
                    image[mid, 1] = ref_feature_value(cand[1])
                    image[mid, 5] = fwd_c
                    image[mid, 16] = rev_c
                    if ffi >= 0:
                        image[mid, ffi] = -image[mid, ffi]
                        image[mid, rfi] = -image[mid, rfi]
                elif ctype == "2":
                    ffi = feature_index(ref_base, "I", False)
                    rfi = feature_index(ref_base, "I", True)
                    image[mid, 2] = min(len(cand) - 1, MAXV)
                    image[mid, 6] = fwd_c
                    image[mid, 17] = rev_c
                    if ffi >= 0:
                        image[mid, ffi] = -image[mid, ffi]
                        image[mid, rfi] = -image[mid, rfi]
                else:
                    del_len = len(cand) - 1
                    end_index = min(mid + del_len - 1, candidate_window_size - 1)
                    ffi = feature_index(ref_base, "D", False)
                    rfi = feature_index(ref_base, "D", True)
                    image[mid, 3] = min(del_len, MAXV)
                    image[mid, 7] = fwd_c
                    image[mid, 18] = rev_c
                    if ffi >= 0:
                        image[mid, ffi] = -image[mid, ffi]
                        image[mid, rfi] = -image[mid, rfi]
                    sfi = feature_index(ref_base, "*", False)
                    sri = feature_index(ref_base, "*", True)
                    for widx in range(mid + 1, end_index + 1):
                        image[widx, 3] = min(del_len, MAXV)
                        image[widx, 7] = fwd_c
                        image[widx, 18] = rev_c
                        if sfi >= 0:
                            image[widx, sfi] = -image[widx, sfi]
                            image[widx, sri] = -image[widx, sri]

                out.append(CandidateImage(
                    contig=self.contig, position=pos, depth=depth,
                    candidates=[cand],
                    candidate_frequency=[min(total, MAXV)],
                    image=image, base_label=base_label, type_label=type_label))
        return out


def accumulate_matrix(events: RegionEvents, ref_seq: str, L: int,
                      feature_size: int = ImageOptions.IMAGE_HEIGHT) -> np.ndarray:
    """Scatter-add events into the [L+1, feature_size] count matrix (host
    backend; pepper_tpu/encode/jax_encoder.py is the device equivalent)."""
    matrix = np.zeros((L + 1, feature_size), dtype=np.int32)
    # reference-base column (region_summary.cpp:174-191)
    codes = np.frombuffer(ref_seq[:L].encode("ascii"), dtype=np.uint8)
    values = np.full(L, 5, dtype=np.int32)
    for base, val in ((65, 1), (67, 2), (71, 3), (84, 4)):
        values[codes == base] = val
    matrix[:L, 0] = values
    # scatter-subtract via bincount over the flattened index (np.subtract.at
    # is ~20x slower at this event volume)
    # int32 arithmetic: max index (L+1)*26 stays far below 2^31
    flat = events.matrix_rows * feature_size + events.matrix_cols
    counts = np.bincount(flat, minlength=(L + 1) * feature_size)
    matrix -= counts.reshape(L + 1, feature_size).astype(np.int32, copy=False)
    return matrix
