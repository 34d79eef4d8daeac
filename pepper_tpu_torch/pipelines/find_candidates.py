"""Stage 3 — prediction post-processing into candidate variants + VCFs.

Parity source: pepper_variant/modules/python/CandidateFinder.py (homopolymer
repeat annotation, Margin-SNP list + DeepVariant list with per-type p-value
thresholds and frequency overrides, positional de-dup) and FindCandidates.py
(driver + 5-VCF output + telemetry counts).
"""
import concurrent.futures
import os
import sys
import time
from collections import defaultdict
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.io.vcf import VCFWriteEngine
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.datastore import (PredictionStore,
                                            iter_prediction_batches)
from pepper_tpu_torch.runtime.inference import image_files


def repeat_annotation(sequence: str, kmer_size: int) -> List[int]:
    """k-mer repeat counts per position (CandidateFinder.py:279-297).

    For kmer_size=1 (the only size the live candidate path uses) the
    reference's O(n^2) scan reduces exactly to per-position homopolymer
    run length: every position inside a maximal run of length L observes
    max(1, L) — computed here in one O(n) pass."""
    n = len(sequence)
    if kmer_size == 1:
        out = [1] * n
        i = 0
        while i < n:
            j = i + 1
            while j < n and sequence[j] == sequence[i]:
                j += 1
            if j - i > 1:
                out[i:j] = [j - i] * (j - i)
            i = j
        return out
    max_observed = [1] * n
    for i in range(n - (kmer_size - 1)):
        kmer_count = 0
        end_index = i + (kmer_size - 1)
        for j in range(i, n, kmer_size):
            if sequence[i:i + kmer_size] == sequence[j:j + kmer_size]:
                kmer_count += 1
            else:
                break
            end_index = j + kmer_size
        for k in range(i, min(n, end_index)):
            max_observed[k] = max(max_observed[k], kmer_count)
    return max_observed


_ACGT = frozenset("ACGT")


def _valid_allele(allele: str) -> bool:
    if len(allele) == 1:  # the overwhelmingly common case (SNPs)
        return allele in _ACGT
    return not (set(allele) - _ACGT)


class _ContigSpanCache:
    """One FASTA fetch per (contig, batch position span) instead of three
    per candidate: candidates arrive batch-grouped and position-ordered, so
    a single span read serves every up/downstream slice in the batch.

    On load the span also finds where 5 equal bases start in a row, so the
    per-site repeat gate (CandidateFinder.py:393-416), "a position of the
    window sits in a homopolymer run of length >= REPEAT_LENGTH_THRESHOLD",
    is one binary search per candidate instead of a 20-char Python scan: a
    position lies in such a run exactly when one of those 5-base windows
    covers it. Equivalence: the reference computes run lengths on the
    +/-10bp substring and checks max over window [pos-5, pos+4); every run
    of length >= 5 that touches the check window keeps a >= 5 segment
    inside the +/-10 window (the window extends >= 5 past the check region
    on both sides), and windowed runs never exceed full runs, so the >= 5
    gate is identical computed on the whole span."""

    def __init__(self, fasta: FastaReader):
        self._fasta = fasta
        self._contig: Optional[str] = None
        self._lo = 0
        self._seq = ""
        self._arr = np.zeros(0, np.uint8)
        self._run5 = np.zeros(0, np.intp)

    _AHEAD = 1 << 16   # over-fetch on miss: positions ascend within regions

    def load(self, contig: str, lo: int, hi: int) -> None:
        lo = max(0, lo)
        if (contig == self._contig and self._lo <= lo
                and hi <= self._lo + len(self._seq)):
            return
        self._contig, self._lo = contig, lo
        self._seq = self._fasta.get_reference_sequence(
            contig, lo, max(hi, lo + self._AHEAD)).upper()
        arr = np.frombuffer(self._seq.encode(), np.uint8)
        self._arr = arr
        # the offsets s where arr[s:s + 5] is one base five times
        eq = arr[1:] == arr[:-1]
        self._run5 = np.flatnonzero(eq[:-3] & eq[1:-2] & eq[2:-1] & eq[3:])

    def slice(self, lo: int, hi: int) -> str:
        """[lo, hi) clamped to the loaded span (contig-end truncation has
        the same effect as the reference's per-call clamping)."""
        lo = max(lo, self._lo)
        return self._seq[lo - self._lo:hi - self._lo]

    def annotate(self, positions: np.ndarray):
        """(ref_base_bytes, candidate_in_repeat) for each position; the
        loaded span must cover [min-10, max+10)."""
        off = positions - self._lo
        n = len(self._arr)
        refb = np.where(off < n, self._arr[np.minimum(off, n - 1)], 0) \
            if n else np.zeros(len(off), np.uint8)
        lo = np.clip(off - 5, 0, n)
        hi = np.clip(off + 4, 0, n)
        # a run window [s, s + 5) meets [lo, hi): s in [lo - 4, hi - 1]
        first = np.searchsorted(self._run5, lo - 4)
        run5 = np.append(self._run5, n)
        in_repeat = run5[first] < hi
        return refb, in_repeat


class ColumnarDv:
    """Array-backed DeepVariant candidates for one contig run of one
    prediction batch — the zero-tuple fast lane from the vectorized gates
    to the native VCF sink. `ref`/`alts` stay per-row strings (variable
    length); everything else is numpy. Rows are position-ascending."""

    __slots__ = ("contig", "pos", "ref", "alts", "pg", "depth", "freq",
                 "gt_prob", "nap", "rep", "preds")

    def __init__(self, contig, pos, ref, alts, pg, depth, freq, gt_prob,
                 nap, rep, preds):
        self.contig = contig
        self.pos = pos
        self.ref = ref
        self.alts = alts
        self.pg = pg
        self.depth = depth
        self.freq = freq
        self.gt_prob = gt_prob
        self.nap = nap
        self.rep = rep
        self.preds = preds

    def __len__(self):
        return len(self.pos)

    def slice(self, lo: int, hi: int) -> "ColumnarDv":
        return ColumnarDv(self.contig, self.pos[lo:hi], self.ref[lo:hi],
                          self.alts[lo:hi], self.pg[lo:hi],
                          self.depth[lo:hi], self.freq[lo:hi],
                          self.gt_prob[lo:hi], self.nap[lo:hi],
                          self.rep[lo:hi], self.preds[lo:hi])

    _GT_TAB = ([0, 0], [0, 1], [1, 1])

    def tuples(self) -> list:
        """Per-row tuples in the classic dv layout (fallback paths)."""
        out = []
        for k in range(len(self.pos)):
            pg = int(self.pg[k])
            out.append((self.contig, int(self.pos[k]),
                        int(self.pos[k]) + len(self.ref[k]), self.ref[k],
                        [self.alts[k]], list(self._GT_TAB[pg]),
                        int(self.depth[k]), [int(self.freq[k])],
                        float(self.gt_prob[k]), list(self.preds[k]),
                        [float(self.nap[k])], bool(self.rep[k])))
        return out


_ACGT_BYTES = frozenset(b"ACGT")
# the one-letter string of each byte value (reference bases by code)
_BYTE_CHARS = np.array([chr(b) for b in range(256)], dtype=object)


def _allele_table(cand_lists) -> Tuple[np.ndarray, list]:
    """(codes, table): the batch's distinct candidate rows as tuples, in
    first-seen order, and each row's index into them, from one dict pass.
    The streamed rows of one allele share one tuple (runtime/streaming.py::
    _batch_fields): a region's ~3,000 rows hold ~100 distinct alleles.
    Rows read back as lists (the resume journal, the prediction HDF5) are
    keyed by their value."""
    try:
        index = dict.fromkeys(cand_lists)
    except TypeError:
        cand_lists = list(map(tuple, cand_lists))
        index = dict.fromkeys(cand_lists)
    table = list(index)
    index.update(zip(table, range(len(table))))
    codes = np.fromiter(map(index.__getitem__, cand_lists), np.intp,
                        len(cand_lists))
    return codes, table


# test hook: force the scalar gate loop even for single-allele batches so
# the vectorized fast path can be differential-tested against it
_FORCE_LOOP = False


def batch_candidates(config: PipelineConfig, span: _ContigSpanCache,
                     contigs, positions, depths, cand_lists, freq_lists,
                     preds, margin_list: list, deepvariant_list: list,
                     columnar_out: Optional[list] = None) -> None:
    """Candidate gates for one prediction batch held in memory
    (CandidateFinder.py:356-531). Appends to margin/deepvariant lists.

    contigs: per-row contig names; positions/depths: int arrays;
    cand_lists: per-row allele-string lists; freq_lists: per-row support
    lists; preds: [N, 3] probability array.

    columnar_out: when given AND the single-allele vectorized path
    applies, passing candidates are appended there as ColumnarDv blocks
    (no margin/dv tuples are built — the ordered emitter consumes arrays
    straight into the native VCF sink); otherwise tuples land in
    deepvariant_list as usual."""
    n = len(contigs)
    if n == 0:
        return
    preds = np.asarray(preds)
    pg_arr = np.argmax(preds, axis=1)
    values_arr = preds[np.arange(n), pg_arr]
    nap_arr = np.maximum(preds[:, 1], preds[:, 2])
    positions = np.asarray(positions, np.int64)

    # per-contig-run span annotation (a batch is almost always one contig)
    ref_bytes = np.zeros(n, np.uint8)
    in_repeat_arr = np.zeros(n, bool)
    contig_runs = []
    i = 0
    if isinstance(contigs, list) and contigs.count(contigs[0]) == n:
        contig_runs.append((0, n, contigs[0]))   # one contig: one C pass
        i = n
    while i < n:
        j = i + 1
        while j < n and contigs[j] == contigs[i]:
            j += 1
        contig_runs.append((i, j, contigs[i]))
        i = j
    for i, j, contig in contig_runs:
        pos_grp = positions[i:j]
        span.load(contig, int(pos_grp.min()) - 10, int(pos_grp.max()) + 10)
        ref_bytes[i:j], in_repeat_arr[i:j] = span.annotate(pos_grp)
    valid_np = np.isin(ref_bytes, np.frombuffer(b"ACGT", np.uint8))

    snp_p, snp_p_lc = config.snp_p_value, config.snp_p_value_in_lc
    ins_p, ins_p_lc = config.insert_p_value, config.insert_p_value_in_lc
    del_p, del_p_lc = config.delete_p_value, config.delete_p_value_in_lc
    snp_freq, indel_freq = (config.report_snp_above_freq,
                            config.report_indel_above_freq)

    codes, table = _allele_table(cand_lists)
    if not _FORCE_LOOP and all(len(c) == 1 for c in table):
        # one allele per row — the shape the encoder always emits
        # (region_encoder.py:73,391): every gate is pure threshold algebra,
        # so the decisions vectorize and Python only materializes the
        # tuples for rows that pass. What an allele decides (its type, its
        # body, whether the body is valid) is computed once per distinct
        # allele and indexed per row. Bit-identical to the loop below
        # (differential-tested vs the reference's small_chunk_stitch).
        alleles = [c[0] for c in table]
        atype = (np.frombuffer("".join(a[0] for a in alleles)
                               .encode("latin-1"), np.uint8)
                 - ord("0"))[codes]
        bodies = np.empty(len(alleles), object)
        bodies[:] = [a[1:] for a in alleles]
        valid_allele = np.fromiter(map(_valid_allele, bodies), bool,
                                   len(alleles))[codes]
        # freq_lists may arrive as a flat array (the streamed flush path
        # avoids materializing 1-element python lists per row)
        freqs = (np.asarray(freq_lists, np.int64)
                 if isinstance(freq_lists, np.ndarray)
                 else np.asarray([f[0] for f in freq_lists], np.int64))
        depths_arr = np.asarray(depths, np.float64)
        vaf = np.where(depths_arr > 0, freqs / np.maximum(depths_arr, 1), 0.0)
        nap = nap_arr
        pg = pg_arr
        valid_arr = valid_np
        rep = in_repeat_arr

        p_pass = np.where(
            atype == 1, np.where(rep, nap >= snp_p_lc, nap >= snp_p),
            np.where(atype == 2,
                     np.where(rep, nap >= ins_p_lc, nap >= ins_p),
                     np.where(rep, nap >= del_p_lc, nap >= del_p)))
        freq_override = np.where(
            atype == 1, (snp_freq > 0) & (vaf >= snp_freq),
            (indel_freq > 0) & (vaf >= indel_freq))
        base_ok = valid_arr & valid_allele & (atype >= 1) & (atype <= 3)
        margin_mask = base_ok & (atype == 1) & (pg != 0)
        dv_mask = base_ok & (p_pass | freq_override)
        del_swap = (atype == 3) & p_pass

        # the passing rows' strings: the allele's body and the reference
        # base, which a deletion that passes its p-value gate swaps
        sel = np.flatnonzero(dv_mask)
        body_sel = bodies[codes[sel]]
        refc_sel = _BYTE_CHARS[ref_bytes[sel]]
        swap = del_swap[sel]
        refs = np.where(swap, body_sel, refc_sel).tolist()
        alts = np.where(swap, refc_sel, body_sel).tolist()
        if columnar_out is not None:
            # zero-tuple lane: arrays all the way to the native VCF sink
            # (margin tuples skipped — the ordered emitter discards them)
            depths_i = np.asarray(depths, np.int32)
            for i0, j0, ctg in contig_runs:
                lo, hi = np.searchsorted(sel, (i0, j0)).tolist()
                if lo == hi:
                    continue
                m = sel[lo:hi]
                columnar_out.append(ColumnarDv(
                    ctg, positions[m], refs[lo:hi], alts[lo:hi],
                    pg_arr[m].astype(np.uint8), depths_i[m],
                    freqs[m].astype(np.int32), values_arr[m],
                    nap_arr[m], in_repeat_arr[m], preds[m]))
            return

        gt_tab = ([0, 0], [0, 1], [1, 1])
        depths_np = np.asarray(depths)

        def rows(m):
            # the python values of rows m, for the tuples
            return zip(m.tolist(), positions[m].tolist(),
                       depths_np[m].tolist(), pg[m].tolist(),
                       freqs[m].tolist(), values_arr[m].tolist(),
                       preds[m].tolist())

        m = np.flatnonzero(margin_mask)
        for (i, pos, depth, g, freq, value, pred), ref_c, body in zip(
                rows(m), _BYTE_CHARS[ref_bytes[m]].tolist(),
                bodies[codes[m]].tolist()):
            margin_list.append((
                contigs[i], pos, pos + 1, ref_c, [body], list(gt_tab[g]),
                depth, [freq], value, pred))
        for (i, pos, depth, g, freq, value, pred), ref_out, alt, nap_i, \
                rep_i in zip(rows(sel), refs, alts, nap[sel].tolist(),
                             rep[sel].tolist()):
            deepvariant_list.append((
                contigs[i], pos, pos + len(ref_out), ref_out, [alt],
                list(gt_tab[g]), depth, [freq], value, pred, [nap_i],
                rep_i))
        return

    # per-row python views for the scalar loop
    (all_genotypes, all_values, all_non_alt, all_preds, all_positions,
     all_depths, valid, in_repeats) = (
        pg_arr.tolist(), values_arr.tolist(), nap_arr.tolist(),
        preds.tolist(), positions.tolist(), np.asarray(depths).tolist(),
        valid_np.tolist(), in_repeat_arr.tolist())
    ref_chars = ref_bytes.tobytes().decode("latin-1")
    if isinstance(freq_lists, np.ndarray):   # flat array from the stream
        freq_lists = [[int(f)] for f in freq_lists.tolist()]
    for i in range(n):
        if not valid[i]:
            continue
        contig = contigs[i]
        position = all_positions[i]
        depth = all_depths[i]
        cand_strings = cand_lists[i]
        cand_freqs = freq_lists[i]
        prediction_base = all_preds[i]
        reference_base = ref_chars[i]
        candidate_in_repeat = in_repeats[i]

        predicted_genotype = all_genotypes[i]
        genotype = ([0, 0], [0, 1], [1, 1])[predicted_genotype]
        prediction_value = all_values[i]

        # Margin list: SNPs only, non-hom-ref prediction
        alt_alleles, support = [], []
        for alt_allele, freq in zip(cand_strings, cand_freqs):
            alt_type, allele = alt_allele[0], alt_allele[1:]
            if not _valid_allele(allele):
                continue
            if alt_type == "1" and predicted_genotype != 0:
                alt_alleles.append(allele)
                support.append(freq)
        if alt_alleles:
            margin_list.append((
                contig, position, position + 1, reference_base,
                alt_alleles, genotype, depth, support,
                prediction_value, prediction_base))

        # DeepVariant list: per-type p-value gates + freq overrides
        alt_alleles, support = [], []
        reference_allele = reference_base
        non_alt_predictions = []
        for alt_allele, freq in zip(cand_strings, cand_freqs):
            alt_type, allele = alt_allele[0], alt_allele[1:]
            if not _valid_allele(allele):
                continue
            vaf = freq / depth if depth else 0.0
            non_alt_prediction = all_non_alt[i]
            non_alt_predictions.append(non_alt_prediction)
            if alt_type == "1":
                if (not candidate_in_repeat
                        and non_alt_prediction >= snp_p):
                    alt_alleles.append(allele); support.append(freq)
                elif (candidate_in_repeat
                      and non_alt_prediction >= snp_p_lc):
                    alt_alleles.append(allele); support.append(freq)
                elif 0 < snp_freq <= vaf:
                    alt_alleles.append(allele); support.append(freq)
            elif alt_type == "2":
                if (not candidate_in_repeat
                        and non_alt_prediction >= ins_p):
                    alt_alleles.append(allele); support.append(freq)
                elif (candidate_in_repeat
                      and non_alt_prediction >= ins_p_lc):
                    alt_alleles.append(allele); support.append(freq)
                elif 0 < indel_freq <= vaf:
                    alt_alleles.append(allele); support.append(freq)
            elif alt_type == "3":
                if (not candidate_in_repeat
                        and non_alt_prediction >= del_p):
                    alt_alleles.append(reference_allele)
                    reference_allele = allele
                    support.append(freq)
                elif (candidate_in_repeat
                      and non_alt_prediction >= del_p_lc):
                    alt_alleles.append(reference_allele)
                    reference_allele = allele
                    support.append(freq)
                elif 0 < indel_freq <= vaf:
                    alt_alleles.append(allele); support.append(freq)
        if alt_alleles:
            deepvariant_list.append((
                contig, position, position + len(reference_allele),
                reference_allele, alt_alleles, genotype, depth, support,
                prediction_value, prediction_base,
                non_alt_predictions, candidate_in_repeat))


def _batch_freq_lists(candidate_frequency, n_rows: int):
    """Per-row support lists from a stored frequency field that is either
    [N, A] (one row per candidate) or flat [N]."""
    freq_rows = np.atleast_2d(np.asarray(candidate_frequency))
    if freq_rows.shape[0] == n_rows:
        return freq_rows.tolist()
    return [[int(f)] for f in np.ravel(candidate_frequency).tolist()]


def small_chunk_stitch(config: PipelineConfig,
                       file_chunks: List[Tuple[str, str]]):
    """Per-(file,batch) candidate selection (CandidateFinder.py:356-531)."""
    fasta = FastaReader(config.fasta)
    span = _ContigSpanCache(fasta)
    margin_list: list = []
    deepvariant_list: list = []
    for file_name, batch_key in file_chunks:
        with PredictionStore(file_name, "r") as store:
            batch = store.read_batch(batch_key)
        batch_candidates(
            config, span, batch.contigs, batch.positions, batch.depths,
            batch.candidates,
            _batch_freq_lists(batch.candidate_frequency, len(batch.contigs)),
            batch.base_prediction, margin_list, deepvariant_list)
    fasta.close()
    return margin_list, deepvariant_list


def _dedupe_site(cands: list) -> list:
    """Positional de-dup of one site's candidates by (ref, first-alt) pair,
    order-preserving — the per-key logic of aggregate_candidates."""
    seen: list = []
    out: list = []
    for cand in cands:
        pair = (cand[3], cand[4][0])
        if pair in seen:
            continue
        seen.append(pair)
        out.append(cand)
    return out


class _OrderedEmitter:
    """Interval-watermark VCF emission for the single-host stream.

    Intervals MUST arrive pre-sorted in the final record order —
    lexicographic (contig, start), the order `sorted(variants_list)` would
    yield — so records for every interval before the watermark can be
    written while later intervals are still encoding. A candidate is
    bucketed by position (boundary candidates at an interval's end == the
    next interval's start land in the next bucket, which only ever emits
    after both neighbours are final, preserving the aggregate de-dup)."""

    def __init__(self, writer, config: PipelineConfig, intervals):
        import threading
        keys = [(c, s) for c, s, _e in intervals]
        assert all(keys[i] <= keys[i + 1] for i in range(len(keys) - 1)), \
            "ordered emission requires (contig, start)-sorted intervals"
        self.writer = writer
        self._config = config
        self._n = len(intervals)
        self._starts: Dict[str, List[int]] = {}
        self._idx0: Dict[str, int] = {}
        for i, (contig, start, _end) in enumerate(intervals):
            if contig not in self._starts:
                self._starts[contig] = []
                self._idx0[contig] = i
            self._starts[contig].append(start)
        self._starts_np = {c: np.asarray(s, np.int64)
                           for c, s in self._starts.items()}
        self._totals: Dict[int, int] = {}
        self._gated: Dict[int, int] = {}
        self._buckets: Dict[int, list] = {}
        self._head = 0
        self._lock = threading.Lock()

    def _interval_of(self, contig: str, pos: int) -> int:
        import bisect
        starts = self._starts[contig]
        local = bisect.bisect_right(starts, pos) - 1
        return self._idx0[contig] + max(0, local)

    def note_interval(self, idx: int, n_rows: int) -> None:
        with self._lock:
            self._totals[idx] = n_rows

    def gated(self, new_dv: list, runs) -> None:
        """Collector thread: bucket this batch's passing candidates
        (tuples or ColumnarDv blocks), credit its rows against their
        intervals, then emit the final prefix."""
        from pepper_tpu_torch.utils import streamstats
        with streamstats.CURRENT.span("(emit_bucket)", cpu=True):
            for cand in new_dv:
                if isinstance(cand, ColumnarDv):
                    self._bucket_columnar(cand)
                else:
                    self._buckets.setdefault(
                        self._interval_of(cand[0], cand[1]), []).append(cand)
        with self._lock:
            for idx, k in runs:
                self._gated[idx] = self._gated.get(idx, 0) + k
        self.advance()

    def _bucket_columnar(self, col: ColumnarDv) -> None:
        """Vectorized interval assignment: rows are position-ascending, so
        interval indices are non-decreasing and the block splits into a
        handful of contiguous slices."""
        starts = self._starts_np[col.contig]
        idx = np.searchsorted(starts, col.pos, side="right") - 1
        np.maximum(idx, 0, out=idx)
        idx += self._idx0[col.contig]
        bounds = (np.flatnonzero(np.diff(idx)) + 1).tolist() + [len(idx)]
        lo = 0
        for hi in bounds:
            if hi > lo:
                self._buckets.setdefault(int(idx[lo]), []).append(
                    col.slice(lo, hi))
            lo = hi

    def _is_final(self, idx: int) -> bool:
        total = self._totals.get(idx)
        return total is not None and self._gated.get(idx, 0) >= total

    _GT_TO_PG = {(0, 0): 0, (0, 1): 1, (1, 1): 2}

    def _write_batched(self, bucket: list) -> None:
        """Emit one finalized interval's sorted bucket through the native
        engine: maximal runs of single-candidate sites go down the
        columnar C++ fast path; multi-candidate sites take the shared
        per-site renderer. Order (and therefore output bytes) is
        identical to the per-site loop."""
        writer = self.writer
        n = len(bucket)
        i = 0
        run: list = []

        def flush_run():
            if not run:
                return
            writer.write_sites_batch(
                run[0][0], [c[1] for c in run], [c[3] for c in run],
                [c[4][0] for c in run],
                [self._GT_TO_PG[tuple(c[5])] for c in run],
                [c[6] for c in run], [c[7][0] for c in run],
                [c[8] for c in run], [c[10][0] for c in run],
                [c[11] for c in run])
            run.clear()

        while i < n:
            j = i + 1
            while j < n and bucket[j][1] == bucket[i][1]:
                j += 1
            c = bucket[i]
            if (j - i == 1 and len(c[4]) == 1 and len(c[7]) == 1
                    and len(c[10]) == 1):
                run.append(c)
            else:
                flush_run()
                writer.write_site(_dedupe_site(bucket[i:j]), self._config)
            i = j
        flush_run()

    @staticmethod
    def _tuple_at(contig, k, pos, refs, alts, pg, depth, freq, gt_prob,
                  nap, rep, preds):
        g = int(pg[k])
        return (contig, int(pos[k]), int(pos[k]) + len(refs[k]), refs[k],
                [alts[k]], list(ColumnarDv._GT_TAB[g]), int(depth[k]),
                [int(freq[k])], float(gt_prob[k]), list(preds[k]),
                [float(nap[k])], bool(rep[k]))

    def _write_columnar(self, blocks: list) -> bool:
        """All-array emission of one interval's bucket into the native
        sink. Positions carrying a single candidate (the overwhelming
        majority) go down the columnar C++ fast path in maximal runs;
        positions with multiple candidate rows (~1% — genuine
        multiallelic sites) are expanded to tuples for the shared
        per-site renderer, interleaved in position order so the output
        bytes match the per-site loop exactly. (The old implementation
        fell back to full tuple expansion whenever ANY duplicate existed
        — a 1% exception that pushed ~100% of rows through the slow
        path, the bulk of the unattributed r4 stream cost.)"""
        if len(blocks) == 1:
            b = blocks[0]
            pos, refs, alts = b.pos, b.ref, b.alts
            pg, depth, freq = b.pg, b.depth, b.freq
            gt_prob, nap, rep, preds = b.gt_prob, b.nap, b.rep, b.preds
        else:
            pos = np.concatenate([b.pos for b in blocks])
            order = np.argsort(pos, kind="stable").tolist()
            refs_c = [s for b in blocks for s in b.ref]
            alts_c = [s for b in blocks for s in b.alts]
            refs = [refs_c[k] for k in order]
            alts = [alts_c[k] for k in order]
            pos = pos[order]
            pg = np.concatenate([b.pg for b in blocks])[order]
            depth = np.concatenate([b.depth for b in blocks])[order]
            freq = np.concatenate([b.freq for b in blocks])[order]
            gt_prob = np.concatenate([b.gt_prob for b in blocks])[order]
            nap = np.concatenate([b.nap for b in blocks])[order]
            rep = np.concatenate([b.rep for b in blocks])[order]
            preds = np.concatenate([b.preds for b in blocks])[order]
        contig = blocks[0].contig
        n = len(pos)
        if n == 0:
            return True
        same = pos[1:] == pos[:-1] if n > 1 else np.zeros(0, bool)
        if not same.any():
            self.writer.write_sites_batch(contig, pos, refs, alts, pg,
                                          depth, freq, gt_prob, nap, rep)
            return True
        # rows that share their position with a neighbour form
        # multi-candidate sites; everything else batches natively
        in_dup = np.concatenate((same, [False])) \
            | np.concatenate(([False], same))
        writer = self.writer
        i = 0
        while i < n:
            if not in_dup[i]:
                j = i
                while j < n and not in_dup[j]:
                    j += 1
                writer.write_sites_batch(
                    contig, pos[i:j], refs[i:j], alts[i:j], pg[i:j],
                    depth[i:j], freq[i:j], gt_prob[i:j], nap[i:j],
                    rep[i:j])
            else:
                j = i + 1
                while j < n and pos[j] == pos[i]:
                    j += 1
                site = [self._tuple_at(contig, k, pos, refs, alts, pg,
                                       depth, freq, gt_prob, nap, rep,
                                       preds) for k in range(i, j)]
                writer.write_site(_dedupe_site(site), self._config)
            i = j
        return True

    def advance(self) -> None:
        # _write_batched/_write_columnar assume candidate_list_to_variant's
        # single-candidate fast path, valid only for allowed_multiallelics
        # >= 1 (all presets use 4; 0 drops every site in the Python engine)
        batched = (hasattr(self.writer, "write_sites_batch")
                   and (self._config.allowed_multiallelics or 0) >= 1)
        while self._head < self._n:
            with self._lock:
                if not self._is_final(self._head):
                    return
                head = self._head
                self._head += 1
            bucket = self._buckets.pop(head, None)
            if not bucket:
                continue
            if batched and all(isinstance(e, ColumnarDv) for e in bucket):
                if self._write_columnar(bucket):
                    continue
            # mixed/tuple path: expand columnar blocks to classic tuples
            expanded: list = []
            for e in bucket:
                expanded.extend(e.tuples() if isinstance(e, ColumnarDv)
                                else [e])
            bucket = expanded
            bucket.sort(key=lambda c: c[1])  # stable: arrival order kept
            if batched:
                self._write_batched(bucket)
                continue
            i = 0
            while i < len(bucket):
                j = i + 1
                while j < len(bucket) and bucket[j][1] == bucket[i][1]:
                    j += 1
                self.writer.write_site(_dedupe_site(bucket[i:j]),
                                       self._config)
                i = j

    def finish(self):
        self.advance()
        if self._head != self._n:
            missing = [i for i in range(self._n) if not self._is_final(i)]
            raise RuntimeError(
                f"streamed VCF emission incomplete: intervals {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''} never finalized")
        assert not self._buckets, "candidates bucketed past the last interval"
        self.writer.close()
        return self.writer.totals, self.writer.paths

    def abort(self) -> None:
        """Failure path: delete the 5 partial VCF outputs so a crashed
        stream never leaves plausible-looking but corrupt artifacts."""
        self.writer.abort()


class StreamingCandidateCollector:
    """Stage-3 consumer running concurrently with the fused stage 1+2
    stream: prediction batches are pushed as the streamer flushes them and
    the candidate gates run on a worker thread while the chip and the
    encode threads keep working — removing the stage-2 -> stage-3 barrier
    that the reference's post-hoc pool has
    (FindCandidates.py:156-190). finish() joins and returns the lists.

    With `ordered_emitter` set (single-host streams), final VCF records are
    also written behind the device as the interval watermark advances —
    stage 3 has no tail left beyond the last flush."""

    def __init__(self, config: PipelineConfig,
                 ordered_emitter: Optional[_OrderedEmitter] = None):
        import queue as _queue
        import threading
        self._config = config
        self._queue: "_queue.Queue" = _queue.Queue(maxsize=8)
        self._margin: list = []
        self._dv: list = []
        self._emitter = ordered_emitter
        self._error: List[BaseException] = []
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            fasta = FastaReader(self._config.fasta)
            span = _ContigSpanCache(fasta)
            while True:
                item = self._queue.get()
                if item is None or self._stop:
                    break
                batch, runs = item
                from pepper_tpu_torch.utils import streamstats
                stats = streamstats.CURRENT
                if self._emitter is not None:
                    # ordered mode: records are written behind the device
                    # and finish()'s lists go unused — keep only the
                    # per-batch slice alive, not the whole genome's.
                    # With the native sink, candidates stay columnar
                    # (ColumnarDv) from the gates to the C++ writer.
                    margin_batch: list = []
                    dv_batch: list = []
                    # the columnar/batched lanes assume the
                    # single-candidate semantics of
                    # candidate_list_to_variant, which only hold when
                    # allowed_multiallelics >= 1 (with 0 the Python
                    # engine drops every site) — fall back to per-site
                    # tuples otherwise
                    use_columnar = (
                        hasattr(self._emitter.writer, "write_sites_batch")
                        and (self._config.allowed_multiallelics or 0) >= 1)
                    with stats.span("gates", cpu=True):
                        batch_candidates(
                            self._config, span, *batch, margin_batch,
                            dv_batch,
                            columnar_out=dv_batch if use_columnar else None)
                    with stats.span("vcf_emit", cpu=True):
                        self._emitter.gated(dv_batch, runs)
                else:
                    with stats.span("gates", cpu=True):
                        batch_candidates(self._config, span, *batch,
                                         self._margin, self._dv)
            fasta.close()
        except BaseException as exc:
            self._error.append(exc)
            # unblock any producer stuck in a full-queue put: once _error
            # is set, add()'s timeout loop surfaces it — but only after
            # its pending put stops blocking, so drain what's left
            try:
                while True:
                    self._queue.get_nowait()
            except Exception:
                pass

    def note_interval(self, idx: int, n_rows: int) -> None:
        if self._emitter is not None:
            self._emitter.note_interval(idx, n_rows)

    def _checked_put(self, item) -> None:
        """Timeout-put that rechecks _error: a dead collector thread with a
        full queue must surface its failure, never hang the flusher."""
        import queue as _queue
        while True:
            if self._error:
                raise RuntimeError("candidate collector failed") \
                    from self._error[0]
            try:
                self._queue.put(item, timeout=0.5)
                return
            except _queue.Full:
                continue

    def add(self, contigs, positions, depths, cand_lists, freq_lists,
            preds, runs=()) -> None:
        self._checked_put(((contigs, positions, depths, cand_lists,
                            freq_lists, preds), runs))

    def finish(self):
        self._checked_put(None)
        self._thread.join()
        if self._error:
            raise RuntimeError("candidate collector failed") \
                from self._error[0]
        return self._margin, self._dv

    def abort(self) -> None:
        """Error path: stop the gate thread and wait it out, so nothing
        is feeding the emitter/writer when the caller aborts them. The
        backlog is discarded (the _stop flag short-circuits the loop)."""
        import queue as _queue
        self._stop = True
        while self._thread.is_alive():
            try:
                self._queue.put(None, timeout=0.2)
                break
            except _queue.Full:
                try:   # make room: the backlog is dead weight now
                    self._queue.get_nowait()
                except _queue.Empty:
                    pass
        self._thread.join(timeout=60)


def make_ordered_emitter(config: PipelineConfig, output_dir: str,
                         intervals) -> _OrderedEmitter:
    """Ordered-emission VCF writer for single-host streamed runs;
    `intervals` must be (contig, start)-sorted (lexicographic).

    Uses the native 5-file sink (io/vcf_native.py, byte-identical to the
    Python engine) when the native library is available — stage 3's VCF
    emission then formats/compresses/indexes in C++. PEPPER_TPU_NATIVE_VCF=0
    forces the Python engine."""
    os.makedirs(output_dir, exist_ok=True)
    with FastaReader(config.fasta) as fa:
        fasta_contigs = [(name, fa.get_chromosome_sequence_length(name))
                         for name in fa.get_chromosome_names()]
    out = output_dir if output_dir.endswith("/") else output_dir + "/"
    writer = None
    if os.environ.get("PEPPER_TPU_NATIVE_VCF", "1") != "0":
        from pepper_tpu_torch.io.vcf_native import (NativeVCFWriteEngine,
                                              native_vcf_available)
        if native_vcf_available():
            writer = NativeVCFWriteEngine(fasta_contigs, config.sample_name,
                                          out, config)
    if writer is None:
        writer = VCFWriteEngine(fasta_contigs, config.sample_name, out)
    return _OrderedEmitter(writer, config, intervals)


def log_candidate_totals(totals, t0: float) -> None:
    """The reference's stage-3 telemetry lines (FindCandidates.py:185-190)."""
    _log(f"TOTAL CANDIDATES FOUND: {totals[0]}")
    _log(f"TOTAL VARIANTS IN PEPPER: {totals[1]}")
    _log(f"TOTAL VARIANTS SELECTED FOR RE-GENOTYPING: {totals[2]}")
    _log(f"TOTAL SNP VARIANTS SELECTED FOR RE-GENOTYPING: {totals[3]}")
    _log(f"TOTAL INDEL VARIANTS SELECTED FOR RE-GENOTYPING: {totals[4]}")
    _log(f"TOTAL TIME SPENT ON CANDIDATE FINDING: {time.time() - t0:.1f}s")


def _chunks(pairs: List, size: int) -> List[List]:
    return [pairs[i:i + size] for i in range(0, len(pairs), size)]


def collect_candidate_lists(config: PipelineConfig,
                            pairs: List[Tuple[str, str]]):
    """Raw (margin, dv) candidate lists over (file, batch) pairs, fanned out
    over the process pool (CandidateFinder.find_candidates:532-547)."""
    margin_all, dv_all = [], []
    # the pool pays spawn + result-pickling costs; below ~4 batches per
    # worker a single pass through the (already vectorized) loop is faster.
    # spawn (not fork!): in staged call_variant runs this executes AFTER
    # device inference initialized JAX, and forking a process that holds
    # live JAX/XLA runtime state deadlocks (same class of bug round 2
    # flagged for image-gen) — spawn starts clean interpreters
    if config.threads > 1 and len(pairs) >= 4 * config.threads:
        import multiprocessing
        chunk_size = max(2, len(pairs) // config.threads + 1)
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=config.threads,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(small_chunk_stitch, config, c)
                       for c in _chunks(pairs, chunk_size)]
            for fut in concurrent.futures.as_completed(futures):
                exc = fut.exception()
                if exc is not None:
                    raise RuntimeError(
                        f"candidate-finding shard failed: {exc}") from exc
                m, d = fut.result()
                margin_all.extend(m)
                dv_all.extend(d)
    else:
        margin_all, dv_all = small_chunk_stitch(config, pairs)
    return margin_all, dv_all


def aggregate_candidates(margin_all: list, dv_all: list):
    """Global sort + positional de-dup into per-site dicts
    (CandidateFinder.find_candidates:548-581). Input list order only needs
    to be stable within a (contig, position) key — each key is produced by
    exactly one batch, so any concatenation of per-worker/per-host shard
    lists aggregates identically."""
    from operator import itemgetter
    key01 = itemgetter(0, 1)
    margin_all = sorted(margin_all, key=key01)
    dv_all = sorted(dv_all, key=key01)

    margin_dict = defaultdict(list)
    margin_alts = defaultdict(list)
    for cand in margin_all:
        key, pair = (cand[0], cand[1]), (cand[3], cand[4][0])
        if pair in margin_alts[key]:
            continue
        margin_alts[key].append(pair)
        margin_dict[key].append(cand)

    contigs = []
    dv_dict = defaultdict(list)
    dv_alts = defaultdict(list)
    for cand in dv_all:
        if cand[0] not in contigs:
            contigs.append(cand[0])
        key, pair = (cand[0], cand[1]), (cand[3], cand[4][0])
        if pair in dv_alts[key]:
            continue
        dv_alts[key].append(pair)
        dv_dict[key].append(cand)
    return contigs, margin_dict, dv_dict


def find_candidates(config: PipelineConfig, prediction_files: List[str]):
    """Single-host aggregation (CandidateFinder.find_candidates:532-581)."""
    pairs = list(iter_prediction_batches(prediction_files))
    margin_all, dv_all = collect_candidate_lists(config, pairs)
    return aggregate_candidates(margin_all, dv_all)


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def finalize_candidates(config: PipelineConfig, output_dir: str,
                        margin_all: list, dv_all: list,
                        t0: float) -> Dict[str, str]:
    """Gather across hosts, aggregate, write the 5-VCF set (host 0 only).
    Shared tail of the staged stage-3 driver and the streamed collector
    path (FindCandidates.candidate_finder + VcfWriter)."""
    from pepper_tpu_torch.parallel import multihost

    os.makedirs(output_dir, exist_ok=True)
    gathered = multihost.gather_candidate_lists(output_dir, margin_all,
                                                dv_all)
    if gathered is None:  # non-zero host: shard shipped, host 0 writes VCFs
        _log(f"HOST {multihost.host_index()}: CANDIDATE SHARD COMPLETE "
             f"[{time.time() - t0:.1f}s]")
        return {}
    contigs, _margin, dv_candidates = aggregate_candidates(*gathered)

    with FastaReader(config.fasta) as fa:
        fasta_contigs = [(name, fa.get_chromosome_sequence_length(name))
                         for name in fa.get_chromosome_names()]
    writer = VCFWriteEngine(fasta_contigs, config.sample_name,
                            output_dir if output_dir.endswith("/")
                            else output_dir + "/")
    totals = writer.write_vcf_records(dv_candidates, config)
    writer.close()
    log_candidate_totals(totals, t0)
    return writer.paths


def process_candidates(config: PipelineConfig, input_dir: str,
                       output_dir: str,
                       shard_batches_by_host: bool = False) -> Dict[str, str]:
    """Stage-3 driver (FindCandidates.candidate_finder). Returns VCF paths.

    Multi-host: every host selects candidates over its shard of prediction
    batches; the lists are gathered through the shared output dir
    (multihost.gather_candidate_lists — the pipeline's one sync point) and
    host 0 assembles the global 5-VCF set. Non-zero hosts return {}.

    shard_batches_by_host: stripe (file, batch) pairs across hosts — for
    standalone runs on a shared prediction dir. Inside call_variant each
    host's input_dir already holds only its own predictions."""
    from pepper_tpu_torch.parallel import multihost

    multihost.initialize_from_config(config)
    os.makedirs(output_dir, exist_ok=True)
    prediction_files = image_files(input_dir) or sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.endswith("hdf"))
    t0 = time.time()
    _log("STARTING CANDIDATE FINDING.")
    pairs = list(iter_prediction_batches(prediction_files))
    if shard_batches_by_host and multihost.host_count() > 1:
        pairs = multihost.host_shard(pairs)
        _log(f"HOST {multihost.host_index()}/{multihost.host_count()}: "
             f"{len(pairs)} PREDICTION BATCHES IN SHARD")
    margin_all, dv_all = collect_candidate_lists(config, pairs)
    return finalize_candidates(config, output_dir, margin_all, dv_all, t0)
