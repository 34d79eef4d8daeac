"""Stage 3's one-allele lane (`pipelines/find_candidates.py::
batch_candidates`), which decides each distinct allele once and indexes the
decision per row, against the scalar loop (`_FORCE_LOOP`) on seeded
batches: the same margin and DeepVariant tuples, the same columnar blocks,
and the same bytes in the five VCFs the ordered emitter writes.

The batches hold repeated alleles (one shared tuple per allele, as the
stream carries them, or a fresh list per row, as the resume journal and the
prediction HDF5 give them back), multi-letter insertions and deletions, N
and IUPAC bodies, deletions that swap REF and ALT, rows in homopolymer
repeats, reference N bases, zero depths, frequency overrides, unknown type
codes and sites with several candidate rows.
"""
import gzip
import os

import numpy as np
import pytest

from pepper_tpu_torch.io.fasta import FastaReader, write_fasta
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines import find_candidates as fc
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.utils.synth import random_genome

ALLELES = ["1A", "1C", "1G", "1T", "2AT", "2ACGTT", "2AN", "2AR", "3AA",
           "3ACTGA", "3AN", "3AY", "1N", "1R", "0A", "4T", "1", "2"]
CONTIG_LEN = 4000
INTERVAL = 1000


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage3_lane")
    contigs = []
    for k, (name, seq) in enumerate((("chr1", None), ("chr2", None))):
        seq = list(random_genome(CONTIG_LEN, seed=11 + k)[0][1])
        for start in range(100, CONTIG_LEN - 100, 300):   # repeats
            seq[start:start + 7] = "T" * 7
        for start in range(250, CONTIG_LEN - 100, 500):   # reference N
            seq[start] = "N"
        contigs.append((name, "".join(seq)))
    path = str(tmp / "ref.fa")
    write_fasta(path, contigs)
    return path


def _config(fasta, out_dir=""):
    config = set_parameters(PipelineConfig(
        fasta=fasta, output_dir=out_dir, sub_command="call_variant",
        ont_r9_guppy5_sup=True))
    config.report_snp_above_freq = 0.2       # exercise the freq overrides
    config.report_indel_above_freq = 0.15
    return config


def _batch(rng, n, contig_names, lo, hi, form):
    """n rows over the contig runs `contig_names` (each a contiguous run,
    positions ascending in [lo, hi) with repeats), alleles drawn with
    repetition; `form` is "tuples" (one shared tuple per allele) or
    "lists" (a fresh list per row)."""
    shared = {a: (a,) for a in ALLELES}
    cut = np.sort(rng.integers(0, n + 1, len(contig_names) - 1))
    bounds = [0, *cut.tolist(), n]
    contigs, positions = [], []
    for name, a, b in zip(contig_names, bounds[:-1], bounds[1:]):
        contigs += [name] * (b - a)
        positions += np.sort(rng.integers(lo, hi, b - a)).tolist()
    picks = rng.integers(0, len(ALLELES), n).tolist()
    cands = [shared[ALLELES[k]] if form == "tuples" else [ALLELES[k]]
             for k in picks]
    depths = rng.integers(0, 50, n)
    depths[rng.random(n) < 0.05] = 0
    freqs = np.array([int(rng.integers(0, max(1, d) + 1)) for d in depths],
                     np.int64)
    preds = rng.random((n, 3)) ** 3
    preds /= preds.sum(axis=1, keepdims=True)
    return contigs, np.asarray(positions, np.int64), depths, cands, freqs, \
        preds


def _gate(config, fasta, batch, forced, columnar=False):
    margin, dv, blocks = [], [], []
    fc._FORCE_LOOP = forced
    try:
        with FastaReader(fasta) as fa:
            fc.batch_candidates(config, fc._ContigSpanCache(fa), *batch,
                                margin, dv,
                                columnar_out=blocks if columnar else None)
    finally:
        fc._FORCE_LOOP = False
    return margin, dv, blocks


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("form", ["tuples", "lists"])
@pytest.mark.parametrize("contig_names", [["chr1"], ["chr1", "chr2"]])
def test_one_allele_lane_gives_the_loops_tuples(reference, seed, form,
                                                contig_names):
    rng = np.random.default_rng(seed)
    batch = _batch(rng, 700, contig_names, 10, CONTIG_LEN - 10, form)
    config = _config(reference)
    fast = _gate(config, reference, batch, forced=False)
    slow = _gate(config, reference, batch, forced=True)
    assert fast[0] == slow[0]
    assert fast[1] == slow[1]
    assert fast[0] and fast[1], "the batch should pass both gates"
    dv = fast[1]
    # deletions that passed their p-value gate swap REF and ALT
    assert any(len(c[3]) > 1 and len(c[4][0]) == 1 for c in dv)
    assert any(c[11] for c in dv), "rows in repeats should pass"
    # a frequency flat array and per-row lists decide alike
    flat = batch[:4] + ([[int(f)] for f in batch[4]],) + batch[5:]
    assert _gate(config, reference, flat, forced=False)[:2] == fast[:2]


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("contig_names", [["chr2"], ["chr1", "chr2"]])
def test_one_allele_lane_gives_the_loops_columnar_blocks(reference, seed,
                                                         contig_names):
    rng = np.random.default_rng(seed)
    batch = _batch(rng, 700, contig_names, 10, CONTIG_LEN - 10, "tuples")
    config = _config(reference)
    margin, dv, blocks = _gate(config, reference, batch, forced=False,
                               columnar=True)
    assert not margin and not dv
    assert [b.contig for b in blocks] == [
        c for c in contig_names if c in batch[0]]
    for b in blocks:
        assert isinstance(b.ref, list) and isinstance(b.alts, list)
        assert (np.diff(b.pos) >= 0).all()
    got = [t for b in blocks for t in b.tuples()]
    want = _gate(config, reference, batch, forced=True)[1]
    assert got == want and want


def _stream_vcfs(config, reference, forced, seed):
    """Stage 3 as call_variant runs it behind the stream: every interval's
    rows as one batch through the gate thread and the ordered emitter
    (the native sink where it builds); the five VCFs' bytes by name."""
    os.makedirs(config.output_dir, exist_ok=True)
    intervals = [(c, s, s + INTERVAL) for c in ("chr1", "chr2")
                 for s in range(0, CONTIG_LEN, INTERVAL)]
    rng = np.random.default_rng(seed)
    emitter = fc.make_ordered_emitter(config, config.output_dir, intervals)
    collector = fc.StreamingCandidateCollector(config, emitter)
    fc._FORCE_LOOP = forced
    try:
        for idx, (contig, start, end) in enumerate(intervals):
            batch = _batch(rng, 150, [contig], max(start, 10),
                           min(end, CONTIG_LEN - 10), "tuples")
            collector.note_interval(idx, len(batch[0]))
            collector.add(*batch, runs=[(idx, len(batch[0]))])
        collector.finish()
        emitter.finish()
    finally:
        fc._FORCE_LOOP = False
    out = {}
    for name in sorted(os.listdir(config.output_dir)):
        if name.endswith(".vcf.gz"):
            with open(os.path.join(config.output_dir, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("seed", [6, 7])
def test_one_allele_lane_writes_the_loops_vcf_bytes(reference, tmp_path,
                                                    seed):
    fast = _stream_vcfs(_config(reference, str(tmp_path / "fast")),
                        reference, False, seed)
    slow = _stream_vcfs(_config(reference, str(tmp_path / "slow")),
                        reference, True, seed)
    assert len(fast) == 5 and fast.keys() == slow.keys()
    for name in fast:
        assert fast[name] == slow[name], name
    records = [l for l in gzip.decompress(
        fast["PEPPER_VARIANT_FULL.vcf.gz"]).decode().splitlines()
        if not l.startswith("#")]
    assert len(records) > 50


class _Fasta:
    def __init__(self, seq):
        self.seq = seq

    def get_reference_sequence(self, contig, lo, hi):
        return self.seq[lo:hi]


def _runs_of_five(arr, lo, hi):
    """Whether a position in [lo, hi) of arr sits in a run of at least 5
    equal bases, from the run lengths."""
    starts = np.flatnonzero(np.concatenate(([True], arr[1:] != arr[:-1])))
    lens = np.diff(np.append(starts, len(arr)))
    cum = np.concatenate(([0], np.cumsum(np.repeat(lens >= 5, lens))))
    return (cum[hi] - cum[lo]) > 0


@pytest.mark.parametrize("seed", [8, 9, 10])
@pytest.mark.parametrize("length", [3, 5, 9, 70000, 70013])
def test_span_repeat_gate_matches_run_lengths(seed, length):
    """The span's repeat gate (runs of five found by 5-base windows) gives
    the run-length computation's answer at every position of the span,
    its edges included, with runs of every length from 1 to 9 and N."""
    rng = np.random.default_rng(seed)
    seq = []
    while len(seq) < length:
        seq += [str(rng.choice(list("ACGTN")))] * int(rng.integers(1, 10))
    seq = "".join(seq[:length])
    span = fc._ContigSpanCache(_Fasta(seq))
    span.load("chr1", 0, length)
    arr = np.frombuffer(seq.encode(), np.uint8)
    pos = np.arange(length)
    refb, in_repeat = span.annotate(pos)
    assert (refb == arr).all()
    want = _runs_of_five(arr, np.clip(pos - 5, 0, length),
                         np.clip(pos + 4, 0, length))
    assert (in_repeat == want).all()
    assert want.any() or length < 10
