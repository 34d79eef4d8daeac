"""The port's native region encoder (pepper_tpu_torch/native/src/
region_encode.cpp) held bit-exact, field by field, against the JAX
package's native encoder (the reference) and against the port's Python
RegionalSummary, on reads like the benchmark's (35x, 10 kb, 8% error) and
on the encoder's edges: reads crossing both ends of an interval, a contig's
two ends, downsampling, train labels, skipped indels, 300x depth, and reads
with indel errors, failing qualities, soft clips, mapq 0 and letters other
than ACGT over a reference holding N."""
import random

import numpy as np
import pytest

from pepper_tpu.native import encoder as jax_encoder
from pepper_tpu_torch.encode.region_encoder import RegionalSummary, TruthRecord
from pepper_tpu_torch.io.bam_reader import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.io.sam import OP_D, OP_I, OP_M, OP_S
from pepper_tpu_torch.io.vcf import get_truth_records
from pepper_tpu_torch.native import encoder
from pepper_tpu_torch.pipelines.make_images import reservoir_downsample
from pepper_tpu_torch.utils.synth import (Variant, plant_variants,
                                          random_genome, simulate_reads_fast,
                                          write_dataset, write_truth_vcf)

CONTIG = 30000
KW = dict(min_snp_baseq=1, min_indel_baseq=1, snp_freq_threshold=0.10,
          insert_freq_threshold=0.10, delete_freq_threshold=0.10,
          min_coverage_threshold=2, snp_candidate_freq_threshold=0.10,
          indel_candidate_freq_threshold=0.10,
          candidate_support_threshold=2, skip_indels=False)


@pytest.fixture(autouse=True)
def _native():
    if not (encoder.available() and jax_encoder.available()):
        pytest.skip("native build failed")


def _indel_errors(rec, rng):
    """The read with random 1-3 base insertions and deletions inside its M
    runs (the CIGAR stays an exact alignment to the reference)."""
    cigar, seq, qual = [], [], []

    def push(op, length, bases="", quals=()):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))
        seq.append(bases)
        qual.extend(quals)
    si = 0
    for op, length in rec.cigar:
        if op != OP_M:
            takes = op in (OP_I, OP_S)
            push(op, length, rec.seq[si:si + length] if takes else "",
                 rec.qual[si:si + length] if takes else ())
            si += length if takes else 0
            continue
        k = 0
        while k < length:
            step = min(length - k, rng.randint(4, 30))
            push(OP_M, step, rec.seq[si + k:si + k + step],
                 rec.qual[si + k:si + k + step])
            k += step
            if k < length - 4 and rng.random() < 0.25:
                n = rng.randint(1, 3)
                push(OP_I, n, "".join(rng.choice("ACGT") for _ in range(n)),
                     [rng.randint(0, 40) for _ in range(n)])
            elif k < length - 4 and rng.random() < 0.25:
                n = rng.randint(1, 3)
                push(OP_D, n)
                k += n
        si += length
    rec.cigar, rec.seq, rec.qual = cigar, "".join(seq), qual


def _edges(records, rng):
    """Indel errors, random qualities, bases other than ACGT (N, the IUPAC
    codes, D among them, and '='), soft clips at either end and mapq 0,
    each on some of the reads."""
    for rec in records:
        _indel_errors(rec, rng)
        if rng.random() < 0.5:
            rec.qual = [rng.randint(0, 40) for _ in rec.seq]
        if rng.random() < 0.3:
            s = list(rec.seq)
            for i in rng.sample(range(len(s)), 40):
                s[i] = rng.choice("NNRDDMWB=")
            rec.seq = "".join(s)
        if rng.random() < 0.2 and rec.cigar[0][0] == OP_M \
                and rec.cigar[0][1] > 60:
            rec.cigar = [(OP_S, 50), (OP_M, rec.cigar[0][1] - 50)] \
                + rec.cigar[1:]
            rec.pos += 50
        if rng.random() < 0.2 and rec.cigar[-1][0] == OP_M \
                and rec.cigar[-1][1] > 60:
            rec.cigar = rec.cigar[:-1] + [(OP_M, rec.cigar[-1][1] - 50),
                                          (OP_S, 50)]
        if rng.random() < 0.15:
            rec.mapq = 0
    records.sort(key=lambda r: (r.ref_id, r.pos))
    return records


def _dataset(tmp, seed, edges, coverage):
    genome = random_genome(2 * CONTIG, seed=seed, n_contigs=2)
    if edges:   # a run of N and a few single ones in the reference
        name, seq = genome[0]
        seq = list(seq)
        seq[9000:9030] = "N" * 30
        for i in (12345, 15000, 15001, 20002):
            seq[i] = "N"
        genome[0] = (name, "".join(seq))
    variants = plant_variants(dict(genome), 48, 6, 6, seed=seed + 1)
    if coverage > 125:   # hom-alt deletions: '*' columns past the int8 range
        name, seq = genome[1]
        deletions = [Variant(name, p, seq[p:p + n + 1], seq[p], (1, 1))
                     for p, n in ((13000, 3), (15000, 2))]
        variants = sorted(
            [v for v in variants if v.contig != name or all(
                abs(v.pos - d.pos) > 30 for d in deletions)] + deletions,
            key=lambda v: (v.contig, v.pos))
    records = simulate_reads_fast(genome, variants, coverage=coverage,
                                  read_length=10000, error_rate=0.08,
                                  seed=seed + 2)
    if edges:
        records = _edges(records, random.Random(seed + 3))
    fasta, bam = write_dataset(tmp, genome, records)
    truth = write_truth_vcf(tmp + "/truth.vcf", genome, variants)
    return dict(fasta=fasta, bam=bam, truth=truth,
                contigs=[name for name, _ in genome])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """get(seed, edges, coverage): one dataset a key, made on first use."""
    made = {}

    def get(seed, edges=False, coverage=35):
        key = (seed, edges, coverage)
        if key not in made:
            tmp = str(tmp_path_factory.mktemp(f"nenc{seed}"))
            made[key] = _dataset(tmp, seed, edges, coverage)
        return made[key]
    return get


def _encode_three_ways(data, contig_no, start, end, train=False,
                       max_reads=5000, skip_indels=False, min_mapq=5,
                       baseq=1):
    """(port native, JAX native, Python oracle) for the interval [start, end]
    of a contig, the region around it as make_images cuts it."""
    contig = data["contigs"][contig_no]
    kw = dict(KW, skip_indels=skip_indels, min_snp_baseq=baseq,
              min_indel_baseq=baseq)
    region_start = max(0, start - 100)
    with BamReader(data["bam"]) as bam, FastaReader(data["fasta"]) as fa:
        region_end = min(end + 100,
                         fa.get_chromosome_sequence_length(contig) - 1)
        fetch_stop = region_end + 1 if train else region_end
        ref_seq = fa.get_reference_sequence(contig, region_start,
                                            region_end + 1)
        hap1, hap2 = [], []
        if train:
            h1, h2 = get_truth_records(data["truth"], contig, region_start,
                                       region_end)
            hap1 = [TruthRecord(*t) for t in h1]
            hap2 = [TruthRecord(*t) for t in h2]
        ref_id = bam._ref_ids[contig]
        chunks = bam._index.chunks_for(ref_id, region_start, fetch_stop)
        args = (data["bam"], chunks, ref_id, contig, region_start,
                fetch_stop, region_start, region_end, ref_seq)
        both = dict(include_supplementary=False, min_mapq=min_mapq,
                    candidate_region_start=start, candidate_region_end=end,
                    train_mode=train, hap1=hap1, hap2=hap2,
                    max_reads=max_reads, **kw)
        port = encoder.encode_region_native(*args, **both)
        ref = jax_encoder.encode_region_native(*args, **both)

        reads = bam.get_reads(contig, region_start, fetch_stop, False,
                              min_mapq, baseq, backend="python")
        reads = reservoir_downsample(reads, 1.0, max_reads)
        summary = RegionalSummary(contig, region_start, region_end, ref_seq)
        if train:
            summary.generate_labels(hap1, hap2)
        oracle = summary.generate_summary(
            reads, candidate_region_start=start, candidate_region_end=end,
            train_mode=train, **kw)
    return port, ref, oracle


FIELDS = ("positions", "depths", "candidate_frequency", "images",
          "base_labels", "type_labels")

CASES = {
    # the benchmark's reads on three genomes, an interval inside a contig
    "traffic_seed1": dict(seed=1, contig_no=0, start=5000, end=24999),
    "traffic_seed2": dict(seed=2, contig_no=1, start=5000, end=24999),
    "traffic_seed3": dict(seed=3, contig_no=0, start=5000, end=24999),
    # every read crosses both ends of a 2 kb interval
    "reads_cross_both_edges": dict(seed=1, contig_no=0, start=14000,
                                   end=15999),
    "contig_start": dict(seed=2, contig_no=1, start=0, end=7999),
    "contig_end": dict(seed=3, contig_no=0, start=CONTIG - 8000,
                       end=CONTIG - 1),
    "downsampled": dict(seed=1, contig_no=1, start=8000, end=20000,
                        max_reads=12),
    "train_labels": dict(seed=2, contig_no=0, start=3000, end=26999,
                         train=True),
    "skip_indels": dict(seed=3, contig_no=1, start=5000, end=24999,
                        skip_indels=True),
    # indel errors, failing qualities, clips, mapq 0, N, IUPAC codes and
    # '=' over N
    "edges": dict(seed=4, edges=True, contig_no=0, start=4000, end=25999,
                  baseq=10, min_mapq=0),
    "edges_train_downsampled": dict(seed=4, edges=True, contig_no=0,
                                    start=8000, end=22999, baseq=10,
                                    min_mapq=0, train=True, max_reads=30),
    # 300x: counts past the int8 range, where the image clamps columns
    # 11-24 and wraps the others, and depths and supports clamp at 125
    "deep": dict(seed=5, coverage=300, contig_no=1, start=12000, end=17999),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_encoder_matches_reference_and_oracle(datasets, case):
    spec = dict(CASES[case])
    data = datasets(spec.pop("seed"), spec.pop("edges", False),
                    spec.pop("coverage", 35))
    port, ref, oracle = _encode_three_ways(data, **spec)
    assert len(port) > 3
    assert port.contig == ref.contig
    assert port.candidates == ref.candidates
    for name in FIELDS:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(oracle) == len(port)
    for a, b in zip(oracle, port):
        assert (a.contig, a.position, a.depth, a.candidates,
                a.candidate_frequency, a.base_label, a.type_label) == \
            (b.contig, b.position, b.depth, b.candidates,
             b.candidate_frequency, b.base_label, b.type_label)
        # the oracle keeps int32 images; the native ones are their int8
        # (numpy astype wrap)
        np.testing.assert_array_equal(np.asarray(a.image).astype(np.int8),
                                      b.image)
    if spec.get("train"):
        assert (port.type_labels > 0).any()
    if spec.get("skip_indels"):
        assert all(c.startswith("1") for c in port.candidates)
    if case.startswith("edges"):
        assert any(c[0] != "1" for c in port.candidates)
    sections = port.sections
    assert set(sections) == set(encoder.SECTIONS)
    assert all(v >= 0 for v in sections.values())


def test_result_views_outlive_nothing_they_borrow(datasets):
    """The arrays are views of the encoder's own result block: writable,
    alive after the batch is dropped, and the block is freed with the last
    of them (a second encode reuses the thread's scratch without touching
    what the first returned)."""
    import gc
    data = datasets(1)
    first, _, _ = _encode_three_ways(data, 0, 5000, 24999)
    images, positions = first.images, first.positions.copy()
    snapshot = images.copy()
    del first
    gc.collect()
    second, _, _ = _encode_three_ways(data, 1, 5000, 24999)
    assert images.flags.writeable and not images.flags.owndata
    np.testing.assert_array_equal(images, snapshot)
    assert len(second) and not np.array_equal(second.positions[:5],
                                              positions[:5])


def test_rows_of_one_allele_share_one_list(datasets):
    """The runner's per-row alleles hold the encoder's candidates, one
    immutable tuple per distinct allele, shared by its rows."""
    from pepper_tpu_torch.runtime.streaming import _batch_fields
    port, _, _ = _encode_three_ways(datasets(1), 0, 5000, 24999)
    contig, positions, depths, rows, freqs, images = _batch_fields(port)
    assert rows == [(c,) for c in port.candidates]
    assert all(type(row) is tuple for row in rows)
    assert len({id(row) for row in rows}) == len(set(port.candidates))
    assert images is port.images and contig == port.contig
    np.testing.assert_array_equal(positions, port.positions)
    np.testing.assert_array_equal(freqs, port.candidate_frequency)
