"""The port's legacy candidate finders (pipelines/candidate_finder_legacy.py)
against the JAX package's: each case of tests/test_candidate_finder_legacy.py
runs through both packages on the same reads and predictions, and every
field of every record and candidate must be equal."""
import dataclasses

import pytest

from pepper_tpu.io import bam_reader as jax_bam_reader
from pepper_tpu.pipelines import candidate_finder_legacy as jax_finder
from pepper_tpu_torch.io import bam_reader
from pepper_tpu_torch.io.sam import OP_D, OP_I, OP_M
from pepper_tpu_torch.pipelines import candidate_finder_legacy as finder
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

REF = "ACGTACGTACGTACGTACGT"  # 20 bp, ref_start == region_start == 0
PACKAGES = {"torch": (finder, bam_reader.TrimmedRead),
            "jax": (jax_finder, jax_bam_reader.TrimmedRead)}


def plain(value):
    """Records, candidates and alleles as nested dicts (field by field)."""
    if dataclasses.is_dataclass(value):
        return {f.name: plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


class Case:
    """One package's finder module and read type, with the read helpers of
    tests/test_candidate_finder_legacy.py."""

    def __init__(self, pkg):
        self.m, self._read = PACKAGES[pkg]

    def read(self, pos, seq, cigar, name="r"):
        return self._read(query_name=name, pos=pos, pos_end=pos + len(seq),
                          sequence=seq, base_qualities=[30] * len(seq),
                          cigar_tuples=cigar, mapping_quality=60, flags=0,
                          hp_tag=0, bad_indices=[])

    def wt(self, n, prefix="w"):
        return [self.read(0, REF, [(OP_M, 20)], name=f"{prefix}{k}")
                for k in range(n)]

    def snp_reads(self, n, pos=5, alt="T"):
        seq = REF[:pos] + alt + REF[pos + 1:]
        return [self.read(0, seq, [(OP_M, 20)], name=f"s{k}")
                for k in range(n)]

    def ins_reads(self, n):
        return [self.read(0, REF[:10] + "GG" + REF[10:],
                          [(OP_M, 10), (OP_I, 2), (OP_M, 10)], name=f"i{k}")
                for k in range(n)]

    def del_reads(self, n):
        return [self.read(0, REF[:10] + REF[12:],
                          [(OP_M, 10), (OP_D, 2), (OP_M, 8)], name=f"d{k}")
                for k in range(n)]

    def finder(self):
        return self.m.LegacyCandidateFinder(REF, "chr1", 0, 19, 0, 20)

    def hp_finder(self):
        return self.m.LegacyCandidateFinderHP(REF, "chr1", 0, 19, 0, 20)

    def label(self, pair):
        return self.m.DECODED_BASE_LABELS.index(pair)


def hot_predictions(positions, hot=None, indices=None):
    """5-class count vectors per (position, index); `hot` maps (position,
    index) -> (winning base index, count)."""
    indices = indices or [0] * len(positions)
    h = []
    for key in zip(positions, indices):
        v = [1] * 5
        if hot and key in hot:
            idx, count = hot[key]
            v[idx] = count
        h.append(v)
    return h, [list(v) for v in h]


# ------------------------------------------------------------ the cases
def consensus_snp_and_last_position(c):
    tail = [c.read(0, REF[:19] + "A", [(OP_M, 20)], name=f"t{k}")
            for k in range(4)]
    reads = c.snp_reads(4) + c.wt(1) + tail
    return c.finder().find_candidates_consensus(reads, 0.4, 0.5, 0.5)


def consensus_indel_frequencies(c):
    reads = c.ins_reads(3) + c.del_reads(3) + c.wt(3)
    return [c.finder().find_candidates_consensus(reads, 2.0, f, f)
            for f in (0.3, 0.9)]


def snp_branch_no_freq_gate(c):
    label = c.label("CT")
    predictions = [[0.0] * 28]
    predictions[0][label] = 0.9
    return c.finder().find_candidates(c.snp_reads(1) + c.wt(1), [5],
                                      predictions, [label])


def snp_not_in_prediction_pair(c):
    label = c.label("AA")
    predictions = [[0.0] * 28]
    predictions[0][label] = 0.8
    return c.finder().find_candidates(c.snp_reads(3), [5], predictions,
                                      [label])


def anchor_base_before_indel(c):
    r = c.read(0, REF[:9] + "A" + "GG" + REF[10:],
               [(OP_M, 10), (OP_I, 2), (OP_M, 10)])
    return c.finder().find_candidates([r], [9], [[0.0] * 28], [0])


def genotype_helpers(c):
    m = c.m
    return ([m.get_genotype(t) for t in ("RR", "RA", "AA", "AC", "**")],
            [m.get_genotype_from_base("C", a, b) for a, b in
             (("R", "R"), ("R", "T"), ("T", "T"), ("A", "T"), ("C", "*"))],
            [m.get_index_from_base(b) for b in "*ACGTN"])


def hp_snp_scored(c):
    positions = list(range(20))
    h1, h2 = hot_predictions(positions, {(5, 0): (4, 96)})
    return c.hp_finder().find_candidates(c.snp_reads(5) + c.wt(1),
                                         positions, [0] * 20, h1, h2)


def hp_freq_gate_truncates(c):
    positions = list(range(20))
    h1, h2 = hot_predictions(positions, {(5, 0): (4, 96)})
    return c.hp_finder().find_candidates(c.snp_reads(2) + c.wt(50),
                                         positions, [0] * 20, h1, h2)


def hp_freq_based(c):
    positions = list(range(20))
    h1, h2 = hot_predictions(positions)
    reads = c.snp_reads(3) + c.wt(1)
    return [c.hp_finder().find_candidates(reads, positions, [0] * 20, h1,
                                          h2, freq_based=True, freq=f)
            for f in (0.5, 0.9)]


def hp_delete_scoring(c):
    positions = list(range(20))
    h1, h2 = hot_predictions(positions, {(10, 0): (0, 96),
                                         (11, 0): (0, 96)})
    return c.hp_finder().find_candidates(c.del_reads(3) + c.wt(2),
                                         positions, [0] * 20, h1, h2)


def hp_insert_scoring(c):
    positions = list(range(10)) + [9, 9] + list(range(10, 20))
    indices = [0] * 10 + [1, 2] + [0] * 10
    g = c.m.get_index_from_base("G")
    h1, h2 = hot_predictions(positions, {(9, 1): (g, 96), (9, 2): (g, 96)},
                             indices)
    return c.hp_finder().find_candidates(c.ins_reads(3) + c.wt(2),
                                         positions, indices, h1, h2)


CASES = [consensus_snp_and_last_position, consensus_indel_frequencies,
         snp_branch_no_freq_gate, snp_not_in_prediction_pair,
         anchor_base_before_indel, genotype_helpers, hp_snp_scored,
         hp_freq_gate_truncates, hp_freq_based, hp_delete_scoring,
         hp_insert_scoring]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__ for f in CASES])
def test_finder_case_matches_jax(case):
    assert plain(case(Case("torch"))) == plain(case(Case("jax")))


def test_expected_outcomes_on_the_port():
    """The outcomes tests/test_candidate_finder_legacy.py asserts, on the
    port's side (the parity test above holds JAX's to the same)."""
    c = Case("torch")
    positions = consensus_snp_and_last_position(c)
    assert 5 in positions and 19 not in positions       # scan gap quirk
    lo, hi = consensus_indel_frequencies(c)
    assert 9 in lo and 9 not in hi
    (rec,) = [r for r in snp_branch_no_freq_gate(c) if r.pos_start == 5]
    (cand,) = rec.candidates
    assert (cand.allele.alt, cand.genotype, cand.read_support,
            cand.depth) == ("T", 1, 1, 2)
    assert cand.allele_probability == pytest.approx(0.9)
    (cand,) = [x for r in hp_snp_scored(c) for x in r.candidates]
    assert cand.alt_prob_h1 == pytest.approx(0.96)
    assert cand.non_ref_prob == pytest.approx(0.99)
    assert [x for r in hp_freq_gate_truncates(c) for x in r.candidates] == []
    loose, strict = hp_freq_based(c)
    assert len([x for r in loose for x in r.candidates]) == 1
    assert [x for r in strict for x in r.candidates] == []
    (dele,) = [x for r in hp_delete_scoring(c) for x in r.candidates
               if x.allele.alt_type == finder.DELETE_ALLELE]
    assert dele.allele.ref == REF[9:12] and dele.alt_prob_h1 > 0.8
    (ins,) = [x for r in hp_insert_scoring(c) for x in r.candidates
              if x.allele.alt_type == finder.INSERT_ALLELE]
    assert ins.allele.alt == REF[9] + "GG" and ins.alt_prob_h1 > 0.8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("legacy_finder")
    genome = random_genome(4000, seed=11)
    variants = plant_variants(dict(genome), n_snp=3, n_ins=0, n_del=0,
                              seed=12)
    fasta, bam = write_dataset(str(tmp), genome, simulate_reads(
        genome, variants, coverage=30, seed=13, error_rate=0.0))
    hom = [v for v in variants if v.genotype == (1, 1) and v.kind == "snp"]
    assert hom, "need at least one hom-alt SNP planted"
    return dict(fasta=fasta, bam=bam, contig=genome[0][0], variant=hom[0])


@pytest.mark.parametrize("hp_mode", [False, True])
def test_wrapper_end_to_end_matches_jax(dataset, hp_mode):
    """CandidateFinderCPP over a BAM and FASTA: the non-HP finder with a
    28-class prediction map calling the planted hom-alt SNP, and the HP
    finder with 5-class vote vectors, in both packages."""
    v = dataset["variant"]
    start, end = max(0, v.pos - 50), v.pos + 50
    positions = list(range(start, end))
    results = []
    for m in (finder, jax_finder):
        cf = m.CandidateFinderCPP(dataset["contig"], start, end)
        args = (dataset["bam"], dataset["fasta"], dataset["contig"], start,
                end)
        if hp_mode:
            alt = m.get_index_from_base(v.alt)
            h1, h2 = hot_predictions(positions, {(v.pos, 0): (alt, 96)})
            out = cf.find_candidates_hp(*args, positions, [0] * len(h1), h1,
                                        h2, False, 0.0)
        else:
            label = m.DECODED_BASE_LABELS.index(v.alt + v.alt)
            predictions = [[0.0] * 28 for _ in positions]
            labels = [label if p == v.pos else 0 for p in positions]
            for p, vec in zip(positions, predictions):
                vec[labels[p - start]] = 0.95 if p == v.pos else 0.99
            out = cf.find_candidates(*args, positions, predictions, labels,
                                     False, 0.0)
        results.append(plain(out))
    assert results[0] == results[1]
    called = [c for lst in results[0].values() for c in lst
              if c["pos"] == v.pos and c["allele"]["alt"] == v.alt]
    assert len(called) == 1
    if not hp_mode:
        assert called[0]["genotype"] == 2   # hom-alt
