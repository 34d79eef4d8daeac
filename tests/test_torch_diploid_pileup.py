"""The port's diploid-label pileup encoder (encode/diploid_pileup.py)
against the JAX package's: each case of tests/test_diploid_pileup.py runs
through both packages on the same reads, and the summaries' images,
labels, positions, coverage and chunked outputs must be equal."""
import pytest

from pepper_tpu.encode import diploid_pileup as jax_dp
from pepper_tpu.io import bam_reader as jax_bam_reader
from pepper_tpu_torch.encode import diploid_pileup as dp
from pepper_tpu_torch.io import bam_reader
from pepper_tpu_torch.io.sam import FLAG_REVERSE, OP_D, OP_I, OP_M, OP_N

PACKAGES = {"torch": (dp, bam_reader.TrimmedRead),
            "jax": (jax_dp, jax_bam_reader.TrimmedRead)}


class Case:
    """One package's encoder module and read type."""

    def __init__(self, pkg):
        self.m, self._read = PACKAGES[pkg]

    def read(self, pos, seq, cigar, reverse=False, name="r"):
        ref_len = sum(n for op, n in cigar if op in (OP_M, OP_D, OP_N))
        return self._read(query_name=name, pos=pos, pos_end=pos + ref_len,
                          sequence=seq, base_qualities=[30] * len(seq),
                          cigar_tuples=list(cigar), mapping_quality=60,
                          flags=FLAG_REVERSE if reverse else 0, hp_tag=0,
                          bad_indices=[])

    def summary(self, ref, start, end):
        return self.m.DiploidPileupSummary(ref, "c1", start, end)


def state(s):
    """Every attribute of a summary (or a chunked output)."""
    return dict(vars(s))


# ------------------------------------------------------------ the cases
def index_tables(c):
    m = c.m
    bases = "ACGT*N#"
    return ([m.get_feature_index(b, r) for b in bases for r in (True, False)],
            [m.get_reference_feature_index(b) for b in bases],
            [m.get_labels(a, b) for a in bases for b in bases],
            [m.check_base(b) for b in ("", "#", "*", "A", "n", "X")])


def pileup_counts_and_image(c):
    ref = "ACGTACGTAC"
    s = c.summary(ref, 0, 9)
    s.generate_summary([c.read(0, ref, [(OP_M, 10)], name="r1"),
                        c.read(0, ref, [(OP_M, 10)], name="r2"),
                        c.read(0, ref, [(OP_M, 10)], reverse=True,
                               name="r3")], 0, 9)
    return state(s)


def insert_and_delete_quirks(c):
    s = c.summary("AAAAAAAAAA", 0, 9)
    s.generate_summary([c.read(0, "AAACCAA" + "AA",
                               [(OP_M, 3), (OP_I, 2), (OP_M, 2), (OP_D, 3),
                                (OP_M, 2)])], 0, 9)
    return state(s)


def ref_skip_falls_through_to_delete(c):
    s = c.summary("ACGTACGT", 0, 7)
    s.generate_summary([c.read(0, "ACGT", [(OP_M, 2), (OP_N, 4),
                                           (OP_M, 2)])], 0, 7)
    return state(s)


def train_labels_diploid(c):
    ref = "ACGTACGTAC"
    s = c.summary(ref, 0, 9)
    s.generate_train_summary([c.read(0, ref, [(OP_M, 10)])], 0, 9,
                             c.read(0, ref, [(OP_M, 10)], name="t1"),
                             c.read(0, "ACGTGCGTAC", [(OP_M, 10)],
                                    name="t2"))
    return state(s)


def train_labels_uncovered_and_bad(c):
    s = c.summary("ACGTACGTAC", 0, 9)
    t = c.read(0, "ACGTACG", [(OP_M, 7)], name="t")
    s.generate_train_summary([c.read(0, "ACGTA", [(OP_M, 5)])], 0, 9, t, t)
    return state(s)


def truth_insert_truncation_and_padding(c):
    s = c.summary("AAAA", 0, 3)
    s.generate_train_summary(
        [c.read(0, "AACCAA", [(OP_M, 2), (OP_I, 2), (OP_M, 2)])], 0, 3,
        c.read(0, "AACCCAA", [(OP_M, 2), (OP_I, 3), (OP_M, 2)], name="t1"),
        c.read(0, "AAGAA", [(OP_M, 2), (OP_I, 1), (OP_M, 2)], name="t2"))
    return state(s)


def chunk_image_inference_padding(c):
    ref = "ACGTACGTAC"
    s = c.summary(ref, 0, 9)
    s.generate_summary([c.read(0, ref, [(OP_M, 10)])], 0, 9)
    short = c.summary("ACG", 0, 2)
    short.generate_summary([c.read(0, "ACG", [(OP_M, 3)])], 0, 2)
    return [state(x.chunk_image(chunk_size=6, chunk_overlap=2,
                                image_height=10)) for x in (s, short)]


def chunk_image_train_segments(c):
    ref = "A" * 20
    s = c.summary(ref, 0, 19)
    t2 = c.read(0, ref, [(OP_M, 20)], name="t2")
    s.generate_train_summary([c.read(0, ref, [(OP_M, 20)])], 0, 19, t2, t2)
    holed = c.summary(ref, 0, 19)
    t = c.read(0, "A" * 10, [(OP_M, 10), (OP_D, 1), (OP_M, 0)], name="t")
    holed.generate_train_summary([c.read(0, ref, [(OP_M, 20)])], 0, 19, t,
                                 t2)
    return [state(x.chunk_image_train(chunk_size=8, chunk_overlap=2,
                                      image_height=10, chunk_id_start=5))
            for x in (s, holed)]


CASES = [index_tables, pileup_counts_and_image, insert_and_delete_quirks,
         ref_skip_falls_through_to_delete, train_labels_diploid,
         train_labels_uncovered_and_bad, truth_insert_truncation_and_padding,
         chunk_image_inference_padding, chunk_image_train_segments]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__ for f in CASES])
def test_diploid_pileup_case_matches_jax(case):
    assert case(Case("torch")) == case(Case("jax"))


def test_expected_outcomes_on_the_port():
    """The outcomes tests/test_diploid_pileup.py asserts, on the port's
    side (the parity test above holds JAX's to the same)."""
    c = Case("torch")
    s = pileup_counts_and_image(c)
    assert s["genomic_pos"] == [(i, 0) for i in range(10)]
    assert s["image"][0][4] == int(2 / 3 * 254)
    s = insert_and_delete_quirks(c)
    assert len(s["genomic_pos"]) == 12 and (2, 2) in s["genomic_pos"]
    assert s["_coverage"][5] == 3.0 and 6 not in s["_coverage"]
    assert train_labels_diploid(c)["labels"][4] == dp.get_labels("A", "G")
    assert train_labels_uncovered_and_bad(c)["bad_label_positions"] == \
        [8, 9, 10, 10]
    s = truth_insert_truncation_and_padding(c)
    assert [s["labels"][s["genomic_pos"].index((1, i))] for i in (1, 2)] \
        == [dp.get_labels("C", "G"), dp.get_labels("C", "*")]
    full, short = chunk_image_inference_padding(c)
    assert full["chunk_ids"] == [0, 1]
    assert short["positions"][0][3:] == [(-1, -1)] * 3
    segments = chunk_image_train_segments(c)[0]
    assert segments["chunk_ids"][0] == 5
    assert all(len(x) == 8 for x in segments["images"])
