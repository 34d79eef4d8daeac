"""The port's fused polish encode (native/polish_encoder.py through
polish/make_images.py::create_polish_summaries_multi) against the JAX
package's on the same draft and reads, including intervals that no read
covers, and its handling of a failed native allocation: a NULL result for
an interval of positive length raises MemoryError instead of reading as
"no reads"."""
import ctypes

import numpy as np
import pytest

from pepper_tpu.io.bam_reader import BamReader as JaxBamReader
from pepper_tpu.io.fasta import FastaReader as JaxFastaReader
from pepper_tpu.polish.make_images import \
    create_polish_summaries_multi as jax_multi
from pepper_tpu_torch.io.bam_reader import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.native import polish_encoder
from pepper_tpu_torch.polish.make_images import create_polish_summaries_multi
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads_fast, write_dataset)

LENGTH = 12_000
GAP = (1000, 7000)   # no read starts here: [~5000, 7000) has no coverage
INTERVALS = [(s, min(s + 999, LENGTH - 1)) for s in range(0, LENGTH, 1000)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_polish_encode"))
    genome = random_genome(LENGTH, seed=61)
    edits = plant_variants(dict(genome), 6, 2, 2, seed=62)
    edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in edits]
    reads = [r for r in simulate_reads_fast(genome, edits, coverage=20,
                                            read_length=4000,
                                            error_rate=0.05, seed=63)
             if not GAP[0] <= r.pos < GAP[1]]
    draft, bam = write_dataset(tmp, genome, reads)
    return draft, bam, genome[0][0]


@pytest.mark.parametrize("realign", [True, False])
def test_port_polish_encode_matches_jax(dataset, realign):
    draft, bam, contig = dataset
    with BamReader(bam) as b, FastaReader(draft) as f:
        got = create_polish_summaries_multi(b, f, contig, INTERVALS,
                                            realignment_flag=realign)
    with JaxBamReader(bam) as b, JaxFastaReader(draft) as f:
        want = jax_multi(b, f, contig, INTERVALS, realignment_flag=realign)
    assert len(got) == len(want) == len(INTERVALS)
    empty = [i for i, w in enumerate(want) if not w[0]]
    assert empty and len(empty) < len(INTERVALS), empty
    for g, w in zip(got, want):
        g_imgs, g_labels, g_pos, g_cid = g
        w_imgs, w_labels, w_pos, w_cid = w
        assert g_cid == w_cid and len(g_imgs) == len(w_imgs)
        for a, b in zip(g_imgs, w_imgs):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g_pos, w_pos):
            np.testing.assert_array_equal(a, b)
        assert len(g_labels) == len(w_labels)


def test_a_failed_allocation_raises(dataset, monkeypatch):
    """polish_encode_multi leaves NULL for every interval, as the C code
    does only when an allocation fails (or for an interval of no length):
    the positive-length intervals raise, the empty one reads as None."""
    draft, bam, contig = dataset
    lib = polish_encoder._lib()
    polish_encoder._bind_multi(lib)
    result = ctypes.POINTER(polish_encoder._PolishEncodeResult)

    def all_null(*args):
        return (result * args[6])()

    monkeypatch.setattr(lib, "polish_encode_multi", all_null)
    monkeypatch.setattr(lib, "polish_encode_multi_free", lambda arr, n: None)
    with BamReader(bam) as b:
        assert polish_encoder.polish_encode_multi_native(
            b, contig, [(500, 499)], "", 500, [0], False) == [None]
        with pytest.raises(MemoryError, match=f"{contig}:0-999"):
            polish_encoder.polish_encode_multi_native(
                b, contig, INTERVALS[:2], "A" * 2100, 0, [1050, 1050],
                False)
