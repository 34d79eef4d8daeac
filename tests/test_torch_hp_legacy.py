"""The port's legacy chunked-HP chain (pipelines/hp_legacy.py) against the
JAX package's, on the CPU: the stores, the chunking, the window vote
function (int votes within +-2 of JAX's at f32: two windows cover an
interior position and each int truncation can move by one), and the whole
chain from chunked images through `predict_hp`, the prediction store and
`predictions_to_finder_inputs` into the legacy HP candidate finder, on the
same files. Also the array-level core (`vote_records`, `HPPredictionList`)
that runs the chain without h5py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models.polish_model import init_polish_params as jax_init
from pepper_tpu.pipelines import candidate_finder_legacy as jax_finder
from pepper_tpu.pipelines import hp_legacy as jax_hp
from pepper_tpu_torch.encode.region_encoder_hp import RegionalSummaryHP
from pepper_tpu_torch.io.bam_reader import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.options import ImageOptionsHP
from pepper_tpu_torch.pipelines import candidate_finder_legacy as finder
from pepper_tpu_torch.pipelines import hp_legacy as hp
from pepper_tpu_torch.runtime.inference import _load_model_params
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

L = ImageOptionsHP.SEQ_LENGTH
HIDDEN = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops; one thread per
    test worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree():
    """A 48-feature, 5-class polish model (hidden 8) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(0), image_features=48, hidden=HIDDEN,
        num_classes=5))


def test_chunked_image_store_roundtrip_reads_in_both_packages(tmp_path):
    path = str(tmp_path / "hp_images.hdf")
    img = np.random.default_rng(0).integers(0, 255, (L, 48)).astype(np.uint8)
    pos = np.arange(L, dtype=np.int32)
    idx = np.zeros(L, np.int32)
    with hp.HPChunkedImageStore(path, "w") as store:
        store.write_summary_hp(("chr1", 0, 999), img, img, idx, idx, pos,
                               idx, 0, "chr1-0-999-0")
        # duplicate write is ignored (reference meta-set behavior)
        store.write_summary_hp(("chr1", 0, 999), img * 0, img, idx, idx,
                               pos, idx, 0, "chr1-0-999-0")
    for store_cls in (hp.HPChunkedImageStore, jax_hp.HPChunkedImageStore):
        with store_cls(path, "r") as store:
            assert store.summary_names() == ["chr1-0-999-0"]
            s = store.read_summary("chr1-0-999-0")
        np.testing.assert_array_equal(s["image_hp1"], img)
        np.testing.assert_array_equal(s["position"], pos)
        assert (s["contig"], s["region_start"], s["region_end"],
                s["chunk_id"]) == ("chr1", 0, 999, 0)


@pytest.mark.parametrize("length", [1, 999, 1000, 2400])
def test_make_chunked_hp_images_matches_jax_and_masks_haplotypes(length):
    rng = np.random.default_rng(length)
    matrix = rng.integers(-125, 126, (length, 48))
    positions = np.arange(length) + 500
    indices = rng.integers(0, 3, length)
    got = hp.make_chunked_hp_images(matrix, positions, indices)
    want = jax_hp.make_chunked_hp_images(matrix, positions, indices)
    assert [c["chunk_id"] for c in got] == [c["chunk_id"] for c in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    for c in got:
        assert c["image_hp1"].shape == (L, 48)
        assert not c["image_hp1"][:, 24:].any()     # HP2 block zeroed
        assert not c["image_hp2"][:, :24].any()     # HP1 block zeroed
    last = got[-1]
    valid = length - 950 * (len(got) - 1)
    assert (last["position"][:valid] == positions[length - valid:]).all()
    assert (last["position"][valid:] == -1).all()   # zero-padded tail


def _vote_inputs(B, seq_len, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 60, (2, B, seq_len, 48))
    x[rng.random(x.shape) < 0.6] = 0
    return x.astype(np.uint8)


@pytest.mark.parametrize("seq_len", [200, 230])
@pytest.mark.parametrize("fused_rnn", [True, False])
def test_window_vote_fn_matches_jax(tree, seq_len, fused_rnn):
    """seq_len 230 leaves the last window (150..250) skipped: its positions
    keep the votes of the windows before it."""
    B = 3
    x1, x2 = _vote_inputs(B, seq_len, seq_len)
    jfn = jax_hp.make_hp_window_vote_fn(
        jax.tree_util.tree_map(jnp.asarray, tree), num_classes=5,
        seq_len=seq_len, hidden_size=HIDDEN)
    want = [np.asarray(v) for v in jfn(jnp.asarray(x1), jnp.asarray(x2))]
    fn = hp.make_hp_window_vote_fn(tree, num_classes=5, seq_len=seq_len,
                                   hidden_size=HIDDEN, device="cpu",
                                   fused_rnn=fused_rnn)
    got = fn(torch.from_numpy(x1), torch.from_numpy(x2))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (B, seq_len, 5)
        g = g.numpy()
        assert np.abs(g - w).max() <= 2
        # the number of windows over each position: one at the edges, two
        # inside, none past the last window that fits
        last_end = (seq_len - 100) // 50 * 50 + 100
        covered = g.sum(-1)
        assert ((covered[:, 60:90] > 19990) & (covered[:, 60:90] <= 20000)
                ).all()
        assert ((covered[:, :40] > 9990) & (covered[:, :40] <= 10000)).all()
        assert (covered[:, last_end:] == 0).all()
        top2 = np.sort(w[:, :last_end], axis=-1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > 4
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(g[:, :last_end].argmax(-1)[sure],
                                      w[:, :last_end].argmax(-1)[sure])
    # the same images on both haplotypes give the same votes
    same = fn(torch.from_numpy(x1), torch.from_numpy(x1))
    assert torch.equal(same[0], same[1])


def test_vote_records_without_h5py_and_list_order(tree, monkeypatch):
    """The array core votes in-memory chunks in padded batches with no
    store, and HPPredictionList yields records in the store's order (chunk
    ids as strings: "10" before "2")."""
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)   # import h5py fails
    matrix = np.random.default_rng(3).integers(0, 40, (11 * 950 + 60, 48))
    chunks = hp.make_chunked_hp_images(matrix, np.arange(len(matrix)),
                                       np.zeros(len(matrix), np.int64))
    assert len(chunks) == 12
    summaries = [dict(c, contig="chr1", region_start=0,
                      region_end=len(matrix) - 1) for c in chunks]
    calls = []
    vote = hp.load_hp_vote_fn(tree, device="cpu")

    def counting(x1, x2):
        calls.append(tuple(x1.shape))
        return vote(x1, x2)

    records = list(hp.vote_records(summaries, counting, batch_size=5))
    assert calls == [(5, L, 48)] * 3           # 5 + 5 + 2, padded to 5
    assert [r["chunk_id"] for r in records] == list(range(12))
    solo = hp.vote_records(summaries[11:], vote, batch_size=1)
    only = next(solo)
    np.testing.assert_array_equal(only["base_predictions_hp1"],
                                  records[11]["base_predictions_hp1"])
    listed = [r["chunk_id"] for r in
              hp.HPPredictionList(records).iter_predictions()]
    assert listed == sorted(str(i) for i in range(12))
    with pytest.raises(ModuleNotFoundError, match="h5py"):
        hp.HPPredictionStore(os.devnull, "r")


# --------------------------------------------------------------- the chain
@pytest.fixture(scope="module")
def chain(tmp_path_factory, tree):
    """A haplotype-tagged synthetic dataset, its 48-feature HP matrix from
    the port's RegionalSummaryHP, chunked into an image store, and a model
    checkpoint."""
    tmp = tmp_path_factory.mktemp("hp_legacy_chain")
    genome = random_genome(3000, seed=21)
    variants = plant_variants(dict(genome), 6, 2, 2, seed=22)
    fasta, bam = write_dataset(str(tmp), genome, simulate_reads(
        genome, variants, coverage=20, seed=23, hp_tags=True))
    contig, seq = genome[0]
    start, end = 0, len(seq) - 1
    reads = BamReader(bam).get_reads(contig, start, end + 1)
    ref = FastaReader(fasta).get_reference_sequence(contig, start, end + 1)
    summary = RegionalSummaryHP(contig, start, end, ref)
    summary.generate_summary(
        reads, min_snp_baseq=1, min_indel_baseq=1, snp_freq_threshold=0.1,
        insert_freq_threshold=0.15, delete_freq_threshold=0.15,
        min_coverage_threshold=2, snp_candidate_freq_threshold=0.1,
        indel_candidate_freq_threshold=0.1, candidate_support_threshold=2,
        skip_indels=False, candidate_region_start=start,
        candidate_region_end=end)
    assert summary.matrix.shape == (len(seq), 48) and summary.matrix.any()
    chunks = hp.make_chunked_hp_images(summary.matrix,
                                       np.arange(start, end + 1),
                                       np.zeros(len(seq), np.int64))
    image_dir = tmp / "images"
    image_dir.mkdir()
    with hp.HPChunkedImageStore(str(image_dir / "im.hdf"), "w") as store:
        for c in chunks:
            store.write_summary_hp(
                (contig, start, end), c["image_hp1"], c["image_hp2"],
                c["index"], c["index"], c["position"], c["index"],
                c["chunk_id"], f"{contig}-{start}-{end}-{c['chunk_id']}")
    model = str(tmp / "hp_model.npz")
    save_checkpoint(model, tree)
    return dict(tmp=tmp, bam=bam, fasta=fasta, contig=contig, start=start,
                end=end, chunks=chunks, image_dir=str(image_dir),
                model=model)


def _candidates(result):
    exact, probs = [], []
    for pos in sorted(result):
        for c in result[pos]:
            exact.append((pos, c.pos, c.pos_end, c.allele.ref, c.allele.alt,
                          c.allele.alt_type, c.depth, c.read_support,
                          c.genotype))
            probs.append((c.alt_prob_h1, c.alt_prob_h2, c.non_ref_prob))
    return exact, np.array(probs)


def test_predict_hp_chain_matches_jax(chain):
    c = chain
    outs = {}
    for name, pkg in (("jax", jax_hp), ("torch", hp)):
        kw = {"device": "cpu"} if pkg is hp else {}
        path = pkg.predict_hp(c["image_dir"], c["model"],
                              str(c["tmp"] / name / "p.hdf"), batch_size=3,
                              **kw)
        with pkg.HPPredictionStore(path, "r") as store:
            recs = list(store.iter_predictions())
            outs[name] = recs, pkg.predictions_to_finder_inputs(store)
    (jrecs, (jpos, jidx, jh1, jh2)), (recs, (pos, idx, h1, h2)) = \
        outs["jax"], outs["torch"]
    assert len(recs) == len(jrecs) == len(c["chunks"])
    assert [r["chunk_id"] for r in recs] == [r["chunk_id"] for r in jrecs]
    assert pos == jpos and idx == jidx
    assert len(pos) == c["end"] - c["start"] + 1   # overlap de-duplicated
    assert np.abs(np.array(h1) - np.array(jh1)).max() <= 2
    assert np.abs(np.array(h2) - np.array(jh2)).max() <= 2

    args = (c["bam"], c["fasta"], c["contig"], 0, c["end"])
    got = finder.CandidateFinderCPP(c["contig"], 0, c["end"]) \
        .find_candidates_hp(*args, pos, idx, h1, h2, False, 0.0)
    want = jax_finder.CandidateFinderCPP(c["contig"], 0, c["end"]) \
        .find_candidates_hp(*args, jpos, jidx, jh1, jh2, False, 0.0)
    got_exact, got_probs = _candidates(got)
    want_exact, want_probs = _candidates(want)
    assert got_exact and got_exact == want_exact
    np.testing.assert_allclose(got_probs, want_probs, rtol=1e-3, atol=1e-6)

    # the in-memory core gives the file's finder inputs exactly
    vote = hp.load_hp_vote_fn(_load_model_params(c["model"]), device="cpu")
    summaries = [dict(ch, contig=c["contig"], region_start=c["start"],
                      region_end=c["end"]) for ch in c["chunks"]]
    listed = hp.HPPredictionList(hp.vote_records(summaries, vote, 3))
    assert hp.predictions_to_finder_inputs(listed) == (pos, idx, h1, h2)
