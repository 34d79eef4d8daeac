"""The JAX package's two quickstart-with-model contracts on the port: train
a model on labeled synthetic data with the port's trainer, then serve that
checkpoint through the port's CLI, on the CPU in f32, and hold it against
the planted truth and against the JAX package with the same checkpoint.

- Variant (tests/test_e2e_model.py:28-99): the JAX test's 60 kb dataset
  (seeds 61/62/63, 25/6/6 planted SNPs/insertions/deletions, 35x, 2%
  error), images through `pepper_variant_train make_train_images` (HDF5),
  `train_model` at batch 32, step size 25 and lr 3e-4 as there, but from a
  narrow classifier (biLSTM hidden 16; the trainer takes its widths from
  the checkpoint's shapes) and for 20 epochs of the 3 steps the 103 images
  give (60 steps): with the JAX test's 6 epochs the narrow model calls no
  planted SNP. Bars, as the JAX test's: planted-SNP recall >= 0.6, the
  five VCFs with their .tbi, staged equal to streamed byte for byte.
- Polish (tests/test_polish.py:103-190): the JAX test's 20 kb draft (seeds
  71/72/73, 12/5/5 corrections as hom-alt edits, a truth-to-draft BAM),
  `pepper_train make_train_images` and `train_model` from a biGRU of
  hidden 32 at batch 8 for one epoch (95 window steps) at lr 2e-3 (the
  JAX test's lr 3e-4 and 3 epochs take three times as long at this width
  for the same bars). Bars, as the JAX test's: length > 0.95 of the
  truth's, 21-mer identity > 0.95, >= 70% of the planted corrections
  recovered.
- Parity: the same checkpoint through the JAX package's `call_variant`
  (both directions of checkpoint origin) gives the port's records, on
  every column and FORMAT field except AP, which is allclose at 1e-5
  (tests/test_torch_call_variant.py::assert_vcfs_match); and the same
  polish checkpoint gives JAX's polished FASTA byte for byte. The JAX
  consensus fixes the biGRU width at `PolishTrainOptions.HIDDEN_SIZE`
  (128), so its test sets that option to the checkpoint's width; the
  port's consensus reads the width from the checkpoint.
"""
import glob
import os

import numpy as np
import pytest
import torch

from pepper_tpu.options import PipelineConfig as JaxPipelineConfig
from pepper_tpu.options import PolishTrainOptions as JaxPolishTrainOptions
from pepper_tpu.pipelines.call_variant import call_variant as jax_call_variant
from pepper_tpu.polish.pipeline import polish as jax_polish
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu.train.variant_train import train as jax_train
from pepper_tpu_torch.cli.pepper_main import main as polish_cli
from pepper_tpu_torch.cli.pepper_train_main import main as polish_train_cli
from pepper_tpu_torch.cli.pepper_variant_main import main as variant_cli
from pepper_tpu_torch.cli.pepper_variant_train_main import \
    main as variant_train_cli
from pepper_tpu_torch.io.bam_writer import BamWriter
from pepper_tpu_torch.io.vcf import read_vcf
from pepper_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint
from pepper_tpu_torch.models.polish_model import numpy_polish_params
from pepper_tpu_torch.models.variant_model import numpy_variant_params
from pepper_tpu_torch.polish.consensus import make_window_vote_fn
from pepper_tpu_torch.utils.acceptance import evaluate
from pepper_tpu_torch.utils.synth import (_apply_haplotype, plant_variants,
                                          random_genome, simulate_reads,
                                          simulate_reads_fast, write_dataset,
                                          write_truth_vcf)
from tests.test_torch_call_variant import assert_vcfs_match

VARIANT_HIDDEN, POLISH_HIDDEN = 16, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops; one thread per
    test worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_compile_cache(monkeypatch):
    """The JAX trainer would otherwise write its compile cache under HOME."""
    monkeypatch.setenv("PEPPER_TPU_CACHE_DIR", "off")


# ------------------------------------------------------------------ variant
@pytest.fixture(scope="module")
def variant_data(tmp_path_factory):
    """The JAX test's dataset, its labeled HDF5 images, and the narrow
    classifier trained on them by the port's trainer CLI."""
    tmp = str(tmp_path_factory.mktemp("trained_variant"))
    genome = random_genome(60000, seed=61)
    variants = plant_variants(dict(genome), 25, 6, 6, seed=62)
    fasta, bam = write_dataset(tmp, genome, simulate_reads(
        genome, variants, coverage=35, seed=63, error_rate=0.02))
    truth = write_truth_vcf(tmp + "/truth.vcf", genome, variants)
    images = tmp + "/train_images/"
    assert variant_train_cli([
        "make_train_images", "-b", bam, "-f", fasta, "-tv", truth,
        "-o", images, "-t", "1", "-p", "1.0", "--ont_r9_guppy5_sup"]) in (
            0, None)
    init = tmp + "/init.npz"
    save_checkpoint(init, numpy_variant_params(5, hidden=VARIANT_HIDDEN), {})
    assert variant_train_cli([
        "train_model", "--train_image_dir", images, "--test_image_dir",
        images, "-o", tmp + "/models/", "-bs", "32", "--epoch_size", "20",
        "--step_size", "25", "-lr", "3e-4", "--retrain_model_path", init,
        "--device", "cpu"]) in (0, None)
    model = tmp + "/models/PEPPER_VARIANT_BEST.npz"
    return dict(tmp=tmp, fasta=fasta, bam=bam, truth=truth, images=images,
                init=init, model=model, variants=variants,
                contig=genome[0][0], length=len(genome[0][1]))


def _fields(data, model, out_dir):
    return dict(bam=data["bam"], fasta=data["fasta"], output_dir=out_dir,
                model_path=model, sub_command="call_variant",
                ont_r9_guppy5_sup=True, threads=2, region_size=20000)


def _port_call(data, model, name, *extra):
    out = os.path.join(data["tmp"], name) + "/"
    assert variant_cli([
        "call_variant", "-b", data["bam"], "-f", data["fasta"], "-m", model,
        "-o", out, "-t", "2", "--region_size", "20000",
        "--ont_r9_guppy5_sup", "--device", "cpu", *extra]) in (0, None)
    return out


def _jax_call(data, model, name):
    out = os.path.join(data["tmp"], name) + "/"
    jax_call_variant(jax_set_parameters(
        JaxPipelineConfig(**_fields(data, model, out))))
    return out


def _vcf_names(out_dir):
    return sorted(os.path.basename(p)
                  for p in glob.glob(out_dir + "*.vcf.gz"))


@pytest.fixture(scope="module")
def port_streamed(variant_data):
    return _port_call(variant_data, variant_data["model"], "port_streamed")


def test_trained_classifier_calls_the_planted_snps(variant_data,
                                                   port_streamed):
    """tests/test_e2e_model.py::test_trained_model_call_variant_recall on
    the port: the five VCFs with their .tbi, the split files partition
    FULL, planted-SNP recall >= 0.6; and `evaluate`, given the synthetic
    contig as its region, scores the same SNPs."""
    _, meta = load_checkpoint(variant_data["model"])
    params, _ = load_checkpoint(variant_data["model"])
    assert params["encoder"]["weight_hh_l0"].shape == (4 * VARIANT_HIDDEN,
                                                       VARIANT_HIDDEN)
    assert meta["step"] > 0 and meta["accuracy"] > 0
    paths = {k: port_streamed + f"PEPPER_VARIANT_{k}.vcf.gz"
             for k in ("FULL", "OUTPUT_PEPPER", "OUTPUT_VARIANT_CALLING",
                       "OUTPUT_VARIANT_CALLING_SNPs",
                       "OUTPUT_VARIANT_CALLING_INDEL")}
    assert _vcf_names(port_streamed) == sorted(
        os.path.basename(p) for p in paths.values())
    for p in paths.values():
        assert os.path.isfile(p + ".tbi"), p + ".tbi"
    full = read_vcf(paths["FULL"])
    assert full, "no records in FULL VCF"
    assert len(full) == sum(len(read_vcf(paths[k])) for k in (
        "OUTPUT_PEPPER", "OUTPUT_VARIANT_CALLING"))
    called = {(r.contig, r.pos) for r in full
              if "PASS" in r.filters and r.genotype() != [0, 0]}
    snps = [v for v in variant_data["variants"]
            if len(v.ref) == 1 and len(v.alt) == 1]
    hit = sum((v.contig, v.pos) in called for v in snps)
    recall = hit / len(snps)
    assert recall >= 0.6, f"planted-SNP recall {recall:.2f} ({hit}/{len(snps)})"
    report = evaluate(paths["FULL"], variant_data["truth"], None,
                      region=f"{variant_data['contig']}:1-"
                             f"{variant_data['length']}")
    assert report["SNP"]["truth_total"] == len(snps)
    assert report["SNP"]["tp"] <= hit and report["SNP"]["recall"] >= 0.6


def test_trained_classifier_staged_equals_streamed(variant_data,
                                                   port_streamed):
    """tests/test_e2e_model.py::test_trained_model_staged_equals_streamed
    on the port: the staged CLI run writes the streamed run's bytes."""
    staged = _port_call(variant_data, variant_data["model"], "port_staged",
                        "--no_streaming")
    assert _vcf_names(staged) == _vcf_names(port_streamed)
    for name in _vcf_names(port_streamed):
        with open(staged + name, "rb") as a, \
                open(port_streamed + name, "rb") as b:
            assert a.read() == b.read(), f"{name} differs"


def test_port_trained_checkpoint_gives_the_same_records_in_jax(
        variant_data, port_streamed):
    want = _jax_call(variant_data, variant_data["model"], "jax_of_port")
    assert assert_vcfs_match(port_streamed, want) >= 20


def test_jax_trained_checkpoint_gives_the_same_records_in_the_port(
        variant_data):
    """The JAX trainer from the same narrow start on the same images (30
    steps: its checkpoint need only be trained, not meet the recall bar);
    that checkpoint served by both packages."""
    model = jax_train(variant_data["images"], variant_data["images"],
                      variant_data["tmp"] + "/jax_models/", batch_size=32,
                      epoch_limit=10, step_size=25, lr=3e-4,
                      retrain_model_path=variant_data["init"])
    want = _jax_call(variant_data, model, "jax_of_jax")
    got = _port_call(variant_data, model, "port_of_jax")
    assert assert_vcfs_match(got, want) >= 20


# ------------------------------------------------------------------- polish
@pytest.fixture(scope="module")
def polish_data(tmp_path_factory):
    """tests/test_polish.py's draft (as polish_dataset builds it), its
    labeled images through the port's `pepper_train make_train_images`,
    the hidden-32 model trained on them by `pepper_train train_model`, and
    the port's polished FASTA through `pepper polish`."""
    tmp = str(tmp_path_factory.mktemp("trained_polish"))
    genome = random_genome(20000, seed=71)
    corrections = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in
                   plant_variants(dict(genome), 12, 5, 5, seed=72)]
    draft, bam = write_dataset(tmp, genome, simulate_reads(
        genome, corrections, coverage=30, seed=73, error_rate=0.02))
    truth_bam = os.path.join(tmp, "truth.bam")
    with BamWriter(truth_bam, [(n, len(s)) for n, s in genome]) as bw:
        for rec in simulate_reads_fast(genome, corrections, coverage=1,
                                       read_length=len(genome[0][1]),
                                       error_rate=0.0, seed=1, mapq=60):
            bw.write(rec)
    true_seq, _ = _apply_haplotype(genome[0][1], corrections, 0)
    contexts, shift = [], 0
    for v in corrections:
        tpos = v.pos + shift
        contexts.append(true_seq[max(0, tpos - 15):tpos + len(v.alt) + 15])
        shift += len(v.alt) - len(v.ref)

    images = tmp + "/train_images/"
    assert polish_train_cli([
        "make_train_images", "-b", bam, "-f", draft, "-tb", truth_bam,
        "-o", images, "--no_realignment"]) in (0, None)
    init = tmp + "/init.npz"
    save_checkpoint(init, numpy_polish_params(5, hidden=POLISH_HIDDEN), {})
    assert polish_train_cli([
        "train_model", "--train_image_dir", images, "--test_image_dir",
        images, "-o", tmp + "/models/", "-bs", "8", "--epoch_size", "1",
        "-lr", "2e-3", "--retrain_model_path", init, "--device", "cpu"]) in (
            0, None)
    model = tmp + "/models/PEPPER_POLISH_BEST.npz"
    out = tmp + "/port_out/"
    assert polish_cli(["polish", "-b", bam, "-f", draft, "-m", model, "-o",
                       out, "--no_realignment", "--device", "cpu"]) in (
                           0, None)
    fasta = glob.glob(out + "*.fa")
    assert len(fasta) == 1, fasta
    return dict(tmp=tmp, draft=draft, bam=bam, model=model,
                fasta=fasta[0], true_seq=true_seq, draft_seq=genome[0][1],
                contexts=contexts)


def _polished(path):
    with open(path) as fh:
        return "".join(ln for ln in fh.read().splitlines()
                       if not ln.startswith(">"))


def test_trained_polish_model_corrects_the_draft(polish_data):
    """tests/test_polish.py::test_polish_end_to_end_corrects_draft's bars
    on the port's trainer and polish."""
    params, meta = load_checkpoint(polish_data["model"])
    assert params["gru_encoder"]["weight_hh_l0"].shape == (3 * POLISH_HIDDEN,
                                                           POLISH_HIDDEN)
    assert meta["epochs"] == 1
    polished = _polished(polish_data["fasta"])
    true_seq = polish_data["true_seq"]
    assert len(polished) > 0.95 * len(true_seq)
    k = 21
    truth_kmers = {true_seq[i:i + k] for i in range(len(true_seq) - k)}
    polished_kmers = {polished[i:i + k] for i in range(len(polished) - k)}
    identity = len(truth_kmers & polished_kmers) / len(truth_kmers)
    assert identity > 0.95, identity
    checked = [c for c in polish_data["contexts"]
               if c not in polish_data["draft_seq"]]
    recovered = sum(c in polished for c in checked)
    assert len(checked) >= 10
    assert recovered / len(checked) >= 0.7, (recovered, len(checked))


def test_trained_polish_model_gives_the_jax_fasta(polish_data, monkeypatch):
    monkeypatch.setattr(JaxPolishTrainOptions, "HIDDEN_SIZE", POLISH_HIDDEN)
    want = jax_polish(polish_data["bam"], polish_data["draft"],
                      polish_data["model"], polish_data["tmp"] + "/jax_out/",
                      threads=1, realignment=False)
    with open(want, "rb") as a, open(polish_data["fasta"], "rb") as b:
        assert b.read() == a.read()


def test_consensus_takes_the_checkpoint_width():
    """A polish model of another width than 128 (as train_polish_loop
    writes from a narrow start) votes: the consensus's carried hidden has
    the checkpoint's width. It had PolishTrainOptions.HIDDEN_SIZE's, and
    a hidden-32 checkpoint failed in the first window's matrix product."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 60, (3, 1000, 10))
                              .astype(np.uint8))
    for hidden in (32, 128):
        labels, phred = make_window_vote_fn(
            numpy_polish_params(4, hidden=hidden), "cpu",
            torch.float32)(images)
        assert labels.shape == phred.shape == (3, 1000)
        assert bool(torch.isfinite(phred).all())


def test_bench_dataset_writes_its_planted_truth(tmp_path):
    """utils/bench.py::get_dataset with other seeds (the trained-model
    training set) writes its planted variants as truth.vcf, which
    `evaluate` scores a perfect call set against at recall 1."""
    from pepper_tpu_torch.utils import bench

    mbp, seeds = 0.02, (7, 8, 9)
    cache, fasta, bam = bench.get_dataset(str(tmp_path), mbp, seeds)
    genome = random_genome(int(mbp * 1e6), seed=7)
    variants = plant_variants(dict(genome), *bench.planted_counts(mbp),
                              seed=8)
    truth = read_vcf(cache + "/truth.vcf")
    assert [(r.contig, r.pos, r.ref, r.alts[0]) for r in truth] == [
        (v.contig, v.pos, v.ref, v.alt) for v in variants]
    assert cache != bench.get_dataset(str(tmp_path), mbp)[0]
    report = evaluate(cache + "/truth.vcf", cache + "/truth.vcf", None,
                      region=f"{genome[0][0]}:1-{len(genome[0][1])}")
    assert report["SNP"]["recall"] == report["INDEL"]["recall"] == 1.0
    assert report["SNP"]["truth_total"] == bench.planted_counts(mbp)[0]
