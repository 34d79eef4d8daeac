"""The port's call_variant / run_inference against the JAX package's, on
one synthetic dataset and one .npz model (f32 on the CPU).

Contract: the 5 VCFs have identical headers and record order, and every
record agrees on every column and FORMAT field except AP, which is allclose
at 1e-5: AP prints probabilities with .6g (io/vcf.py) and XLA and torch sum
in different orders, so its sixth digit can flip. The port's own staged and
streamed runs are byte-identical.
"""
import glob
import gzip
import os

import jax
import numpy as np
import pytest

from pepper_tpu.models.checkpoint import save_checkpoint as jax_save
from pepper_tpu.models.variant_model import init_variant_params
from pepper_tpu.options import PipelineConfig as JaxPipelineConfig
from pepper_tpu.pipelines.call_variant import call_variant as jax_call_variant
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu.runtime.inference import run_inference as jax_run_inference
from pepper_tpu_torch.cli.pepper_variant_main import main as cli_main
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.runtime.inference import run_inference
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

BATCH = 8   # several flushes on a small genome


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_cv"))
    genome = random_genome(20000, seed=71)
    variants = plant_variants(dict(genome), 20, 5, 5, seed=72)
    fasta, bam = write_dataset(
        tmp, genome, simulate_reads(genome, variants, coverage=30, seed=73))
    model = os.path.join(tmp, "model.npz")
    params = init_variant_params(jax.random.PRNGKey(3))
    jax_save(model, jax.tree_util.tree_map(np.asarray, params), {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", str(BATCH))
        yield dict(tmp=tmp, fasta=fasta, bam=bam, model=model)


def _fields(ds, out_dir):
    return dict(bam=ds["bam"], fasta=ds["fasta"], output_dir=out_dir,
                model_path=ds["model"], sub_command="call_variant",
                ont_r9_guppy5_sup=True, threads=2, region_size=10000,
                batch_size=BATCH)


def _config(ds, out_dir, **over):
    config = set_parameters(PipelineConfig(**_fields(ds, out_dir),
                                           device="cpu"))
    for k, v in over.items():
        setattr(config, k, v)
    return config


def _vcf_bytes(out_dir):
    paths = sorted(glob.glob(os.path.join(out_dir, "*.vcf.gz")))
    assert len(paths) == 5, paths
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


@pytest.fixture(scope="module")
def port_streamed(dataset):
    out = dataset["tmp"] + "/port_streamed/"
    call_variant(_config(dataset, out))
    return out


@pytest.fixture(scope="module")
def jax_streamed(dataset):
    out = dataset["tmp"] + "/jax_streamed/"
    jax_call_variant(jax_set_parameters(
        JaxPipelineConfig(**_fields(dataset, out))))
    return out


def _read_vcf(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            [ln.split("\t") for ln in lines if not ln.startswith("#")])


def assert_vcfs_match(got_dir, want_dir) -> int:
    """The module docstring's contract over the 5 VCFs of two output
    directories; returns the number of records compared."""
    names = sorted(os.path.basename(p)
                   for p in glob.glob(want_dir + "*.vcf.gz"))
    assert len(names) == 5
    n_records = 0
    for name in names:
        want_head, want = _read_vcf(want_dir + name)
        got_head, got = _read_vcf(got_dir + name)
        assert got_head == want_head, name
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g[:9] == w[:9], (name, g, w)
            keys = w[8].split(":")
            g_sample = dict(zip(keys, g[9].split(":")))
            w_sample = dict(zip(keys, w[9].split(":")))
            for key in keys:
                if key == "AP":
                    np.testing.assert_allclose(
                        [float(v) for v in g_sample[key].split(",")],
                        [float(v) for v in w_sample[key].split(",")],
                        atol=1e-5, err_msg=f"{name} {g[:5]}")
                else:
                    assert g_sample[key] == w_sample[key], (name, key, g, w)
        n_records += len(want)
    return n_records


def test_streamed_vcfs_match_jax(port_streamed, jax_streamed):
    assert assert_vcfs_match(port_streamed, jax_streamed) >= 10


def test_staged_matches_streamed_byte_identical(dataset, port_streamed):
    out_staged = dataset["tmp"] + "/port_staged/"
    call_variant(_config(dataset, out_staged, streaming=False))
    staged, streamed = _vcf_bytes(out_staged), _vcf_bytes(port_streamed)
    assert staged.keys() == streamed.keys()
    for name in staged:
        assert staged[name] == streamed[name], f"{name} differs"
    assert glob.glob(port_streamed + "predictions_*/*.hdf")
    assert not glob.glob(port_streamed + "images_*/*")


def test_run_inference_predictions_match_jax(dataset):
    import h5py

    from pepper_tpu_torch.pipelines.make_images import generate_images

    config = _config(dataset, dataset["tmp"] + "/ri/",
                     sub_command="make_images")
    config.image_output_directory = dataset["tmp"] + "/ri/images/"
    generate_images(config)
    port_out = run_inference(_config(dataset, dataset["tmp"] + "/ri/"),
                             config.image_output_directory,
                             dataset["tmp"] + "/ri/port/")
    jax_out = jax_run_inference(
        jax_set_parameters(JaxPipelineConfig(
            **_fields(dataset, dataset["tmp"] + "/ri/"))),
        config.image_output_directory, dataset["tmp"] + "/ri/jax/")
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as want:
        batches = list(want["predictions"].keys())
        assert batches and list(got["predictions"].keys()) == batches
        rows = 0
        for name in batches:
            g, w = got["predictions"][name], want["predictions"][name]
            for key in ("contigs", "positions", "depths", "candidates",
                        "candidate_frequency"):
                np.testing.assert_array_equal(g[key][()], w[key][()])
            np.testing.assert_allclose(g["base_prediction"][()],
                                       w["base_prediction"][()], atol=1e-5)
            rows += len(w["positions"])
        assert rows > BATCH


def test_streamed_without_h5py_skips_the_artifact(dataset, port_streamed,
                                                  monkeypatch):
    from pepper_tpu_torch.runtime import streaming
    monkeypatch.setattr(streaming, "h5py_available", lambda: False)
    out = dataset["tmp"] + "/port_no_h5py/"
    call_variant(_config(dataset, out))
    assert _vcf_bytes(out) == _vcf_bytes(port_streamed)
    assert not glob.glob(out + "predictions_*/*.hdf")


def test_cli_call_variant_matches_api(dataset, port_streamed):
    out = dataset["tmp"] + "/port_cli/"
    assert cli_main(["call_variant", "-b", dataset["bam"], "-f",
                     dataset["fasta"], "-o", out, "-m", dataset["model"],
                     "--ont_r9_guppy5_sup", "-t", "2", "--region_size",
                     "10000", "-bs", str(BATCH), "--device", "cpu"]) == 0
    assert _vcf_bytes(out) == _vcf_bytes(port_streamed)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_streaming_flusher_errors_surface(dataset, tmp_path, monkeypatch):
    from pepper_tpu_torch.pipelines import datastore

    def boom(self, *a, **k):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(datastore.PredictionStore, "write_prediction", boom)
    with pytest.raises(RuntimeError, match="disk full|streaming"):
        call_variant(_config(dataset, str(tmp_path) + "/out/"))
