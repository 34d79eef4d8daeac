"""Boundaries of the PyTorch port: it imports neither jax nor the JAX
package (nor h5py, which the card's machine lacks, until a store is
opened), it asks for the card and never carries on on the CPU when the card
is missing, it ships no built library, and its package data holds every
source its kernels include."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pepper_tpu_torch")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pepper_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    pepper_tpu_torch.__path__, 'pepper_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'pepper_tpu', 'h5py')]\n"
        "missing = {'pepper_tpu_torch.parallel.mesh',\n"
        "           'pepper_tpu_torch.parallel.dryrun',\n"
        "           'pepper_tpu_torch.parallel.dp_rehearsal',\n"
        "           'pepper_tpu_torch.models.variant_transformer',\n"
        "           'pepper_tpu_torch.models.variant_no_cnn',\n"
        "           'pepper_tpu_torch.models.polish_seq2seq',\n"
        "           'pepper_tpu_torch.pipelines.hp_legacy',\n"
        "           'pepper_tpu_torch.pipelines.candidate_finder_legacy',\n"
        "           'pepper_tpu_torch.encode.diploid_pileup',\n"
        "           'pepper_tpu_torch.utils.acceptance',\n"
        "           'pepper_tpu_torch.utils.bench',\n"
        "           'pepper_tpu_torch.utils.profile_stream',\n"
        "           'pepper_tpu_torch.utils.train_image_index'} - set(mods)\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 85 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("scope", ["pepper_tpu_torch", "chip_smoke.py"])
def test_no_import_statement_names_jax_or_the_jax_package(scope):
    paths = [os.path.join(ROOT, scope)] if scope.endswith(".py") else [
        os.path.join(d, f) for d, _, files in os.walk(PKG) for f in files
        if f.endswith(".py")]
    assert paths
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pepper_tpu", "tests"), \
                (path, mod)


def test_package_data_ships_every_included_source():
    """A non-editable install builds the kernels from the package data, so
    every `#include "..."` under csrc/ must name a file that it ships."""
    import fnmatch
    import re
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"][
            "pepper_tpu_torch"]
    csrc = os.path.join(PKG, "csrc")
    sources = sorted(os.listdir(csrc))
    shipped = {f for f in sources
               if any(fnmatch.fnmatch("csrc/" + f, g) for g in globs)}
    included = set()
    for name in sources:
        with open(os.path.join(csrc, name)) as fh:
            included |= set(re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                                       fh.read(), re.M))
    assert included and any(f.endswith(".cuh") for f in included)
    assert included <= shipped, sorted(included - shipped)
    assert {f for f in sources if f.endswith(".cu")} <= shipped


def test_no_built_library_in_the_package():
    built = [os.path.join(d, f) for d, _, files in os.walk(PKG)
             for f in files if f.endswith((".so", ".o", ".a"))]
    assert built == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_runner_on_cuda_without_a_card_raises(no_cuda):
    from pepper_tpu_torch.runtime.streaming import DeviceRunner
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceRunner({}, 512, device="cuda")


def test_call_variant_on_cuda_without_a_card_raises(no_cuda, tmp_path):
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.pipelines.call_variant import call_variant
    from pepper_tpu_torch.presets import set_parameters
    from pepper_tpu_torch.utils.synth import (random_genome, simulate_reads,
                                              write_dataset)

    genome = random_genome(3000, seed=9)
    fasta, bam = write_dataset(str(tmp_path), genome,
                               simulate_reads(genome, [], coverage=5, seed=9))
    model = str(tmp_path / "model.npz")
    save_checkpoint(model, init_variant_params(torch.Generator(), hidden=8))
    out = str(tmp_path / "out") + "/"
    config = set_parameters(PipelineConfig(
        bam=bam, fasta=fasta, output_dir=out, model_path=model,
        ont_r9_guppy5_sup=True))
    assert config.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call_variant(config)
    assert not os.path.exists(out) or not any(
        f.endswith(".vcf.gz") for f in os.listdir(out))


@pytest.fixture(scope="module")
def polish_inputs(tmp_path_factory):
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.polish_model import init_polish_params
    from pepper_tpu_torch.utils.synth import (random_genome, simulate_reads,
                                              write_dataset)

    tmp = tmp_path_factory.mktemp("polish_no_card")
    genome = random_genome(3000, seed=9)
    draft, bam = write_dataset(str(tmp), genome,
                               simulate_reads(genome, [], coverage=5, seed=9))
    model = str(tmp / "model.npz")
    save_checkpoint(model, init_polish_params(torch.Generator(), hidden=8))
    return dict(tmp=tmp, draft=draft, bam=bam, model=model)


def _polish_api(ds, out):
    from pepper_tpu_torch.polish.pipeline import polish
    polish(ds["bam"], ds["draft"], ds["model"], out)


def _stream_polish(ds, out):
    from pepper_tpu_torch.polish.streaming import stream_polish
    stream_polish(ds["bam"], ds["draft"], ds["model"], out + "pred.hdf")


def _polish_cli(ds, out):
    from pepper_tpu_torch.cli.pepper_main import main
    main(["polish", "-b", ds["bam"], "-f", ds["draft"], "-m", ds["model"],
          "-o", out])


@pytest.mark.parametrize("entry", [_polish_api, _stream_polish, _polish_cli])
def test_polish_on_cuda_without_a_card_raises(no_cuda, polish_inputs,
                                              entry):
    out = str(polish_inputs["tmp"] / entry.__name__) + "/"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(polish_inputs, out)
    assert not os.path.exists(out) or not any(
        f.endswith((".fa", ".hdf")) for _, _, files in os.walk(out)
        for f in files)


def test_cpu_runner_pads_to_a_fixed_batch_in_f32(tmp_path):
    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    params = init_variant_params(torch.Generator().manual_seed(0), hidden=8)
    tree = {g: {k: v.numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}
    runner = DeviceRunner(tree, 16, device="cpu")
    assert runner.dtype == torch.float32 and runner.batch == 2048
    images = np.random.default_rng(0).integers(
        -125, 126, (5, 33, 26)).astype(np.int8)
    probs = np.asarray(runner.submit(images))
    assert probs.shape == (runner.batch, 3)
    np.testing.assert_allclose(probs[:5].sum(axis=1), 1.0, atol=1e-5)
