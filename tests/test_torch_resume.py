"""Resume journal of the port's streamed call_variant (the port's copy of
runtime/resume.py), mirroring tests/test_resume.py: kill -9 a streamed run
mid-stream, re-run the same command, and get VCFs byte-identical to an
uninterrupted run without re-encoding the intervals that completed."""
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.models.variant_model import init_variant_params
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = """
import json, sys
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.pipelines.call_variant import call_variant

call_variant(set_parameters(PipelineConfig(**json.load(open(sys.argv[1])))))
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_resume"))
    genome = random_genome(24000, seed=81)
    variants = plant_variants(dict(genome), 10, 3, 3, seed=82)
    fasta, bam = write_dataset(tmp, genome, simulate_reads(
        genome, variants, coverage=30, seed=83, error_rate=0.08))
    model = os.path.join(tmp, "model.npz")
    save_checkpoint(model, init_variant_params(
        torch.Generator().manual_seed(3)), {})
    return dict(tmp=tmp, fasta=fasta, bam=bam, model=model)


def _fields(ds, out_dir):
    return dict(bam=ds["bam"], fasta=ds["fasta"], output_dir=out_dir,
                sub_command="call_variant", ont_r9_guppy5_sup=True,
                threads=2, model_path=ds["model"], region_size=4000,
                device="cpu")


def _run(ds, out_dir, tag, crash_after=0):
    cfg_path = os.path.join(ds["tmp"], f"config_{tag}.json")
    with open(cfg_path, "w") as fh:
        json.dump(_fields(ds, out_dir), fh)
    env = dict(os.environ, PEPPER_TPU_MIN_DEVICE_BATCH="16")
    if crash_after:
        env["PEPPER_TPU_TEST_CRASH_AFTER_FLUSH"] = str(crash_after)
    return subprocess.run(
        [sys.executable, "-c", _DRIVER.format(repo=REPO), cfg_path],
        env=env, capture_output=True, timeout=600)


def _vcf_bytes(out_dir):
    paths = sorted(glob.glob(os.path.join(out_dir, "*.vcf.gz")))
    assert len(paths) == 5, paths
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


def test_kill9_resume_byte_identical(dataset, monkeypatch):
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "16")
    ref_out = os.path.join(dataset["tmp"], "ref_out/")
    call_variant(set_parameters(PipelineConfig(**_fields(dataset, ref_out))))
    ref = _vcf_bytes(ref_out)

    out = os.path.join(dataset["tmp"], "crash_out/")
    p = _run(dataset, out, "crash", crash_after=2)
    assert p.returncode == 9, (p.returncode, p.stderr.decode()[-2000:])
    assert glob.glob(out + "pepper_stream_*resume.journal"), \
        "the crashed run must leave its resume journal behind"

    p = _run(dataset, out, "resume")
    assert p.returncode == 0, p.stderr.decode()[-3000:]
    err = p.stderr.decode()
    assert "INTERVALS REPLAYED FROM JOURNAL" in err, err[-2000:]
    assert int(err.split("RESUME: ")[1].split("/")[0]) >= 1
    assert _vcf_bytes(out) == ref
    assert not glob.glob(out + "pepper_stream_*resume.journal")
