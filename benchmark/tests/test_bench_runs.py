"""Whole runs of the cells on the CPU at a small size: a sound run comes out
correct, a run with its timed path broken underneath comes out not
correct, a new cell and metric need new files only, and a checkout
without the program cannot run. The kernels' own paths run only on the
card; here the program takes its plain CPU versions."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

SMALL = {
    "call_variant.r941.35x": {"mbp": 0.04, "contigs": 1, "snps": 32,
                              "insertions": 4, "deletions": 4,
                              "check_intervals": 1},
}


@pytest.fixture(autouse=True)
def _small(monkeypatch, tmp_path, request):
    # a seed of each test's own, so that tests on several workers never
    # build the same cached dataset at once
    monkeypatch.setattr(sys.modules[__name__], "SEED",
                        zlib.crc32(request.node.name.encode()))
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "64")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    yield
    torch.set_num_threads(threads)


SEED = 20251017


def cpu_run(cell, seconds=2.0, trace=False):
    return run.run(cell, SEED, seconds, trace, device="cpu",
                   overrides=SMALL[cell])


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    result, checks = cpu_run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    (metric, value), = [(k, v) for k, v in result["metrics"].items()
                        if k != "setup_s"]
    assert value["value"] > 0 and result["metrics"]["setup_s"]["value"] > 0


def _permute_rows(monkeypatch, which):
    """The classifier's answer altered where it is produced: its
    probabilities for `which` rows of every batch (a slice) moved to
    another genotype."""
    from pepper_tpu_torch.runtime import streaming
    real = streaming.DeviceRunner.forward

    def forward(self, images8):
        out = real(self, images8).clone()
        out[which] = out[which].roll(1, dims=1)
        return out
    monkeypatch.setattr(streaming.DeviceRunner, "forward", forward)


def _half_batch(monkeypatch):
    """Half of every batch left out: its rows come back as hom-ref."""
    from pepper_tpu_torch.runtime import streaming
    real = streaming.DeviceRunner.forward

    def forward(self, images8):
        out = real(self, images8).clone()
        half = len(out) // 2
        out[half:] = torch.tensor([1.0, 0.0, 0.0])
        return out
    monkeypatch.setattr(streaming.DeviceRunner, "forward", forward)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_broken_call_variant_is_not_correct(monkeypatch, fault):
    if fault == "answer":
        _permute_rows(monkeypatch, slice(0, None, 7))
    else:
        _half_batch(monkeypatch)
    result, checks = cpu_run("call_variant.r941.35x")
    assert not result["correct"], checks


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _copy_benchmark(dest):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "*.npz"))
    os.makedirs(os.path.join(dest, "benchmark", "weights"), exist_ok=True)
    for f in os.listdir(os.path.join(ROOT, "benchmark", "weights")):
        if f.endswith(".npz"):
            os.symlink(os.path.join(ROOT, "benchmark", "weights", f),
                       os.path.join(dest, "benchmark", "weights", f))


_ADD = r'''
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.append(sys.argv[2])        # the program, from the real checkout
os.environ["PEPPER_TPU_MIN_DEVICE_BATCH"] = "64"
from benchmark import run
res, checks = run.run("call_variant.r941.20x", 7, 1.0, True, device="cpu",
                      overrides={"mbp": 0.04, "contigs": 1, "snps": 32,
                                 "insertions": 4, "deletions": 4,
                                 "check_intervals": 1})
print(json.dumps(res))
'''


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A later change adds a cell and a per-layer metric by adding files
    and entries of BENCHMARK.json: no file the benchmark has is edited,
    and the run finds them by name."""
    _copy_benchmark(tmp_path)
    bench = tmp_path / "benchmark"
    before = _digest(bench)
    work = json.loads((bench / "workloads" / "call_variant.r941.35x.json")
                      .read_text())
    work["traffic"] = "r941.20x"
    work["traffic_params"]["coverage"] = 20
    (bench / "workloads" / "call_variant.r941.20x.json").write_text(
        json.dumps(work))
    (bench / "metrics" / "jobs.variant.py").write_text(
        'LAYER = "device runner (runtime/streaming.py::DeviceRunner)"\n'
        'UNIT = "jobs"\nSOURCE = "host_clock"\n'
        'MOVES = "variant_mbp_s"\n'
        'WORKLOADS = ["call_variant.r941.20x"]'
        '\n\n\ndef read(obs):\n    jobs = obs.get("jobs")\n'
        '    return len(jobs) if jobs else None\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "call_variant.r941.20x",
                              "config": "pepper_variant_r941",
                              "traffic": "r941.20x", "chips": 1,
                              "why": "20x"})
    for m in spec["end_to_end"]:
        if m["name"] == "variant_mbp_s":
            m["workloads"].append("call_variant.r941.20x")
    spec["per_layer"].append({"name": "jobs.variant", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "device runner "
                                       "(runtime/streaming.py::DeviceRunner)",
                              "moves": "variant_mbp_s",
                              "workloads": ["call_variant.r941.20x"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", _ADD, str(tmp_path), ROOT],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"].get("jobs.variant", {}).get("value", 0) >= 1, (
        res, out.stderr[-2000:])
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_checkout_without_the_program_prints_no_result(tmp_path):
    _copy_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "call_variant.r941.35x", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_reference_repeat_gate_matches_the_program(tmp_path):
    """The plain repeat gate (CandidateFinder.py's +-10 bp runs) and the
    program's prefix-sum version agree on every position of a sequence
    with planted homopolymers."""
    from benchmark.reference import variant_calls
    from benchmark.traffic.fasta import FastaReader, write_fasta
    from pepper_tpu_torch.io.fasta import FastaReader as ProgramFasta
    from pepper_tpu_torch.pipelines.find_candidates import _ContigSpanCache

    rng = np.random.default_rng(3)
    seq = list(rng.choice(list("ACGT"), 3000))
    for start in rng.integers(0, 2990, 60):
        seq[start:start + int(rng.integers(3, 9))] = "G" * 8
    seq = "".join(seq)[:3000]
    path = str(tmp_path / "ref.fa")
    write_fasta(path, [("c1", seq)])
    positions = np.arange(0, 3000)
    with ProgramFasta(path) as fa:
        span = _ContigSpanCache(fa)
        span.load("c1", -10, 3010)
        _, program = span.annotate(positions)
    with FastaReader(path) as fa:
        plain = [variant_calls.in_repeat(fa, "c1", int(p))
                 for p in positions]
    assert plain == program.tolist()


def test_reference_models_match_the_program():
    """The plain classifier against the program's forward pass in float32
    on the CPU, on one set of weights."""
    from benchmark.reference import models
    from pepper_tpu_torch.models.variant_model import variant_forward

    tree = models.init_classifier(5, 26, 33, 32, 64, 5, 3)
    x = torch.randint(-125, 126, (16, 33, 26)).float()
    np.testing.assert_allclose(models.classifier_forward(tree, x).numpy(),
                               variant_forward(tree, x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_control_fails_the_variant_check():
    """fp8 products in place of the program fail one of the numbers that
    decide `correct`, on a small dataset with the committed weights."""
    from benchmark import harness
    from benchmark.reference import control
    work = harness.cell("call_variant.r941.35x")
    conf = harness.config(work["config"])
    got = control.variant_control(work, conf, 11, "cpu",
                                  SMALL["call_variant.r941.35x"])
    assert control.fails(got["fp8"], work["limits"]), got
