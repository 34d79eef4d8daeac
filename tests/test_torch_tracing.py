"""The streamed pipeline's spans on the profiler's clock
(utils/streamstats.py): the dispatching thread's `main.*` states tile a
`call_variant` job, the benchmark's readers find them, the operator's
trace (PEPPER_TPU_PROFILE) records every thread, a span opens no profiler
record while no profiler runs, and the older keys keep their meaning."""
import glob
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.models.variant_model import numpy_variant_params
from pepper_tpu_torch.native import encoder as native_encoder
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines import make_images
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.utils import scale_rehearsal, streamstats
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16          # several flushes on a small genome
REGION = 5000       # 8 regions, so every encode thread takes some
STATES = {"main.job_head", "main.wait_encode", "main.dispatch",
          "main.submit", "main.wait_flush", "main.wait_producers",
          "main.stage3_drain", "main.vcf_close", "main.job_rest"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_tracing"))
    genome = random_genome(40000, seed=181)
    variants = plant_variants(dict(genome), 32, 4, 4, seed=182)
    fasta, bam = write_dataset(
        tmp, genome, simulate_reads(genome, variants, coverage=30, seed=183))
    model = os.path.join(tmp, "model.npz")
    save_checkpoint(model, numpy_variant_params(18, hidden=16), {})
    return dict(tmp=tmp, fasta=fasta, bam=bam, model=model)


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", str(BATCH))
    monkeypatch.delenv("PEPPER_TPU_PROFILE", raising=False)


def _job(ds, name, threads=4):
    """One streamed call_variant on the CPU; returns its wall seconds and
    its StreamStats."""
    config = set_parameters(PipelineConfig(
        bam=ds["bam"], fasta=ds["fasta"], model_path=ds["model"],
        output_dir=os.path.join(ds["tmp"], name), sub_command="call_variant",
        ont_r9_guppy5_sup=True, threads=threads, region_size=REGION,
        batch_size=BATCH, device="cpu"))
    t0 = time.perf_counter()
    call_variant(config)
    return time.perf_counter() - t0, streamstats.CURRENT


def test_encode_sections_nest_in_encode(dataset, capsys):
    """The native encoder's four sections are nested keys: on each encode
    thread's CPU clock inside its `encode` span, out of `total()`, and in
    the STREAM BREAKDOWN line as the scale rehearsal reads it."""
    _, stats = _job(dataset, "sections", threads=2)
    sections = [stats.seconds[key] for key in native_encoder.SECTIONS]
    assert all(seconds >= 0 for seconds in sections)
    assert 0 < sum(sections) <= stats.seconds["encode"]
    assert all(key.startswith("(") for key in native_encoder.SECTIONS)
    assert stats.total() == pytest.approx(sum(
        v for k, v in stats.seconds.items()
        if not k.startswith(("(", "main."))))
    run = scale_rehearsal.Run(0, 0.0, 1.0, [], capsys.readouterr().err)
    line = run.field(r"STREAM BREAKDOWN \(core-seconds\): (.+)")
    parts = dict(part.rsplit(" ", 1) for part in line.split(" | "))
    assert {"encode", *native_encoder.SECTIONS} <= set(parts)
    assert all(float(v.rstrip("s")) >= 0 for v in parts.values())


def test_states_tile_the_job(dataset):
    wall, stats = _job(dataset, "tile")
    states = {k: v for k, v in stats.seconds.items() if k.startswith("main.")}
    assert set(states) == STATES
    assert sum(states.values()) == pytest.approx(wall, rel=0.02)
    assert stats.state_key is None, "the job leaves no state open"


def test_states_hand_over_on_the_profilers_clock(dataset):
    """On the profiler's clock the states follow one another on one
    thread: none nests in another, none leaves a hole before the next (the
    next opens before the last closes, sharing only the hand-over), and
    together they cover the job."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        wall, stats = _job(dataset, "overlap")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.name.startswith("pepper.main."))
    assert {n[len("pepper."):] for _, _, n in spans} == STATES
    assert len({e.thread for e in prof.events()
                if e.name.startswith("pepper.main.")}) == 1
    shared = 0
    for (_, end, name), (start, after_end, after) in zip(spans, spans[1:]):
        assert start <= end < after_end, (name, after)
        shared += end - start
    assert shared / 1e6 < 0.01 * wall
    covered = (spans[-1][1] - spans[0][0]) / 1e6
    assert covered == pytest.approx(wall, rel=0.02)
    assert sum(v for k, v in stats.seconds.items()
               if k.startswith("main.")) == pytest.approx(wall, rel=0.02)


_RUN = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
res, checks = run.run("call_variant.r941.35x", 1800000000018, 2.0, True,
                      device="cpu",
                      overrides={"mbp": 0.04, "contigs": 1, "snps": 32,
                                 "insertions": 4, "deletions": 4,
                                 "check_intervals": 1})
print(json.dumps(res))
'''


def test_traced_cell_run_reads_the_four_metrics(tmp_path):
    """The benchmark's traced run on the CPU (a process of its own: the
    run refuses a process that has loaded JAX) reads the four metrics of
    the dispatching thread's states and names its idle gap by one."""
    env = {**os.environ, "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "2",
           "PEPPER_TPU_MIN_DEVICE_BATCH": "64"}
    out = subprocess.run([sys.executable, "-c", _RUN, ROOT],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["dispatch_wait_encode_share.variant"] < 100
    assert 0 <= m["dispatch_wait_flush_share.variant"] < 100
    assert m["dispatch_wait_encode_share.variant"] \
        + m["dispatch_wait_flush_share.variant"] < 100
    walls = [float(w) for w in re.search(r"job walls \(s\): ([\d. ]+)",
                                         out.stderr).group(1).split()]
    assert 0 < m["job_head_s.variant"] < max(walls)
    assert 0 < m["job_tail_s.variant"] < max(walls)
    assert m["job_head_s.variant"] + m["job_tail_s.variant"] < max(walls)
    name, seconds = res["breakdown"]["idle_gaps"][0]
    assert name.startswith("pepper.main."), res["breakdown"]
    assert seconds > 0


def test_operator_trace_sees_every_thread(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("PEPPER_TPU_PROFILE", str(tmp_path))
    _job(dataset, "profiled")
    path, = glob.glob(str(tmp_path / "stream_encode_inference" /
                          "*.pt.trace.json"))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    encode_threads = {e["tid"] for e in events
                      if e["name"] == "pepper.encode"}
    assert len(encode_threads) >= 2, encode_threads
    names = {e["name"] for e in events}
    assert {"pepper.gates", "pepper.main.wait_encode"} <= names, sorted(
        n for n in names if n.startswith("pepper."))
    gates = {e["tid"] for e in events if e["name"] == "pepper.gates"}
    main = {e["tid"] for e in events if e["name"].startswith("pepper.main.")}
    assert len(main) == 1 and not gates & main
    assert not encode_threads & (gates | main)
    # each stage's trace holds the states that cover it, from its start
    assert {"pepper.main.job_head", "pepper.main.stage3_drain"} <= names
    path, = glob.glob(str(tmp_path / "find_candidates" / "*.pt.trace.json"))
    with open(path) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X"}
    assert "pepper.main.vcf_close" in names, sorted(names)


def test_no_record_function_without_a_profiler(dataset, monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    _job(dataset, "unprofiled")
    assert entered == []
    stats = streamstats.StreamStats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with stats.span("encode", cpu=True):
            pass
        stats.state("main.dispatch")
        stats.state(None)
    assert entered == ["pepper.encode", "pepper.main.dispatch"]


def test_existing_keys_keep_their_meaning(dataset, monkeypatch, capsys):
    """`encode` counts the producers' CPU time, not their waits; `total()`
    and the STREAM BREAKDOWN line leave the states out, which have a line
    of their own."""
    real = make_images.create_region_summary
    pause = 0.2

    def paused(*args, **kwargs):
        time.sleep(pause)
        return real(*args, **kwargs)
    monkeypatch.setattr(make_images, "create_region_summary", paused)
    _, stats = _job(dataset, "paused", threads=2)
    regions = 40000 // REGION
    assert stats.seconds["encode"] < 0.5 * pause * regions
    assert stats.seconds["main.wait_encode"] > 0.5 * pause * regions / 2
    assert stats.total() == pytest.approx(sum(
        v for k, v in stats.seconds.items()
        if not k.startswith(("(", "main."))))
    err = capsys.readouterr().err
    breakdown = re.search(r"STREAM BREAKDOWN \(core-seconds\): (.+)",
                          err).group(1)
    assert "encode" in breakdown and "main." not in breakdown
    states = re.search(r"DISPATCH STATES \(wall seconds\): (.+)",
                       err).group(1)
    assert {part.split()[0] for part in states.split(" | ")} == STATES
