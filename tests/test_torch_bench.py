"""The port's bench (pepper_tpu_torch/utils/bench.py) and host profiler
(utils/profile_stream.py) on the CPU at a tiny size, against the JAX
package's root bench.py:

- the bench's dataset is the root bench's generator's bytes for its seeds
  (exact);
- encode_all gives the root bench's int8 images (exact);
- the e2e stage at f32 writes the root bench_e2e's (contig, pos, ref, alt,
  GT) records in all 5 VCFs on the same dataset and .npz (exact);
- stage 3 fed from the e2e run's resume journal writes the VCF bytes that
  process_candidates writes over the same run's HDF5 prediction store;
- the whole tool prints its four-key headline and exits 0; a stage that
  raises ends it non-zero; --device cuda with no card raises; the 1-thread
  baselines restore the torch thread count;
- profile_stream prints its three variants and puts DeviceRunner.submit
  back.
"""
import glob
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from pepper_tpu_torch.pipelines.find_candidates import process_candidates
from pepper_tpu_torch.runtime import streaming
from pepper_tpu_torch.utils import bench, profile_stream
from tests.util import synth as jax_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBP = 0.05   # one 50 kb contig, 175 reads, ~1100 candidates
SMALL = ["--mbp", str(MBP), "--runs", "1", "--polish-kb", "20",
         "--train-batch", "16", "--train-iters", "2", "--device", "cpu"]
# two torch threads a run and a 512-row batch floor (the config's batch):
# the f32 forward is most of the work, and beside other test workers a wide
# intra-op pool mostly waits
SMALL_ENV = dict(OMP_NUM_THREADS="2", PEPPER_TPU_MIN_DEVICE_BATCH="16")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return bench.get_dataset(str(tmp_path_factory.mktemp("torch_bench")),
                             MBP)


def test_dataset_is_the_jax_generators(dataset, tmp_path):
    cache, fasta, bam = dataset
    genome = jax_synth.random_genome(int(MBP * 1e6 / bench.n_contigs(MBP)),
                                     seed=1, n_contigs=bench.n_contigs(MBP))
    variants = jax_synth.plant_variants(dict(genome),
                                        *bench.planted_counts(MBP), seed=2)
    records = jax_synth.simulate_reads_fast(
        genome, variants, coverage=jax_bench.COVERAGE,
        read_length=jax_bench.READ_LEN, error_rate=jax_bench.ERROR, seed=3)
    want = jax_synth.write_dataset(str(tmp_path), genome, records)
    for got, exp in zip((fasta, bam), want):
        with open(got, "rb") as a, open(exp, "rb") as b:
            assert a.read() == b.read(), got
    assert len(variants) == 50 and len(records) == 175
    # the JAX bench's 800/100/100 * int(mbp) at whole Mbp
    for mbp in (1.0, 10.0):
        assert bench.planted_counts(mbp) == (800 * int(mbp), 100 * int(mbp),
                                             100 * int(mbp))
        assert bench.n_contigs(mbp) == max(1, min(5, int(mbp)))


def test_encode_all_gives_the_root_bench_images(dataset):
    _, fasta, bam = dataset
    got = bench.encode_all(fasta, bam, 2)
    want = jax_bench.encode_all(fasta, bam, 2)
    assert got.dtype == want.dtype == np.int8 and len(got) > 500
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def port_e2e(dataset):
    """One e2e pass of the port at f32 on the CPU, its journal kept."""
    cache, fasta, bam = dataset
    mp = pytest.MonkeyPatch()
    mp.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "16")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run = bench.bench_e2e(cache, fasta, bam, 2, "cpu",
                              keep_journal=cache + "/kept.journal")
        yield run
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def _records(out_dir):
    recs = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.vcf.gz"))):
        with gzip.open(path, "rt") as fh:
            rows = [ln.split("\t") for ln in fh.read().splitlines()
                    if not ln.startswith("#")]
        recs[os.path.basename(path)] = [
            (r[0], r[1], r[3], r[4],
             dict(zip(r[8].split(":"), r[9].split(":")))["GT"])
            for r in rows]
    return recs


def test_e2e_writes_the_root_bench_records(dataset, port_e2e, tmp_path,
                                          monkeypatch):
    cache, fasta, bam = dataset
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "16")
    # root bench.make_model keeps a file that is already there
    shutil.copy(cache + "/bench_model.npz", tmp_path / "bench_model.npz")
    _, _, n, _ = jax_bench.bench_e2e(str(tmp_path), fasta, bam, 2)
    assert n == port_e2e.candidates > 500
    assert port_e2e.k1_launches == 0   # the CPU runs K1's plain version
    want = _records(str(tmp_path / "e2e_out"))
    got = _records(cache + "/e2e_out")
    assert len(want) == 5 and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert sum(len(v) for v in want.values()) >= 10


def test_stage3_from_the_journal_writes_process_candidates_vcfs(
        dataset, port_e2e):
    cache, fasta, bam = dataset
    config = bench.bench_config(fasta, bam, 2, "cpu")
    config.model_path = bench.make_model(cache)
    batches = bench.journal_batches(port_e2e.journal, config,
                                    port_e2e.intervals)
    assert sum(len(b[1]) for b in batches) == port_e2e.candidates
    bench.stage3(config, batches, cache + "/journal_vcf/")
    process_candidates(config, cache + "/e2e_out/preds/",
                       cache + "/store_vcf/")
    names = sorted(os.path.basename(p) for p in
                   glob.glob(cache + "/store_vcf/*.vcf.gz"))
    assert len(names) == 5
    for name in names:
        with open(cache + "/journal_vcf/" + name, "rb") as a, \
                open(cache + "/store_vcf/" + name, "rb") as b:
            assert a.read() == b.read(), name


def test_whole_tool_prints_the_headline(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.bench", *SMALL,
         "--cache-dir", str(tmp_path)], cwd=REPO,
        env=dict(os.environ, **SMALL_ENV), capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    head = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert head["metric"] == "variant_e2e_throughput"
    assert head["unit"] == "Mbp/s" and head["value"] > 0
    assert head["vs_baseline"] > 0
    line = [ln for ln in p.stderr.splitlines()
            if "kernel launches per stage: " in ln]
    assert len(line) == 1
    launches = json.loads(line[0].split("kernel launches per stage: ")[1])
    assert launches["device_only"]["K1"] == [0, 0, 0]   # no kernel on CPU
    assert len(launches["e2e"]) == 2 and len(launches["polish"]) == 4
    n = launches["device_only"]["candidates"]
    assert n > 500 and all(r["candidates"] == n and r["K1"] == 0
                           for r in launches["e2e"])
    assert all(r["sequences"] > 0 and r["K2"] == 0
               for r in launches["polish"])
    assert launches["train"] == {"steps": 3, "K3": 0, "K4": 0}
    for stage in ("encode scaling", "device inference", "e2e call_variant",
                  "stream breakdown", "post-hoc stage 3", "stage breakdown",
                  "polish e2e (20kb draft)", "train step (batch 16)",
                  "realigner"):
        assert f"[bench] {stage}" in p.stderr, stage
    assert "card busy in the stream: not measured (no card)" in p.stderr
    assert not glob.glob(str(tmp_path / "*" / "e2e_journal_*"))


_FAILING = """
import sys
from pepper_tpu_torch.utils import bench

def boom(*args, **kwargs):
    raise RuntimeError("the stage failed")

setattr(bench, {stage!r}, boom)
sys.exit(bench.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("stage", ["encode_all", "device_inference_only"])
def test_a_failing_stage_exits_non_zero(tmp_path, stage):
    p = subprocess.run(
        [sys.executable, "-c", _FAILING.format(stage=stage), *SMALL,
         "--cache-dir", str(tmp_path)], cwd=REPO,
        env=dict(os.environ, **SMALL_ENV), capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert "the stage failed" in p.stderr
    assert "variant_e2e_throughput" not in p.stdout


def test_baselines_restore_the_thread_count():
    threads = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        images = np.random.default_rng(0).integers(
            -125, 126, (6, 33, 26)).astype(np.int8)
        assert bench.torch_cpu_inference(images, batch=4) > 0
        assert torch.get_num_threads() == 3
        assert bench.torch_polish_window_inference(2) > 0
        assert torch.get_num_threads() == 3
        assert bench.torch_train_step(4) > 0
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("tool", [bench, profile_stream])
def test_cuda_without_a_card_raises(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--mbp", str(MBP), "--cache-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []   # nothing built


def test_profile_stream_prints_its_variants(tmp_path, capsys):
    submit = streaming.DeviceRunner.submit
    assert profile_stream.main(["--mbp", str(MBP), "--reps", "1",
                                "--threads", "2", "--device", "cpu",
                                "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for name in ("stream only (no stage3)",
                 "stream + collector (gates, no vcf)",
                 "stream + collector + ordered vcf"):
        assert f"{name}: stream=" in out, out
    assert "prediction batches in the resume journal" in out
    assert "gates (batch_candidates) over all batches" in out
    assert "prediction HDF5 write alone: " in out   # h5py is installed here
    assert streaming.DeviceRunner.submit is submit


def test_device_stub_is_put_back_after_a_failure():
    submit = streaming.DeviceRunner.submit
    with pytest.raises(ValueError):
        with profile_stream.stubbed_device():
            assert streaming.DeviceRunner.submit is not submit
            raise ValueError
    assert streaming.DeviceRunner.submit is submit
