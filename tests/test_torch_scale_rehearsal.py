"""The port's scale rehearsal (pepper_tpu_torch/utils/scale_rehearsal.py) end
to end at a tiny size on the CPU, and the slice against the JAX package:

- the rehearsal at 0.2 Mbp over 3 contigs (3 intervals, so the kill after
  half of the batches always lands after at least one whole interval):
  its JSON record, exit 9 on the kill, a replayed interval, the journal
  gone after the resume, and 5 VCFs byte-identical to the uninterrupted
  run's;
- on the rehearsal's own dataset and .npz weights, the JAX call_variant
  (f32, CPU) and the port's uninterrupted run write the same (contig, pos,
  ref, alt, GT) records in all 5 VCFs (exact);
- the port's utils/synth.py makes the same genome, reads and BAM/FASTA
  bytes as tests/util/synth.py, the JAX rehearsal's generator, for the
  rehearsal's seeds and sizes.
"""
import dataclasses
import glob
import gzip
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from pepper_tpu.options import PipelineConfig as JaxPipelineConfig
from pepper_tpu.pipelines.call_variant import call_variant as jax_call_variant
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.utils import scale_rehearsal
from pepper_tpu_torch.utils import synth as port_synth
from tests.util import synth as jax_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBP, CONTIGS = 0.2, 3
KEYS = {
    "mbp", "contigs", "coverage", "read_len", "bam_mb", "device",
    "precision", "batch_floor", "e2e_wall_s", "mbp_per_s", "stream_s",
    "watermark_tail_s", "peak_rss_mb", "rss_mb_thirds", "peak_device_mb",
    "rss_parts_mb", "peak_device_mb_thirds", "candidates",
    "prediction_store_mb", "stream_breakdown", "device_busy_s",
    "device_idle_share", "k1_launches", "cold_wall_s",
    "repeat_byte_identical", "crash_after_batches", "crash_exit_code",
    "journal_mb_at_crash", "resume_replayed", "resume_wall_s",
    "resume_peak_rss_mb", "resume_k1_launches", "resume_byte_identical",
    "first_difference"}


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("torch_scale"))
    out = os.path.join(cache, "record.json")
    # two torch threads a run: the f32 forward is most of its work, and
    # beside other test workers a wide intra-op pool mostly waits
    env = dict(os.environ, PEPPER_TPU_MIN_DEVICE_BATCH="16",
               OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.scale_rehearsal",
         "--device", "cpu", "--mbp", str(MBP), "--contigs", str(CONTIGS),
         "--out", out, "--cache-dir", cache],
        cwd=REPO, env=env, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-4000:]
    with open(out) as fh:
        record = json.load(fh)
    assert json.loads(p.stdout.decode().splitlines()[-1]) == record
    (data_dir,) = glob.glob(os.path.join(cache, "*", "reads.bam"))
    return record, os.path.dirname(data_dir)


def test_rehearsal_resumes_byte_identical(rehearsal):
    record, data = rehearsal
    assert set(record) == KEYS
    assert record["device"] == "cpu" and record["precision"] == "f32"
    assert record["batch_floor"] == 512   # the config's batch above 16
    assert record["candidates"] > 4 * record["batch_floor"]
    assert record["crash_after_batches"] == math.ceil(
        record["candidates"] / record["batch_floor"] / 2)
    assert record["crash_exit_code"] == 9
    replayed, total = map(int, record["resume_replayed"].split("/"))
    assert total == CONTIGS and 1 <= replayed < total
    assert record["resume_byte_identical"] is True
    assert record["first_difference"] is None
    assert record["repeat_byte_identical"] is True
    assert not glob.glob(os.path.join(data, "crash_out",
                                      "pepper_stream_*resume.journal"))
    assert record["peak_device_mb"] is None   # no card: not measured
    assert record["device_busy_s"] is None is record["device_idle_share"]
    assert record["peak_rss_mb"] > 0 and len(record["rss_mb_thirds"]) == 3
    start, end = record["rss_parts_mb"]["start"], record["rss_parts_mb"]["end"]
    assert "pinned_host_mb" not in end   # no card: no pinned staging
    for parts in (start, end):
        assert parts["libraries"] > 0 and parts["anonymous"] > 0
        assert parts["VmHWM"] >= parts["VmRSS"] > 0
    assert end["VmHWM"] >= start["VmHWM"]
    assert "encode" in record["stream_breakdown"]
    # on the CPU the forward runs K1's plain version: nothing launches
    assert record["k1_launches"] == 0 == record["resume_k1_launches"]


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


def test_port_calls_the_jax_records_on_the_rehearsal_dataset(
        rehearsal, tmp_path, monkeypatch):
    _, data = rehearsal
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "16")
    monkeypatch.setenv("PEPPER_TPU_PRECISION", "f32")
    out = str(tmp_path / "jax_out") + "/"
    jax_call_variant(jax_set_parameters(JaxPipelineConfig(
        bam=data + "/reads.bam", fasta=data + "/ref.fa", output_dir=out,
        sub_command="call_variant", ont_r9_guppy5_sup=True, threads=2,
        model_path=data + "/model.npz")))
    want = _records(out)
    got = _records(os.path.join(data, "ref_out"))
    assert len(want) == 5 and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert sum(len(v) for v in want.values()) >= 10


def test_port_synth_matches_the_jax_rehearsal_generator(tmp_path):
    """The rehearsal's seeds, rates and sizes, through both generators and
    both writers (the port's SAM encoding is vectorised)."""
    out = {}
    for name, synth in (("port", port_synth), ("jax", jax_synth)):
        genome = synth.random_genome(int(MBP * 1e6 / CONTIGS), seed=21,
                                     n_contigs=CONTIGS)
        variants = synth.plant_variants(dict(genome), int(800 * MBP),
                                        int(100 * MBP), int(100 * MBP),
                                        seed=22)
        records = synth.simulate_reads_fast(genome, variants, coverage=30,
                                            read_length=10_000,
                                            error_rate=0.08, seed=23)
        os.makedirs(tmp_path / name)
        fasta, bam = synth.write_dataset(str(tmp_path / name), genome,
                                         records)
        out[name] = (genome, [dataclasses.astuple(v) for v in variants], [
            (r.query_name, r.flag, r.ref_id, r.pos, r.mapq,
             [tuple(c) for c in r.cigar], r.seq, list(r.qual), r.tags)
            for r in records], fasta, bam)
    port, jax_ = out["port"], out["jax"]
    assert port[0] == jax_[0]
    assert port[1] == jax_[1] and len(port[1]) == CONTIGS * int(1000 * MBP)
    assert port[2] == jax_[2] and len(port[2]) > 100
    for k in (3, 4):
        with open(port[k], "rb") as a, open(jax_[k], "rb") as b:
            assert a.read() == b.read(), port[k]


def test_rss_parts_accounts_for_the_resident_set():
    """rss_parts' kinds, summed over /proc/self/smaps, make up the
    process's VmRSS (within 5%: the two files are read one after the
    other), and the largest libraries are among the libraries."""
    parts = scale_rehearsal.rss_parts()
    kinds = sum(parts.get(k, 0.0) for k in ("libraries", "device_files",
                                              "anonymous", "other_files"))
    assert abs(kinds - parts["VmRSS"]) <= 0.05 * parts["VmRSS"]
    assert abs(parts["RssAnon"] + parts["RssFile"] + parts["RssShmem"]
               - parts["VmRSS"]) <= 0.2
    top = parts["top_libraries"]
    assert 1 <= len(top) <= 6 and sum(top.values()) <= parts["libraries"]
    assert any(name.startswith("libtorch") for name in top), top


def test_scale_rehearsal_on_cuda_without_a_card_raises(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_rehearsal.main(["--mbp", "0.01", "--contigs", "1",
                              "--cache-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []   # nothing built
