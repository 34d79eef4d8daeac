"""The resume journal's run setting (runtime/resume.py::run_setting): a
journal written under another setting than the resuming run's (the
runner's effective dtype or mesh size, or polish's realignment flag)
changes the predictions, so the streamed call_variant and polish discard
it and encode everything again; under their own setting they replay it.
The classifier here is narrow (hidden 8): the journal, not the forward,
is under test."""
import os

import pytest
import torch

from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.models.polish_model import init_polish_params
from pepper_tpu_torch.models.variant_model import init_variant_params
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.runtime import resume
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, simulate_reads_fast,
                                          write_dataset)


@pytest.fixture(autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_resume_setting"))
    genome = random_genome(24000, seed=81)
    variants = plant_variants(dict(genome), 10, 3, 3, seed=82)
    fasta, bam = write_dataset(tmp, genome, simulate_reads(
        genome, variants, coverage=30, seed=83, error_rate=0.08))
    model = os.path.join(tmp, "model.npz")
    save_checkpoint(model, init_variant_params(
        torch.Generator().manual_seed(3), hidden=8), {})
    return dict(tmp=tmp, fasta=fasta, bam=bam, model=model)


def _stream(ds, out_dir, journal):
    """One in-process streamed encode+inference on the CPU (f32, one
    replica) with `journal`, which it leaves in place; returns (candidate
    count, config, intervals)."""
    from pepper_tpu_torch.pipelines.make_images import build_intervals
    from pepper_tpu_torch.runtime.streaming import stream_inference

    config = set_parameters(PipelineConfig(
        bam=ds["bam"], fasta=ds["fasta"], output_dir=out_dir,
        sub_command="call_variant", ont_r9_guppy5_sup=True, threads=2,
        model_path=ds["model"], region_size=4000, device="cpu"))
    intervals = sorted(build_intervals(config), key=lambda iv: iv[:2])
    os.makedirs(out_dir, exist_ok=True)
    n = stream_inference(config, intervals, out_dir + "preds.hdf",
                         resume_journal=journal)
    return n, config, intervals


@pytest.mark.parametrize("setting, replayed", [
    ((torch.float32, 1), True),      # the CPU run's own setting
    ((torch.bfloat16, 1), False),    # a card run's default dtype
    ((torch.float32, 2), False),     # the other mesh size
])
def test_journal_of_another_setting_is_discarded(dataset, monkeypatch,
                                                 capfd, setting, replayed):
    """A complete journal of a CPU run, fingerprinted as if `setting` had
    written it: the CPU resume replays it only under its own setting, and
    otherwise encodes everything again and writes a journal of its own."""
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "16")
    out = os.path.join(dataset["tmp"], f"setting_{setting[0]}_{setting[1]}/")
    journal = out + "resume.journal"
    n, config, intervals = _stream(dataset, out, journal)
    assert len(intervals) > 1
    inputs = (config.bam, config.fasta)
    own = resume.run_setting(torch.float32, 1)
    totals, records = resume.load_journal(journal, intervals,
                                          config.model_path, inputs, own)
    assert sum(totals.values()) == n
    done = resume.completed_intervals(totals, records)
    assert len(done) == len(intervals)
    resume.compact_journal(journal, intervals, config.model_path, inputs,
                           done, records, resume.run_setting(*setting))
    capfd.readouterr()
    assert _stream(dataset, out, journal)[0] == n
    err = capfd.readouterr().err
    assert (f"RESUME: {len(intervals)}/{len(intervals)} INTERVALS" in err) \
        is replayed, err[-2000:]
    # the journal now holds the CPU run's setting either way
    assert resume.load_journal(journal, intervals, config.model_path,
                               inputs, own) is not None
    if not replayed:
        assert resume.load_journal(journal, intervals, config.model_path,
                                   inputs, resume.run_setting(*setting)
                                   ) is None


def test_run_setting_names_dtype_mesh_and_flags():
    key = resume.run_setting(torch.bfloat16, 2, realignment_flag=False)
    assert key == ("dtype=torch.bfloat16", "mesh=2",
                   "realignment_flag=False")
    fp = [resume._fingerprint([("c", 0, 9)], "m.npz", (), s) for s in (
        key, resume.run_setting(torch.bfloat16, 2, realignment_flag=True),
        resume.run_setting(torch.float32, 2, realignment_flag=False),
        resume.run_setting(torch.bfloat16, 1, realignment_flag=False))]
    assert len(set(fp)) == 4


@pytest.fixture(scope="module")
def polish_dataset(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_polish_resume_setting"))
    genome = random_genome(8000, seed=81, n_contigs=4)   # 4 x 2kb contigs
    edits = plant_variants(dict(genome), 8, 2, 2, seed=82)
    edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in edits]
    draft, bam = write_dataset(tmp, genome, simulate_reads_fast(
        genome, edits, coverage=25, read_length=1500, error_rate=0.03,
        seed=83))
    model = os.path.join(tmp, "polish_model.npz")
    save_checkpoint(model, init_polish_params(
        torch.Generator().manual_seed(4)), {})
    return dict(tmp=tmp, draft=draft, bam=bam, model=model)


@pytest.mark.parametrize("flag", [True, False])
def test_polish_journal_of_the_other_realignment_flag_is_discarded(
        polish_dataset, capfd, flag):
    """A complete polish journal written with realignment on: a resume
    with the same flag replays every interval, one with the flag off
    encodes them all again."""
    from pepper_tpu_torch.polish.streaming import stream_polish

    ds = polish_dataset
    out = os.path.join(ds["tmp"], f"realign_{flag}/")
    os.makedirs(out)
    journal = out + "journal"
    # one torch thread: the plain biGRU loops issue thousands of tiny ops,
    # and beside other test workers an intra-op pool mostly waits
    torch.set_num_threads(1)

    def run(realign):
        return stream_polish(ds["bam"], ds["draft"], ds["model"],
                             out + "pred.hdf", threads=2,
                             realignment_flag=realign,
                             resume_journal=journal, device="cpu")

    n = run(True)
    capfd.readouterr()
    assert run(flag) == n
    err = capfd.readouterr().err
    assert ("INTERVALS REPLAYED FROM JOURNAL" in err) is flag, err[-2000:]
