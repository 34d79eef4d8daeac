"""The port's tooling against the JAX package's: the QA tools (vcf_stats,
compare_vcfs, vcf_vaf, render_pileup and print_region_pileup,
merge_image_index) give the same outputs on the same inputs, the acceptance
harness's no-data cases (tests/test_acceptance.py, not the real-data run)
hold on the port's copy, and `stage` writes a torch.profiler trace under
PEPPER_TPU_PROFILE and none without it."""
import io
import os

import numpy as np
import pytest

from pepper_tpu.io import bam_reader as jax_bam_reader
from pepper_tpu.utils import pileup_debug as jax_pileup
from pepper_tpu.utils import train_image_index as jax_index
from pepper_tpu.utils import vcf_stats as jax_stats
from pepper_tpu.utils import vcf_vaf as jax_vaf
from pepper_tpu_torch.io import bam_reader
from pepper_tpu_torch.io.sam import FLAG_REVERSE, OP_D, OP_I, OP_M, OP_S
from pepper_tpu_torch.utils import acceptance, profiling
from pepper_tpu_torch.utils import pileup_debug as pileup
from pepper_tpu_torch.utils import train_image_index as index
from pepper_tpu_torch.utils import vcf_stats as stats
from pepper_tpu_torch.utils import vcf_vaf as vaf
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset)

HEADER = ("##fileformat=VCFv4.2\n"
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")


def write_vcf(path, records):
    """records: (contig, 1-based pos, ref, alts, gt, filter[, vaf])."""
    lines = []
    for contig, pos1, ref, alts, gt, filt, *rest in records:
        fmt, sample = ("GT:VAF", f"{gt}:{rest[0]}") if rest else ("GT", gt)
        lines.append(f"{contig}\t{pos1}\t.\t{ref}\t{','.join(alts)}\t30\t"
                     f"{filt}\t.\t{fmt}\t{sample}")
    with open(path, "w") as fh:
        fh.write(HEADER + "\n".join(lines) + "\n")
    return str(path)


# ------------------------------------------------------------ QA tools
def test_vcf_stats_and_compare_match_jax(tmp_path):
    a = write_vcf(tmp_path / "a.vcf", [
        ("c1", 10, "A", ["T"], "0/1", "PASS"),
        ("c1", 20, "AT", ["A"], "1/1", "PASS"),
        ("c1", 30, "G", ["GC"], "0/0", "refCall"),
        ("c2", 5, "C", ["G", "CTT"], "1/2", "PASS")])
    b = write_vcf(tmp_path / "b.vcf", [
        ("c1", 10, "A", ["T"], "1/1", "PASS"),
        ("c1", 40, "C", ["G"], "0/1", "PASS")])
    got = stats.vcf_stats(a)
    assert got == jax_stats.vcf_stats(a)
    assert got["total"] == 4 and got["kinds"]["INSERT"] == 2
    got = stats.compare_vcfs(a, b)
    assert got == jax_stats.compare_vcfs(a, b)
    assert got["shared"] == 1 and got["only_a"] == 3 and got["only_b"] == 1


def test_vcf_vaf_matches_jax(tmp_path, capsys):
    path = write_vcf(tmp_path / "v.vcf", [
        ("c1", 10, "A", ["T"], "0/1", "PASS", "0.5"),
        ("c1", 20, "A", ["T", "G"], "1/1", "PASS", "0.8,0.1"),
        ("c1", 30, "G", ["C"], "0/0", "refCall", "0.05"),
        ("c1", 40, "G", ["C"], "0/1", "PASS", "0.33")])
    got = vaf.collect_vafs(path)
    assert got == jax_vaf.collect_vafs(path)
    assert sorted(got["true"]) == [0.33, 0.5, 0.8] and got["false"] == [0.1]
    outputs = []
    for main in (vaf.main, jax_vaf.main):
        assert main(["-v", path, "--no_plot"]) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert "Total true alleles:\t 3" in outputs[0]


def _pileup_reads(read_type):
    ref = "ACGTACGTAC"

    def mk(pos, seq, cigar, name, reverse=False):
        span = sum(n for op, n in cigar if op in (OP_M, OP_D))
        return read_type(query_name=name, pos=pos, pos_end=pos + span,
                         sequence=seq, base_qualities=[30] * len(seq),
                         cigar_tuples=cigar, mapping_quality=60,
                         flags=FLAG_REVERSE if reverse else 0, hp_tag=0,
                         bad_indices=[])

    return ref, [
        mk(0, ref, [(OP_M, 10)], "match"),
        mk(0, "ACGTTCGTAC", [(OP_M, 10)], "mm", reverse=True),
        mk(0, ref[:4] + ref[6:], [(OP_M, 4), (OP_D, 2), (OP_M, 4)], "del"),
        mk(2, "GG" + ref[2:5] + "TT" + ref[5:8],
           [(OP_S, 2), (OP_M, 3), (OP_I, 2), (OP_M, 3)], "ins")]


@pytest.mark.parametrize("width", [120, 4])
def test_render_pileup_matches_jax(width):
    ref, reads = _pileup_reads(bam_reader.TrimmedRead)
    _, jax_reads = _pileup_reads(jax_bam_reader.TrimmedRead)
    got = pileup.render_pileup(ref, 0, reads, width=width)
    assert got == jax_pileup.render_pileup(ref, 0, jax_reads, width=width)
    if width == 120:
        assert "REF ACGTACGTAC" in got and "....T....." in got
        assert "....**...." in got


def test_print_region_pileup_matches_jax(tmp_path):
    genome = random_genome(1500, seed=5)
    variants = plant_variants(dict(genome), 2, 1, 1, seed=6)
    fasta, bam = write_dataset(str(tmp_path), genome, simulate_reads(
        genome, variants, coverage=4, seed=7, read_length=300))
    outs = []
    for mod in (pileup, jax_pileup):
        stream = io.StringIO()
        mod.print_region_pileup(bam, fasta, genome[0][0], 200, 330,
                                stream=stream)
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") > 3


def test_merge_image_index_matches_jax(tmp_path):
    import h5py
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for name, regions in [("a.hdf5", {"r1": 3, "r2": 2}), ("b.hdf5", {"q": 4}),
                          ("c.hdf", {})]:
        with h5py.File(img_dir / name, "w") as fh:
            for region, n in regions.items():
                fh.create_dataset(f"summaries/{region}/images",
                                  data=np.zeros((n, 33, 26), np.int8))
    contents = []
    for mod, out in ((index, "torch"), (jax_index, "jax")):
        path = mod.merge_image_index(str(img_dir), str(tmp_path / out),
                                     verbose=False)
        with h5py.File(path, "r") as fh:
            contents.append({k: fh[k][()] for k in fh.keys()})
    assert contents[0] == contents[1] and len(contents[0]) == 9


# ----------------------------------------------- acceptance (no data)
def test_evaluate_allele_match_normalization_and_bed(tmp_path):
    """tests/test_acceptance.py's comparator cases on the port's copy."""
    truth = write_vcf(tmp_path / "truth.vcf", [
        ("chr20", 1000100, "A", ["C"], "0/1", "PASS"),
        ("chr20", 1000200, "G", ["GTT"], "1/1", "PASS"),
        ("chr20", 1000300, "T", ["A"], "0|1", "PASS"),
        ("chr20", 1000400, "AT", ["CT"], "0/1", "PASS"),
        ("chr20", 2000000, "T", ["A"], "0/1", "PASS")])
    ours = write_vcf(tmp_path / "ours.vcf", [
        ("chr20", 1000100, "A", ["C"], "0/1", "PASS"),
        ("chr20", 1000200, "G", ["GTT"], "0/1", "PASS"),
        ("chr20", 1000400, "A", ["C", "G"], "0/1", "PASS"),
        ("chr20", 1000450, "C", ["G"], "1/1", "PASS"),
        ("chr20", 1000500, "C", ["G"], "0/0", "refCall"),
        ("chr20", 1000600, "C", ["G"], "0/1", "lowQUAL")])
    rep = acceptance.evaluate(ours, truth, None,
                              region="chr20:1000000-1020000")
    assert rep["SNP"] == dict(truth_total=3, tp=2, fn=1, fp=1,
                              recall=0.666667, precision=0.666667,
                              f1=0.666667)
    assert rep["INDEL"]["tp"] == 1 and rep["INDEL"]["f1"] == 1.0
    bed = tmp_path / "conf.bed"
    bed.write_text("chr20\t1000000\t1000150\n")
    rep = acceptance.evaluate(ours, truth, str(bed),
                              region="chr20:1000000-1020000")
    assert rep["SNP"]["truth_total"] == 1 and rep["SNP"]["recall"] == 1.0


def test_diff_records_and_verdict(tmp_path):
    a = write_vcf(tmp_path / "a.vcf", [("chr20", 10, "A", ["C"], "0/1", "PASS"),
                                       ("chr20", 20, "G", ["T"], "1/1", "PASS")])
    b = write_vcf(tmp_path / "b.vcf", [("chr20", 10, "A", ["C"], "0/1", "PASS"),
                                       ("chr20", 30, "G", ["T"], "1/1", "PASS")])
    assert acceptance.diff_records(a, b) == dict(identical=1, only_ours=1,
                                                 only_expected=1)
    good = {"SNP": dict(recall=1.0), "INDEL": dict(recall=1.0)}
    assert acceptance.acceptance_verdict(good) is True
    assert acceptance.acceptance_verdict(
        good, dict(identical=10, only_ours=0, only_expected=0)) is True
    assert acceptance.acceptance_verdict(
        good, dict(identical=9, only_ours=1, only_expected=0)) is False
    assert acceptance.acceptance_verdict(
        {"SNP": dict(recall=0.8), "INDEL": dict(recall=1.0)}) is False


def test_acceptance_offline_skip_is_clean(tmp_path):
    """No data and no network: the harness skips with 0, never raises; the
    CLI asks for the card by default."""
    assert acceptance.run_acceptance(str(tmp_path / "nodata"), None,
                                     str(tmp_path / "out")) == 0
    assert acceptance.main(["--data_dir", str(tmp_path / "nodata2"),
                            "--out", str(tmp_path / "out2")]) == 0
    import inspect
    assert inspect.signature(acceptance.run_acceptance).parameters[
        "device"].default == "cuda"


# ------------------------------------------------------------ profiling
def _traces(root):
    return [os.path.join(d, f) for d, _, files in os.walk(root)
            for f in files if f.endswith(".pt.trace.json")]


def test_stage_writes_a_torch_profiler_trace_under_the_variable(
        tmp_path, monkeypatch, capsys):
    import torch
    root = tmp_path / "prof"
    monkeypatch.setenv("PEPPER_TPU_PROFILE", str(root))
    with profiling.stage("encode"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = _traces(root)
    assert len(traces) == 1
    assert os.path.dirname(traces[0]) == str(root / "encode")
    with open(traces[0]) as fh:
        assert "aten::mm" in fh.read()
    assert "STAGE encode TOOK" in capsys.readouterr().err
    monkeypatch.delenv("PEPPER_TPU_PROFILE")
    with profiling.stage("quiet"):
        pass
    assert _traces(root) == traces and not (root / "quiet").exists()
    assert "STAGE quiet TOOK" in capsys.readouterr().err
