"""The port's merge_variants (pipelines/merge_variants.py) against the JAX
package's: a DeepVariant VCF positionally overlays the PEPPER VCF, each
record tagged C=P or C=DV, bgzipped and indexed. Mirrors the overlay of
tests/test_pipeline.py and holds the port's output to the JAX package's,
byte for byte once decompressed, on the same inputs."""
import gzip
import os

import pytest

from pepper_tpu.pipelines.merge_variants import \
    merge_variants as jax_merge_variants
from pepper_tpu_torch.io.vcf import read_vcf
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.pipelines.merge_variants import merge_variants
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset,
                                          write_truth_vcf)


@pytest.fixture(scope="module")
def pepper_vcfs(tmp_path_factory):
    """The port's five VCFs of a dry call_variant run (the oracle backend:
    the train labels become the predictions, so the planted variants are
    called with high confidence) on a two-contig synthetic dataset."""
    tmp = str(tmp_path_factory.mktemp("torch_merge"))
    genome = random_genome(8000, seed=41, n_contigs=2)
    variants = plant_variants(dict(genome), 6, 2, 2, seed=42)
    fasta, bam = write_dataset(tmp, genome, simulate_reads(
        genome, variants, coverage=35, seed=43))
    truth = write_truth_vcf(os.path.join(tmp, "truth.vcf"), genome,
                            variants)
    paths = call_variant(set_parameters(PipelineConfig(
        bam=bam, fasta=fasta, output_dir=tmp + "/out/",
        sub_command="call_variant", ont_r9_guppy5_sup=True, threads=1,
        dry=True, train_mode=True, truth_vcf=truth,
        random_draw_probability=1.0, device="cpu")))
    assert len(read_vcf(paths["pepper"])) >= 6
    return dict(tmp=tmp, **paths)


def _is_snp(rec):
    return len(rec.ref) == 1 and all(len(a) == 1 for a in rec.alts)


def _write_dv(path, pepper_full, every=2, keep=lambda rec: True,
              contigs=("contig1", "contig2")):
    """A DeepVariant-style VCF (AD with the ref depth first) at every
    `every`-th position of the PEPPER FULL VCF that `keep` takes."""
    head = ["##fileformat=VCFv4.2"]
    head += [f"##contig=<ID={c},length=8000>" for c in contigs]
    head.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDV")
    body = []
    for k, rec in enumerate(read_vcf(pepper_full)):
        if k % every or rec.contig not in contigs or not keep(rec):
            continue
        alts = ",".join(rec.alts) or "."
        body.append(f"{rec.contig}\t{rec.pos + 1}\t.\t{rec.ref}\t{alts}\t"
                    f"{30 + k}.5\t{'PASS' if k % 4 else 'RefCall'}\t.\t"
                    f"GT:GQ:DP:AD:VAF\t0/1:{20 + k}:30:{15 + k},{k}:0.5")
    with open(path, "w") as fh:
        fh.write("\n".join(head + body) + "\n")
    return path


def _decompressed(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def test_merge_variants_positional_overlay(pepper_vcfs):
    out_dir = pepper_vcfs["tmp"] + "/overlay"
    os.makedirs(out_dir)
    out = merge_variants(pepper_vcfs["pepper"], pepper_vcfs["full"], None,
                         None, out_dir)
    merged = read_vcf(out)
    assert merged and os.path.isfile(out + ".tbi")
    # overlaying FULL onto PEPPER: every position is in the DV file
    for rec in merged:
        assert rec.samples[0][rec.format.index("C")] == "DV"


@pytest.mark.parametrize("split", [False, True])
def test_merge_variants_matches_jax(pepper_vcfs, split):
    tmp = pepper_vcfs["tmp"]
    if split:   # SNPs and indels in two DeepVariant files
        dv = (None, _write_dv(tmp + "/dv_snps.vcf", pepper_vcfs["full"],
                              keep=_is_snp),
              _write_dv(tmp + "/dv_indels.vcf", pepper_vcfs["full"],
                        keep=lambda rec: not _is_snp(rec)))
    else:
        dv = (_write_dv(tmp + "/dv.vcf", pepper_vcfs["full"], 3), None, None)
    base = pepper_vcfs["pepper"]
    outs = {}
    for name, fn in (("port", merge_variants), ("jax", jax_merge_variants)):
        out_dir = os.path.join(tmp, f"merged_{name}_{split}")
        os.makedirs(out_dir)
        outs[name] = fn(base, *dv, out_dir, "HG002")
        assert os.path.isfile(outs[name] + ".tbi")
    got, want = (_decompressed(outs[k]) for k in ("port", "jax"))
    assert got == want
    with open(outs["port"] + ".tbi", "rb") as a, \
            open(outs["jax"] + ".tbi", "rb") as b:
        assert a.read() == b.read()
    merged = read_vcf(outs["port"])
    tags = [r.samples[0][r.format.index("C")] for r in merged]
    assert "DV" in tags and "P" in tags
    assert b"\tHG002\n" in got


def test_merge_variants_needs_a_deepvariant_vcf(pepper_vcfs):
    with pytest.raises(ValueError, match="vcf_deepvariant"):
        merge_variants(pepper_vcfs["pepper"], None, None, None,
                       pepper_vcfs["tmp"])


def test_cli_merge_variants_matches_the_api(pepper_vcfs):
    from pepper_tpu_torch.cli.pepper_variant_main import main

    tmp = pepper_vcfs["tmp"]
    dv = _write_dv(tmp + "/dv_cli.vcf", pepper_vcfs["full"], 3)
    api_dir, cli_dir = tmp + "/merged_api", tmp + "/merged_cli"
    os.makedirs(api_dir)
    os.makedirs(cli_dir)
    want = merge_variants(pepper_vcfs["pepper"], dv, None, None, api_dir,
                          "Sample")
    assert main(["merge_variants", "-vp", pepper_vcfs["pepper"], "-vd", dv,
                 "-o", cli_dir]) == 0
    got = os.path.join(cli_dir, "PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz")
    assert _decompressed(got) == _decompressed(want)
