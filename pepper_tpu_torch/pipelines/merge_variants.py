"""Merge PEPPER-kept VCF with DeepVariant re-genotyped VCF(s).

Parity: pepper_variant/modules/python/MergeVariants.py:8-79 +
MergedVcfWriter.py:20-52 — DeepVariant records positionally override PEPPER
records; each output record carries a C=P/DV FORMAT tag; output is
PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz, bgzipped + tabixed.
"""
import re
import sys
from datetime import datetime
from typing import Dict, Optional, Tuple

from pepper_tpu_torch.io.vcf import IndexedVcfWriter, VcfRecord, read_vcf


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def _header_contigs_and_sample(path: str) -> Tuple[list, str]:
    contigs, sample = [], "Sample"
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        from pepper_tpu_torch.io.bgzf import BGZFReader
        lines = BGZFReader(path).read_all().decode().splitlines()
    else:
        with open(path) as fh:
            lines = fh.read().splitlines()
    for line in lines:
        if line.startswith("##contig"):
            m = re.search(r"ID=([^,>]+).*?length=(\d+)", line)
            if m:
                contigs.append((m.group(1), int(m.group(2))))
        elif line.startswith("#CHROM"):
            fields = line.split("\t")
            if len(fields) > 9:
                sample = fields[9]
            break
    return contigs, sample


def _merged_header(sample_name: str, contigs) -> str:
    lines = ["##fileformat=VCFv4.2"]
    lines += [
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FILTER=<ID=refCall,Description="Call is homozygous">',
        '##FILTER=<ID=lowGQ,Description="Low genotype quality">',
        '##FILTER=<ID=lowQUAL,Description="Low variant call quality">',
        '##FILTER=<ID=conflictPos,Description="Overlapping record">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=AD,Number=A,Type=Integer,Description="Allele depth">',
        '##FORMAT=<ID=VAF,Number=A,Type=Float,Description="Variant allele fractions.">',
        '##FORMAT=<ID=GQ,Number=1,Type=Float,Description="Genotype Quality">',
        '##FORMAT=<ID=C,Number=1,Type=String,Description="Genotyper P=PEPPER DV=DeepVariant">',
    ]
    for name, length in contigs:
        lines.append(f"##contig=<ID={name},length={length}>")
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + sample_name)
    return "\n".join(lines) + "\n"


def _sample_field(rec: VcfRecord, key: str) -> str:
    if key in rec.format:
        return rec.samples[0][rec.format.index(key)]
    return "."


def _merged_line(rec: VcfRecord, is_dv: bool) -> str:
    filt = "PASS" if "PASS" in rec.filters else "refCall"
    ad = _sample_field(rec, "AD")
    if is_dv and ad != ".":
        # DeepVariant AD includes the ref allele; drop it (MergedVcfWriter.py:31)
        ad = ",".join(ad.split(",")[1:]) or "."
    fields = [
        rec.contig, str(rec.pos + 1), rec.id or ".", rec.ref,
        ",".join(rec.alts) or ".",
        ("." if rec.qual is None else format(rec.qual, ".6g")),
        filt, ".", "GT:GQ:DP:AD:VAF:C",
        ":".join([
            _sample_field(rec, "GT"), _sample_field(rec, "GQ"),
            _sample_field(rec, "DP"), ad, _sample_field(rec, "VAF"),
            "DV" if is_dv else "P",
        ]),
    ]
    return "\t".join(fields) + "\n"


def merge_variants(vcf_pepper: str, vcf_deepvariant: Optional[str],
                   vcf_deepvariant_snps: Optional[str],
                   vcf_deepvariant_indels: Optional[str],
                   output_dir: str, sample_name: Optional[str] = None) -> str:
    positional_dv: Dict[Tuple[str, int], VcfRecord] = {}
    if vcf_deepvariant:
        dv_files = [vcf_deepvariant]
    else:
        if not (vcf_deepvariant_snps and vcf_deepvariant_indels):
            raise ValueError("provide --vcf_deepvariant or both "
                             "--vcf_deepvariant_snps/--vcf_deepvariant_indels")
        dv_files = [vcf_deepvariant_snps, vcf_deepvariant_indels]
    total_dv_records = 0
    for path in dv_files:
        for rec in read_vcf(path):
            positional_dv[(rec.contig, rec.pos)] = rec
            total_dv_records += 1
    _log(f"TOTAL VARIANTS IN DeepVariant: {total_dv_records}")

    contigs, pepper_sample = _header_contigs_and_sample(vcf_pepper)
    sample_name = sample_name or pepper_sample

    out_path = output_dir.rstrip("/") + "/PEPPER_MARGIN_DEEPVARIANT_OUTPUT.vcf.gz"
    writer = IndexedVcfWriter(out_path, _merged_header(sample_name, contigs))
    total_p, total_dv, total_pass = 0, 0, 0
    for rec in read_vcf(vcf_pepper):
        key = (rec.contig, rec.pos)
        if key in positional_dv:
            final, is_dv = positional_dv[key], True
            total_dv += 1
        else:
            final, is_dv = rec, False
            total_p += 1
        if "PASS" in final.filters:
            total_pass += 1
        writer.write_record(final.contig, final.pos, final.stop,
                            _merged_line(final, is_dv))
    writer.close()
    _log(f"TOTAL VARIANTS FROM PEPPER: {total_p}")
    _log(f"TOTAL VARIANTS FROM DEEPVARIANT: {total_dv}")
    _log(f"TOTAL PASS VARIANTS: {total_pass}")
    return out_path
