"""VCF statistics and comparison — manual QA tools.

Role parity: reference helper/{vcf_stat_test,merge_vcf_test,test_vcf}.py —
per-VCF type/genotype counts and positional set comparison of two VCFs.

The port's copy of pepper_tpu/utils/vcf_stats.py, with its imports rewritten
to pepper_tpu_torch.*.
"""
from collections import Counter
from typing import Dict, Tuple

from pepper_tpu_torch.io.vcf import read_vcf


def variant_kind(ref: str, alt: str) -> str:
    if len(ref) == len(alt) == 1:
        return "SNP"
    return "INSERT" if len(alt) > len(ref) else "DELETE"


def vcf_stats(path: str) -> Dict:
    """Counts by type / genotype / filter."""
    kinds = Counter()
    genotypes = Counter()
    filters = Counter()
    total = 0
    for rec in read_vcf(path):
        total += 1
        for f in rec.filters or ["."]:
            filters[f] += 1
        gt = rec.genotype()
        genotypes["/".join(map(str, sorted(gt)))] += 1
        for alt in rec.alts:
            kinds[variant_kind(rec.ref, alt)] += 1
    return dict(total=total, kinds=dict(kinds), genotypes=dict(genotypes),
                filters=dict(filters))


def compare_vcfs(path_a: str, path_b: str) -> Dict:
    """Positional allele-set comparison: shared / only-a / only-b, plus
    genotype concordance on shared records."""
    def load(path):
        out = {}
        for rec in read_vcf(path):
            out[(rec.contig, rec.pos, rec.ref, tuple(sorted(rec.alts)))] = \
                tuple(sorted(rec.genotype()))
        return out

    a, b = load(path_a), load(path_b)
    shared = set(a) & set(b)
    gt_match = sum(1 for k in shared if a[k] == b[k])
    return dict(
        total_a=len(a), total_b=len(b), shared=len(shared),
        only_a=len(a) - len(shared), only_b=len(b) - len(shared),
        genotype_concordance=(gt_match / len(shared)) if shared else 1.0)


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    parser = argparse.ArgumentParser(
        prog="pepper_vcf_stats", description="VCF stats / comparison.")
    parser.add_argument("vcf", help="VCF to summarize.")
    parser.add_argument("--compare", default=None,
                        help="Second VCF: positional comparison.")
    args = parser.parse_args(argv)
    print(json.dumps(vcf_stats(args.vcf), indent=2))
    if args.compare:
        print(json.dumps(compare_vcfs(args.vcf, args.compare), indent=2))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
