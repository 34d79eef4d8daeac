"""VAF true/false-allele distribution from a genotyped VCF — manual QA tool.

Role parity: reference helper/vcf_plot_vaf.py + the VAF sections of
helper/vcf_stat_test.py — for each PASS record, split per-ALT allele
fractions into "true" (allele index appears in GT) and "false" (called as
an ALT candidate but not genotyped), print the totals, and render the
stacked histogram. Rendering uses matplotlib when available; the counts
and a text histogram always print, so the tool works headless.

The port's copy of pepper_tpu/utils/vcf_vaf.py, with its imports rewritten
to pepper_tpu_torch.*.
"""
import argparse
from typing import Dict, List

from pepper_tpu_torch.io.vcf import read_vcf


def collect_vafs(path: str) -> Dict[str, List[float]]:
    true_vafs: List[float] = []
    false_vafs: List[float] = []
    all_vafs: List[float] = []
    total_recs = 0
    total_alts = 0
    for rec in read_vcf(path):
        total_recs += 1
        total_alts += len(rec.alts)
        if rec.filters and rec.filters[0] != "PASS":
            continue
        if "VAF" not in rec.format or "GT" not in rec.format:
            continue
        for sample in rec.samples:
            vafs = [float(v) for v in
                    sample[rec.format.index("VAF")].split(",")]
            gts = rec.genotype()
            true_index = [g - 1 for g in gts if g != 0]
            for i, vaf in enumerate(vafs[:len(rec.alts)]):
                (true_vafs if i in true_index else false_vafs).append(vaf)
                all_vafs.append(round(vaf, 3))
    return dict(all=all_vafs, true=true_vafs, false=false_vafs,
                total_records=total_recs, total_alts=total_alts)


def text_histogram(values: List[float], bins: int = 20, width: int = 50,
                   label: str = "") -> str:
    if not values:
        return f"{label}: (empty)"
    counts = [0] * bins
    for v in values:
        counts[min(bins - 1, max(0, int(v * bins)))] += 1
    peak = max(counts)
    lines = [f"{label} (n={len(values)})"]
    for i, c in enumerate(counts):
        bar = "#" * (int(width * c / peak) if peak else 0)
        lines.append(f"  {i / bins:4.2f}-{(i + 1) / bins:4.2f} "
                     f"{c:8d} {bar}")
    return "\n".join(lines)


def plot_distributions(true_vafs: List[float], false_vafs: List[float],
                       output_png: str) -> bool:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    plt.figure(figsize=(20, 10))
    plt.hist([true_vafs, false_vafs], bins=100, histtype="bar",
             color=["green", "red"], alpha=0.4, stacked=True,
             label=["True variants", "False positives"])
    plt.xlim((0.0, 1.15))
    plt.legend(fontsize="x-large")
    plt.xlabel("Allele frequency", fontsize=24)
    plt.ylabel("Count", fontsize=24)
    plt.title("TP and FP distribution across allele-frequency intervals",
              fontsize=20)
    plt.savefig(output_png, format="png", dpi=150)
    plt.close()
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pepper_vcf_vaf",
        description="TP/FP allele-frequency distribution of a VCF.")
    parser.add_argument("-v", "--vcf", type=str, required=True,
                        help="Genotyped VCF (must carry VAF FORMAT field).")
    parser.add_argument("--output_png", type=str,
                        default="./VAF_distribution.png",
                        help="Where to save the stacked histogram.")
    parser.add_argument("--no_plot", action="store_true", default=False)
    args = parser.parse_args(argv)
    stats = collect_vafs(args.vcf)
    n_true, n_false = len(stats["true"]), len(stats["false"])
    total = max(1, stats["total_alts"])
    print("Total positions:\t", stats["total_records"])
    print("Total alt alleles:\t", stats["total_alts"])
    print("Total true alleles:\t", n_true,
          "(" + str(int(100 * n_true / total)) + "%)")
    print("Total false alleles:\t", n_false,
          "(" + str(int(100 * n_false / total)) + "%)")
    print(text_histogram(stats["true"], label="True-allele VAF"))
    print(text_histogram(stats["false"], label="False-allele VAF"))
    if not args.no_plot and plot_distributions(stats["true"], stats["false"],
                                               args.output_png):
        print("Saved:", args.output_png)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
