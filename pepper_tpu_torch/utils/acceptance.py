"""Real-data acceptance harness — the reference's de-facto regression test.

The reference pins tiny public datasets with expected outputs: the HG002
chr20:1,000,000-1,020,000 quickstart with hap.py F1 == 1.0
(the reference's docs/quickstart/variant_calling_docker_quickstart.md:55-123).
This harness reproduces that flow against pepper_tpu:

  1. locate (or download, when the network exists) the quickstart files;
  2. import a released PEPPER r0.8 torch `.pkl` checkpoint
     (models/checkpoint.load_torch_checkpoint — lossless name-mapped
     import) or use a native `.npz`;
  3. run `call_variant` on chr20:1000000-1020000 with the
     --ont_r9_guppy5_sup preset;
  4. score SNP/INDEL precision/recall/F1 of the merged candidate set
     against the GIAB truth VCF restricted to the high-confidence bed (a
     small allele-match comparator — hap.py parity is not required);
  5. optionally diff our VCF record-by-record against a
     reference-produced expected VCF, when one is provided.

Offline (no data, no network): prints SKIPPED and exits 0 — CI-safe.

Usage:
  python -m pepper_tpu_torch.utils.acceptance --data_dir /path/to/quickstart \
      --model /path/to/PEPPER_VARIANT_ONT_R9_GUPPY5_SUP.pkl \
      [--expected /path/to/reference_PEPPER_VARIANT_FULL.vcf.gz] \
      [--out DIR] [--threads 2] [--download] [--device cuda|cpu]

The port's copy of pepper_tpu/utils/acceptance.py, with its imports
rewritten to pepper_tpu_torch.*; run_acceptance drives the port's
call_variant, checkpoint loader and presets, on `--device cuda` unless asked
otherwise.
"""
import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

QUICKSTART_BASE = ("https://storage.googleapis.com/pepper-deepvariant-public/"
                   "quickstart_data/")
QUICKSTART_FILES = [
    "HG002_ONT_2_GRCh38.chr20.quickstart.bam",
    "HG002_ONT_2_GRCh38.chr20.quickstart.bam.bai",
    "GRCh38_no_alt.chr20.fa",
    "GRCh38_no_alt.chr20.fa.fai",
    "HG002_GRCh38_1_22_v4.2.1_benchmark.quickstart.vcf.gz",
    "HG002_GRCh38_1_22_v4.2.1_benchmark_noinconsistent.quickstart.bed",
]
REGION = "chr20:1000000-1020000"


def _log(msg: str) -> None:
    sys.stderr.write("[acceptance] " + msg + "\n")
    sys.stderr.flush()


def ensure_data(data_dir: str, download: bool = False) -> Optional[Dict]:
    """Return paths dict when all quickstart files are present (optionally
    downloading them); None when unavailable (the caller skips)."""
    os.makedirs(data_dir, exist_ok=True)
    missing = [f for f in QUICKSTART_FILES
               if not os.path.isfile(os.path.join(data_dir, f))]
    if missing and download:
        import socket
        import urllib.request
        socket.setdefaulttimeout(30)   # fail fast on a blackholed network
        for f in missing[:]:
            url = QUICKSTART_BASE + f
            _log(f"downloading {url}")
            try:
                urllib.request.urlretrieve(url, os.path.join(data_dir, f))
                missing.remove(f)
            except Exception as exc:
                _log(f"download failed ({exc}); treating data as absent")
                break
    if missing:
        _log(f"missing quickstart files in {data_dir}: {missing}")
        return None
    d = {f: os.path.join(data_dir, f) for f in QUICKSTART_FILES}
    return dict(bam=d[QUICKSTART_FILES[0]], fasta=d[QUICKSTART_FILES[2]],
                truth_vcf=d[QUICKSTART_FILES[4]],
                truth_bed=d[QUICKSTART_FILES[5]])


def load_bed(path: str) -> List[Tuple[str, int, int]]:
    out = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                out.append((parts[0], int(parts[1]), int(parts[2])))
    return out


def _in_bed(bed, contig: str, pos: int) -> bool:
    return any(c == contig and s <= pos < e for c, s, e in bed)


def _alts_of(rec) -> List[Tuple[int, str, str]]:
    """Normalized (pos, ref, alt) triples for each called ALT allele
    (trailing shared suffix trimmed so padded multiallelics compare equal)."""
    out = []
    called = set(rec.genotype()) - {0, -1}
    for i, alt in enumerate(rec.alts, start=1):
        if called and i not in called:
            continue   # uncalled alt of a multiallelic record
        ref, a = rec.ref, alt
        while len(ref) > 1 and len(a) > 1 and ref[-1] == a[-1]:
            ref, a = ref[:-1], a[:-1]
        out.append((rec.pos, ref, a))
    return out


def evaluate(vcf_path: str, truth_vcf: str, truth_bed: Optional[str],
             region: str = REGION, pass_only: bool = True) -> Dict:
    """Allele-match SNP/INDEL precision/recall/F1 of `vcf_path` against
    `truth_vcf`, restricted to `region` (and the bed when given).
    Truth alleles match when some called record carries the same
    normalized (pos, ref, alt)."""
    from pepper_tpu_torch.io.vcf import read_vcf

    contig, span = region.split(":")
    lo, hi = (int(x) for x in span.split("-"))
    bed = load_bed(truth_bed) if truth_bed else None

    def in_scope(rec) -> bool:
        if rec.contig != contig or not (lo <= rec.pos + 1 <= hi):
            return False
        return bed is None or _in_bed(bed, rec.contig, rec.pos)

    def kind(ref: str, alt: str) -> str:
        return "SNP" if len(ref) == 1 and len(alt) == 1 else "INDEL"

    truth: Dict[str, set] = {"SNP": set(), "INDEL": set()}
    for rec in read_vcf(truth_vcf):
        if not in_scope(rec) or rec.genotype() == [0, 0]:
            continue
        for pos, ref, alt in _alts_of(rec):
            truth[kind(ref, alt)].add((pos, ref, alt))

    called: Dict[str, set] = {"SNP": set(), "INDEL": set()}
    for rec in read_vcf(vcf_path):
        if not in_scope(rec) or rec.genotype() == [0, 0]:
            continue
        if pass_only and rec.filters and "PASS" not in rec.filters:
            continue
        for pos, ref, alt in _alts_of(rec):
            called[kind(ref, alt)].add((pos, ref, alt))

    report = {}
    for t in ("SNP", "INDEL"):
        tp = len(truth[t] & called[t])
        fn = len(truth[t] - called[t])
        fp = len(called[t] - truth[t])
        recall = tp / max(1, tp + fn)
        precision = tp / max(1, tp + fp)
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        report[t] = dict(truth_total=len(truth[t]), tp=tp, fn=fn, fp=fp,
                         recall=round(recall, 6),
                         precision=round(precision, 6), f1=round(f1, 6))
    return report


def diff_records(ours: str, expected: str) -> Dict:
    """Record-level diff of two VCFs: identical / only-ours / only-expected
    counts keyed by (contig, pos, ref, alts, genotype)."""
    from pepper_tpu_torch.io.vcf import read_vcf

    def keyset(path):
        return {(r.contig, r.pos, r.ref, tuple(r.alts),
                 tuple(sorted(r.genotype()))) for r in read_vcf(path)}

    a, b = keyset(ours), keyset(expected)
    return dict(identical=len(a & b), only_ours=len(a - b),
                only_expected=len(b - a))


def run_acceptance(data_dir: str, model: Optional[str], out_dir: str,
                   threads: int = 2, expected: Optional[str] = None,
                   download: bool = False, device: str = "cuda") -> int:
    data = ensure_data(data_dir, download=download)
    if data is None:
        _log("SKIPPED: quickstart data not available (offline?). "
             "Place the files listed in QUICKSTART_FILES under "
             f"{data_dir} or rerun with --download.")
        return 0
    if not model or not os.path.isfile(model):
        _log(f"SKIPPED: model checkpoint not found ({model}). Provide a "
             "released PEPPER r0.8 .pkl (e.g. "
             "PEPPER_VARIANT_ONT_R9_GUPPY5_SUP.pkl from the r0.8 docker "
             "image's model directory) or a native .npz.")
        return 0

    if model.endswith(".pkl"):
        # import the reference torch checkpoint losslessly, cache as npz
        from pepper_tpu_torch.models.checkpoint import (
            load_torch_checkpoint, save_checkpoint)
        params, meta = load_torch_checkpoint(model)
        model_npz = os.path.join(out_dir, "imported_model.npz")
        os.makedirs(out_dir, exist_ok=True)
        save_checkpoint(model_npz, params, meta)
        _log(f"imported reference checkpoint {os.path.basename(model)}")
        model = model_npz

    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.pipelines.call_variant import call_variant
    from pepper_tpu_torch.presets import set_parameters

    config = set_parameters(PipelineConfig(
        bam=data["bam"], fasta=data["fasta"], output_dir=out_dir,
        sub_command="call_variant", ont_r9_guppy5_sup=True,
        threads=threads, region=REGION, model_path=model, device=device))
    _log(f"running call_variant on {REGION}")
    paths = call_variant(config)

    report = evaluate(paths["full"], data["truth_vcf"], data["truth_bed"])
    for t in ("SNP", "INDEL"):
        r = report[t]
        _log(f"{t}: truth={r['truth_total']} TP={r['tp']} FN={r['fn']} "
             f"FP={r['fp']} recall={r['recall']} precision={r['precision']} "
             f"F1={r['f1']}")
    d = None
    if expected and os.path.isfile(expected):
        d = diff_records(paths["full"], expected)
        _log(f"record diff vs expected: identical={d['identical']} "
             f"only_ours={d['only_ours']} only_expected={d['only_expected']}")
    ok = acceptance_verdict(report, d)
    if d is not None and (d["only_ours"] or d["only_expected"]):
        _log("record diff GATE FAILED: output differs from the "
             "reference-produced VCF")
    _log("ACCEPTANCE " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


def acceptance_verdict(report: Dict, diff: Optional[Dict] = None) -> bool:
    """Pass/fail decision. Standalone bar: PEPPER stage 1 is the candidate
    generator of the PMDV pipeline, so recall is what matters (candidates
    feed DeepVariant re-genotyping; docs/misc/pepper_methods.md "Step 1").
    With a reference-produced expected VCF the bar tightens to record
    EQUALITY — the reference's own quickstart bar is exact expected
    output (variant_calling_docker_quickstart.md:104-123)."""
    ok = (report["SNP"]["recall"] >= 0.9
          and report["INDEL"]["recall"] >= 0.5)
    if diff is not None and (diff["only_ours"] or diff["only_expected"]):
        ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pepper_tpu_acceptance_torch",
        description="Run the HG002 chr20 quickstart acceptance check.")
    ap.add_argument("--data_dir", required=True,
                    help="Directory holding (or receiving) quickstart files.")
    ap.add_argument("--model", default=None,
                    help="PEPPER r0.8 .pkl checkpoint or native .npz.")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "pepper_tpu_acceptance"))
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--expected", default=None,
                    help="Reference-produced VCF for record-level diff.")
    ap.add_argument("--download", action="store_true",
                    help="Try downloading missing quickstart files.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model forward (default cuda; "
                         "cpu runs it on the host).")
    args = ap.parse_args(argv)
    return run_acceptance(args.data_dir, args.model, args.out, args.threads,
                          args.expected, args.download, args.device)


if __name__ == "__main__":
    sys.exit(main())
