"""The comparisons that decide `correct`, and the parser of the program's
output they read.

Each number is a gap between what the timed path produced and the plain
reference; a cell's workload file holds each number's limit.
"""
import gzip
from typing import Dict

GT = {"0/0": 0, "0/1": 1, "1/1": 2}


def vcf_sites(path: str, sample) -> Dict[tuple, Dict[int, dict]]:
    """{interval: {pos (0-based): record}} of a VCF's records inside the
    given intervals' open ranges (start, end): an interval's end position
    is shared with the next interval, whose candidates the writer merges
    there."""
    by_contig: Dict[str, list] = {}
    for iv in sample:
        by_contig.setdefault(iv[0], []).append(iv)
    out = {iv: {} for iv in sample}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            pos = int(f[1]) - 1
            for iv in by_contig.get(f[0], ()):
                if iv[1] < pos < iv[2]:
                    fmt = dict(zip(f[8].split(":"), f[9].split(":")))
                    out[iv][pos] = {
                        "ref": f[3], "alts": f[4].split(","),
                        "gt": GT.get(fmt["GT"], -1),
                        "ap": [float(a) for a in fmt["AP"].split(",")],
                        "dp": int(fmt["DP"]),
                        "ad": [int(a) for a in fmt["AD"].split(",")],
                        "rep": int(fmt["REP"])}
    return out


def record_sites(called: Dict[tuple, Dict[int, dict]]):
    """The reference's (or a control's) sites in the parsed-VCF layout."""
    out = {}
    for iv, sites in called.items():
        out[iv] = {}
        for pos, site in sites.items():
            if not (iv[1] < pos < iv[2]) or not site["present"]:
                continue
            r = site["record"]
            out[iv][pos] = ({"ref": r["ref"], "alts": [r["alt"]],
                             "gt": r["gt"], "ap": [r["ap"]], "dp": r["dp"],
                             "ad": [r["ad"]], "rep": r["rep"]}
                            if r else {"multi": True})
    return out


def variant_gaps(got: Dict[tuple, Dict[int, dict]],
                 want: Dict[tuple, Dict[int, dict]]) -> Dict[str, float]:
    """The numbers compared for variant calling, of the sites `got` (parsed
    from the program's FULL VCF) against the reference's sites `want`, both
    inside each interval's open range (start, end):

    - site_gap: over positions present in one and not the other, how far
      the reference's probability would have had to move to flip its gate
      (1 where the reference has no candidate there);
    - ap_gap: over shared single-allele records, |AP - the reference's|;
    - gt_gap: over those, how far the reference's probability of the
      program's genotype lies below its best;
    - fields: shared single-allele records whose REF, ALT, DP, AD or REP
      differ (counts from the encoder: exact).
    """
    site_gap = ap_gap = gt_gap = 0.0
    fields = 0
    for iv, sites in want.items():
        # the open range that `vcf_sites` reads the program's records from
        sites = {p: s for p, s in sites.items() if iv[1] < p < iv[2]}
        have = got.get(iv, {})
        present = {p for p, s in sites.items() if s["present"]}
        for pos in present ^ set(have):
            if pos not in sites:
                site_gap = max(site_gap, 1.0)
                continue
            cands = sites[pos]["cands"]
            if pos in have:     # the reference kept it out
                gap = min(c["thr"] - c["nap"] for c in cands)
            else:               # the reference called it
                gap = max(c["nap"] - c["thr"] for c in cands if c["passed"])
            site_gap = max(site_gap, gap)
        for pos in present & set(have):
            rec, mine = sites[pos]["record"], have[pos]
            if rec is None or "multi" in mine or len(mine["alts"]) != 1:
                continue
            if (mine["ref"], mine["alts"][0], mine["dp"], mine["ad"][0],
                    mine["rep"]) != (rec["ref"], rec["alt"], rec["dp"],
                                     rec["ad"], rec["rep"]):
                fields += 1
                continue
            probs = sites[pos]["cands"][0]["probs"]
            ap_gap = max(ap_gap, abs(mine["ap"][0] - rec["ap"]))
            g = mine["gt"]
            gt_gap = max(gt_gap, 1.0 if g < 0 else
                         float(probs.max() - probs[g]))
    return {"site_gap": site_gap, "ap_gap": ap_gap, "gt_gap": gt_gap,
            "fields": float(fields)}

