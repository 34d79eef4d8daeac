"""The control of `correct`: the reference put in the program's place at the
next lower precision, read by the same comparison as a run, at the cell's
own size, and held to the cell's limits.

    python3 benchmark/reference/control.py --workload <cell> --seeds 1,2,3
        [--device cuda]

The configuration serves the classifier in bfloat16; the control computes
its products in fp8 (e4m3, one scale per tensor, float32 sums) on the
seed's sample of intervals, against the float32 reference.

Prints one JSON line per seed with the control's numbers, each beside its
limit, and exits non-zero unless the control fails at least one of the
cell's limits on every seed. Not part of a run.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402
from benchmark.reference import compare, models, variant_calls  # noqa: E402
from benchmark.traffic import datasets  # noqa: E402


def variant_control(work, conf, seed, device, overrides=None):
    """{"fp8": the control's numbers, "records": the reference's records}
    on the seed's dataset and sample of intervals."""
    p = {**work["traffic_params"], **(overrides or {})}
    seeds = harness.sub_seeds(seed, 4)
    data = datasets.variant_dataset(p, seeds)
    sample = variant_calls.sample_intervals(
        data["fasta"], p["region_size"], p["check_intervals"], seeds[3])
    tree = {layer: {n: torch.from_numpy(a).to(device) for n, a in v.items()}
            for layer, v in harness.tree(harness.load_weights(conf)).items()}
    cands = variant_calls.candidates(data["bam"], data["fasta"], sample,
                                     conf["preset"]["image"])
    cand = conf["preset"]["candidate"]
    want = variant_calls.call_sites(cands, tree, cand, device)
    low = variant_calls.call_sites(cands, tree, cand, device,
                                   models.Precision(torch.float8_e4m3fn))
    records = sum(len(compare.record_sites(want)[iv]) for iv in sample)
    return {"fp8": compare.variant_gaps(compare.record_sites(low), want),
            "records": records}


def fails(reading: dict, limits: dict) -> list:
    """The numbers of `reading` over their limits."""
    return [k for k in limits if reading[k] > limits[k]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    work = harness.cell(args.workload)
    conf = harness.config(work["config"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        got = variant_control(work, conf, seed, args.device)
        over = fails(got["fp8"], work["limits"])
        if not over:
            passed.append(seed)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "records": got["records"], "fails": over,
            "fp8": {k: {"value": got["fp8"][k], "limit": work["limits"][k]}
                    for k in work["limits"]}}), flush=True)
    if passed:
        harness.log(f"the control passes every limit on seeds {passed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
