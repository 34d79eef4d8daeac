"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell's workload file names its entry
(`entries/<entry>.py`), which sets up the program (`pepper_tpu_torch`)
from the seed, measures it for `--seconds` seconds of whole jobs or steps,
and hands back what the check of `correct` needs. With `--trace 0` the
metrics are the cell's end-to-end metrics; with `--trace 1` the per-layer
metrics, read by `metrics/<metric>.py` from the program's spans and
counters and a torch.profiler trace of a steady part of the window.

Exits non-zero, printing no result, without enough CUDA devices, or when
the JAX stack or the JAX package was loaded.
"""
import argparse
import gc
import os
import sys

T_START = __import__("time").perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict = None) -> dict:
    """Run one cell once; returns the result object and the checks
    (name -> (value, limit)). `device` other than "cuda" and `overrides`
    (traffic parameters) serve the benchmark's own tests on the CPU."""
    harness.set_cache_env()
    work = harness.cell(workload)
    if overrides:
        work["traffic_params"] = {**work["traffic_params"], **overrides}
    conf = harness.config(work["config"])
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < work["chips"]:
            raise SystemExit(
                f"{workload} needs {work['chips']} CUDA device(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}")
    harness.log(f"cell loaded at {harness.now() - T_START:.2f}s")
    driver = harness.entry(work["entry"])
    ctx = harness.Context(work, conf, seed, seconds, trace, device, T_START)
    out = driver.run(ctx)

    loaded = harness.forbidden_loaded()
    if loaded:
        raise SystemExit(f"the run loaded {loaded}: nothing it runs may "
                         f"import the JAX stack or the JAX package")
    dev = harness.device_info(device, work["chips"])
    out.free()
    gc.collect()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()
    checks = out.check()
    correct = all(value <= limit for value, limit in checks.values()) \
        and out.failed == 0

    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "device": dev}
    units = {m["name"]: m["unit"] for m in harness.spec()["end_to_end"]}
    if not trace:
        metrics = {work["metric"]: out.rate, "setup_s": out.setup_s}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in metrics.items()}
    else:
        result["metrics"] = {}
        for m in harness.per_layer(workload):
            value = harness.metric_reader(m["name"]).read(out.obs)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        summary = out.obs.get("trace")
        if summary:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = summary["breakdown"]
    if harness.forbidden_loaded():
        raise SystemExit(f"the run loaded {harness.forbidden_loaded()}")
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, checks = run(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
