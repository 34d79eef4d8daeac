"""Read and pretty-print hyperband HPO results — manual QA tool.

Role parity: reference helper/hyperband_result.py (both packages) — loads
the persisted result list, sorts by loss/accuracy, prints each surviving
run's loss, iterations (epoch budget), accuracy, params, and model path.
Our trainer persists JSON (hyperband_results.json) instead of a pickle.
"""
import argparse
import json
from typing import Dict, List


def load_results(path: str) -> List[Dict]:
    with open(path) as fh:
        return json.load(fh)


def print_results(results: List[Dict], min_iterations: int = 0) -> None:
    results = sorted(results, key=lambda r: -r.get("accuracy", 0.0))
    shown = 0
    for result in results:
        if result.get("iterations", 0) < min_iterations:
            continue
        shown += 1
        print(shown)
        print("Accuracy:\t", result.get("accuracy"))
        print("iterations:\t", result.get("iterations"))
        print("Params:\t\t", result.get("params"))
        print("Model path:\t", result.get("model_path"))
    if not shown:
        print("(no results above the iteration threshold)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pepper_hyperband_result",
        description="Inspect hyperband HPO results.")
    parser.add_argument("--results_file", type=str, required=True,
                        help="hyperband_results.json written by run_hyperband.")
    parser.add_argument("--min_iterations", type=int, default=0,
                        help="Only show runs trained at least this many epochs.")
    args = parser.parse_args(argv)
    print_results(load_results(args.results_file), args.min_iterations)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
