"""Hyperband HPO over learning rate / weight decay for the polish model.

Parity: pepper/modules/python/models/hyperband.py:54-139 +
run_hyperband.py:25-40 — successive-halving brackets over configurations
sampled log-uniformly (lr in [1e-5, 1e-2], weight decay in [1e-7, 1e-4]),
budget measured in training epochs; best config by eval accuracy.

Copy of pepper_tpu/train/hyperband.py with the imports rewritten; the
default `train_fn` trains with the port's train_polish on `device`.
"""
import math
import os
import sys
from datetime import datetime
from typing import Dict, List

import numpy as np


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def sample_config(rng: np.random.RandomState) -> Dict[str, float]:
    return {
        "lr": float(10 ** rng.uniform(-5, -2)),
        "weight_decay": float(10 ** rng.uniform(-7, -4)),
    }


def run_hyperband(train_image_dir: str, test_image_dir: str, output_dir: str,
                  max_epochs: int = 9, eta: int = 3, seed: int = 0,
                  train_fn=None, device="cuda") -> Dict:
    """Returns the best {lr, weight_decay, accuracy, model_path}."""
    if train_fn is None:
        from pepper_tpu_torch.models.checkpoint import load_checkpoint
        from pepper_tpu_torch.train.polish_train import train_polish

        def train_fn(config, epochs, run_dir):
            path = train_polish(train_image_dir, test_image_dir, run_dir,
                                epoch_limit=epochs, lr=config["lr"],
                                weight_decay=config["weight_decay"],
                                device=device)
            _, meta = load_checkpoint(path)
            return float(meta.get("accuracy", 0.0)), path

    rng = np.random.RandomState(seed)
    s_max = int(math.log(max_epochs) / math.log(eta))
    B = (s_max + 1) * max_epochs
    best = {"accuracy": -1.0}
    all_results: List[Dict] = []
    run_no = 0
    for s in range(s_max, -1, -1):
        n = int(math.ceil(B / max_epochs / (s + 1) * eta ** s))
        r = max_epochs * eta ** (-s)
        configs = [sample_config(rng) for _ in range(n)]
        _log(f"BRACKET s={s}: {n} configs, starting budget {r:.1f} epochs")
        for i in range(s + 1):
            n_i = int(n * eta ** (-i))
            r_i = int(round(r * eta ** i))
            results = []
            for config in configs:
                run_dir = os.path.join(output_dir, f"hb_run_{run_no}")
                run_no += 1
                accuracy, path = train_fn(config, max(1, r_i), run_dir)
                results.append((accuracy, config, path))
                all_results.append({"accuracy": accuracy,
                                    "iterations": max(1, r_i),
                                    "params": config, "model_path": path})
                if accuracy > best["accuracy"]:
                    best = {"accuracy": accuracy, "model_path": path,
                            **config}
            results.sort(key=lambda t: -t[0])
            keep = max(1, int(n_i / eta))
            configs = [config for _, config, _ in results[:keep]]
            _log(f"  rung {i}: budget {r_i} epochs, "
                 f"best accuracy {results[0][0]:.3f}, keeping {keep}")
    # persist every run for the hyperband_result inspection helper (the
    # reference pickles its result list; we write JSON)
    import json
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "hyperband_results.json"), "w") as fh:
        json.dump(all_results, fh, indent=1)
    _log(f"HYPERBAND COMPLETE: best accuracy {best['accuracy']:.3f} "
         f"lr {best.get('lr'):.2e} wd {best.get('weight_decay'):.2e}")
    return best
