"""Train the classifier once with the plain reference and store it as the
benchmark's fixed weights.

    python3 benchmark/weights/make_weights.py [--out DIR]

The recipe: a 1 Mbp genome from the benchmark's generator
(`traffic/datasets.py`) with the cell's reads (35x, 10 kb, 8% error) and
800/100/100 planted SNPs, insertions and deletions (seeds 41/42/43); every
candidate of it encoded in train mode by the plain region encoder
(`reference/variant_calls.py::encode_interval`, 100 kb intervals over 8
processes) and labeled by the planted truth; a tenth held out. The plain
classifier (`reference/models.py`) starts from seed 0 and is trained by
its Adam (lr 3e-4, weight decay 1e-6) on the summed cross-entropy at batch
64, with dropout, in 100-step rounds, until the held-out accuracy has not
risen for 2 rounds (at least 300 steps, at most 10 rounds); the best
round is kept. Nothing of the program is used.

The model is written as `pepper_variant_r941.npz`: the values rounded to
bfloat16 and stored as their uint16 bit patterns under 'layer/name' keys
(numpy has no bfloat16); its sha256 is printed for the configuration file.
Run on the card; it takes a few minutes.
"""
import argparse
import hashlib
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.reference import models, variant_calls  # noqa: E402
from benchmark.traffic import datasets  # noqa: E402

CONFIG = "pepper_variant_r941"
CELL = "call_variant.r941.35x"
MBP = 1
PLANTED = (800, 100, 100)
SEEDS = (41, 42, 43)
BATCH = 64
LR = 3e-4
WEIGHT_DECAY = 1e-6
ROUND = 100
MIN_STEPS = 300
MAX_ROUNDS = 10
PATIENCE = 2
WORKERS = 8


def _encode(job):
    bam, fasta, iv, image, truth = job
    cands = variant_calls.encode_interval(bam, fasta, *iv, image, truth)
    if not cands:
        return np.zeros((0, 33, 26), np.int8), np.zeros(0, np.int64)
    return (np.stack([np.asarray(c.image) for c in cands]).astype(np.int8),
            np.array([c.type_label for c in cands], np.int64))


def labeled_images(conf: dict, region_size: int):
    params = {**harness.cell(CELL)["traffic_params"], "mbp": MBP,
              "contigs": 1, "snps": PLANTED[0], "insertions": PLANTED[1],
              "deletions": PLANTED[2]}
    data = datasets.variant_dataset(params, SEEDS)
    truth = variant_calls.truth_records(data["truth"])
    jobs = [(data["bam"], data["fasta"], iv, conf["preset"]["image"],
             truth.get(iv[0], ([], [])))
            for iv in variant_calls.intervals(data["fasta"], region_size)]
    with ProcessPoolExecutor(WORKERS) as pool:
        parts = list(pool.map(_encode, jobs))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def accuracy(tree, x, y, device) -> float:
    probs = variant_calls.probabilities(tree, x, device)
    return float(100.0 * np.mean(probs.argmax(1) == y))


def train(conf: dict, x, y, device: str):
    held = np.random.default_rng(SEEDS[0]).random(len(x)) < 0.1
    tx, ty, x, y = x[held], y[held], x[~held], y[~held]
    c = conf
    tree = models.requires_grad({
        layer: {n: t.to(device) for n, t in v.items()}
        for layer, v in models.init_classifier(
            0, c["image_features"], c["image_window"], c["hidden_size"],
            c["linear_width"], c["linear_layers"],
            c["num_classes"]).items()})
    opt = models.Adam(tree, LR, WEIGHT_DECAY)
    gen = torch.Generator(device=device).manual_seed(0)
    order = np.random.RandomState(0)
    perm, at = order.permutation(len(x)), 0
    accuracies, best = [], None
    for r in range(MAX_ROUNDS):
        for _ in range(ROUND):
            if at + BATCH > len(perm):
                perm, at = order.permutation(len(x)), 0
            rows = perm[at:at + BATCH]
            at += BATCH
            xb = torch.from_numpy(x[rows]).to(device).float()
            yb = torch.from_numpy(y[rows]).to(device)
            loss = models.cross_entropy_sum(models.classifier_forward(
                tree, xb, train=True, dropout_gen=gen), yb)
            opt.step(models.grads_of(tree, loss))
        accuracies.append(accuracy(tree, tx, ty, device))
        if accuracies[-1] >= max(accuracies):
            best = {layer: {n: t.detach().cpu().numpy().copy()
                            for n, t in v.items()}
                    for layer, v in tree.items()}
        top = int(np.argmax(accuracies))
        if ((r + 1) * ROUND >= MIN_STEPS
                and len(accuracies) - 1 - top >= PATIENCE):
            break
    return best, accuracies, {"train": int(len(x)), "held_out": int(len(tx)),
                              "labels": np.bincount(y, minlength=3).tolist()}


def bf16_bits(tree: dict) -> dict:
    flat = {}
    for layer, names in tree.items():
        for name, value in names.items():
            t = torch.from_numpy(np.asarray(value, np.float32))
            flat[f"{layer}/{name}"] = (t.to(torch.bfloat16).view(torch.int16)
                                       .numpy().view(np.uint16))
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=HERE)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = harness.config(CONFIG)
    x, y = labeled_images(conf,
                          harness.cell(CELL)["traffic_params"]["region_size"])
    tree, accuracies, sizes = train(conf, x, y, "cuda")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, CONFIG + ".npz")
    np.savez(path, **bf16_bits(tree))
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    print(json.dumps({"file": path, "sha256": digest, **sizes,
                      "held_out_accuracy_by_round": accuracies}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
