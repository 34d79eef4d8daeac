"""Variant-model training on one device (PyTorch).

Parity source: pepper_variant/modules/python/models/train_distributed.py
(Adam lr=1e-4 + L2 weight decay 1e-6, CrossEntropyLoss(reduction='sum') on
the 3-class type head, ReduceLROnPlateau('max', patience=2,
min_lr=0.75*lr), step-based eval + checkpoint cycle, confusion-matrix eval)
and pepper_tpu/train/variant_train.py, whose stats files, checkpoint names,
step/epoch accounting and retrain/resume behaviour this keeps.

One step: the int8 batch goes up from pinned memory and is cast on the
device, the forward runs `variant_forward(train_mode=True)` in f32 (the
biLSTM layers through kernels K3/K4 on a CUDA device), the loss is the
summed cross entropy, and torch.optim.Adam(weight_decay=) adds the L2 term
to the gradient before the moment update, as the JAX package's optimizer
chain does. The eval runs the inference forward (kernel K1 on a CUDA
device). A device mesh, batch sharding and data-parallel replicas have no
counterpart here yet.
"""
import os
import sys
import time
from datetime import datetime
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pepper_tpu_torch.models.checkpoint import (load_checkpoint,
                                                load_opt_state,
                                                save_checkpoint)
from pepper_tpu_torch.models.variant_model import (init_variant_params,
                                                   variant_forward)
from pepper_tpu_torch.options import ImageOptions
from pepper_tpu_torch.runtime.inference import (_load_model_params,
                                                load_all_summaries)
from pepper_tpu_torch.runtime.streaming import resolve_device
from pepper_tpu_torch.train.dataloader import ShuffleBufferLoader


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def cross_entropy_sum(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(weight=[1,1,1], reduction='sum') parity."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).sum()


def sorted_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in sorted-key order, depth first: the order in
    which the JAX package flattens a parameter tree."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from sorted_leaves(tree[key], path)
        else:
            yield path, tree[key]


def trainable(params: Dict, device) -> Dict:
    """A copy of the parameter tree (numpy arrays or tensors) as f32 leaf
    tensors on `device` that require gradients; the optimizer updates them
    in place, so they never share memory with the tree they came from."""
    return {k: trainable(v, device) if isinstance(v, dict)
            else torch.tensor(np.asarray(
                v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                np.float32)).to(device).requires_grad_()
            for k, v in params.items()}


def make_optimizer(params: Dict, lr: float = 1e-4,
                   weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): L2 added to the gradient BEFORE
    the Adam moment update; b1 0.9, b2 0.999, eps 1e-8 outside the root.
    The parameters are registered in sorted-key order."""
    return torch.optim.Adam([p for _, p in sorted_leaves(params)], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def optimizer_leaves(optimizer: torch.optim.Adam, params: Dict,
                     steps_taken: int) -> List[np.ndarray]:
    """The optimizer state as the ordered leaves the JAX package saves:
    step count, learning rate, Adam count, then the first and the second
    moments, each in sorted-key order of the parameter tree."""
    leaves = [p for _, p in sorted_leaves(params)]
    count = np.asarray(steps_taken, np.int32)
    lr = np.asarray(optimizer.param_groups[0]["lr"], np.float32)

    def moments(key):
        return [optimizer.state[p][key].detach().cpu().numpy()
                if p in optimizer.state
                else np.zeros(tuple(p.shape), np.float32) for p in leaves]

    return [count, lr, count] + moments("exp_avg") + moments("exp_avg_sq")


def restore_optimizer(optimizer: torch.optim.Adam, params: Dict,
                      saved: List[np.ndarray]) -> int:
    """Load `optimizer_leaves`-ordered state (of either package) into the
    optimizer. Returns the number of steps the state had taken."""
    leaves = [p for _, p in sorted_leaves(params)]
    if len(saved) != 3 + 2 * len(leaves):
        raise ValueError(
            f"optimizer state mismatch: checkpoint has {len(saved)} leaves, "
            f"optimizer expects {3 + 2 * len(leaves)} (different optimizer?)")
    steps_taken = int(saved[2])
    mu, nu = saved[3:3 + len(leaves)], saved[3 + len(leaves):]
    for p, m, v in zip(leaves, mu, nu):
        def moment(a):
            return torch.as_tensor(np.asarray(a, np.float32).reshape(
                tuple(p.shape))).to(p.device)
        optimizer.state[p] = {
            "step": torch.tensor(float(steps_taken), dtype=torch.float32),
            "exp_avg": moment(m), "exp_avg_sq": moment(v)}
    set_learning_rate(optimizer, float(saved[1]))
    return steps_taken


def make_train_step(params: Dict, optimizer: torch.optim.Optimizer):
    """step(images int8 [B,T,F], labels [B], dropout_gen=None) -> the summed
    loss as a 0-d tensor on the parameters' device, after one update of
    `params` in place. On a CUDA device the batch is staged in pinned
    memory, copied asynchronously and cast to f32 on the card."""
    device = next(p for _, p in sorted_leaves(params)).device

    def upload(array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return host
        return host.pin_memory().to(device, non_blocking=True)

    def step(images: np.ndarray, labels: np.ndarray,
             dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = upload(images).float()
        y = upload(np.asarray(labels).astype(np.int64))
        optimizer.zero_grad(set_to_none=True)
        loss = cross_entropy_sum(
            variant_forward(params, x, train_mode=True,
                            dropout_gen=dropout_gen), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def confusion_and_accuracy(params: Dict, images: np.ndarray,
                           labels: np.ndarray, batch_size: int = 512
                           ) -> Tuple[np.ndarray, float]:
    """torchnet ConfusionMeter parity (test.py:35-108): 3x3 matrix,
    accuracy = 100 * trace / sum. Runs the inference forward on the
    parameters' device."""
    n_cls = ImageOptions.TOTAL_TYPE_LABELS
    device = next(p for _, p in sorted_leaves(params)).device
    cm = np.zeros((n_cls, n_cls), dtype=np.int64)
    with torch.inference_mode():
        for lo in range(0, len(images), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images[lo:lo + batch_size])).to(device).float()
            pred = variant_forward(params, x).argmax(-1).cpu().numpy()
            np.add.at(cm, (np.asarray(labels[lo:lo + batch_size]), pred), 1)
    total = cm.sum()
    accuracy = 100.0 * np.trace(cm) / max(1, total)
    return cm, float(accuracy)


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau('max', patience=2, factor=0.1, min_lr) parity."""

    def __init__(self, lr: float, patience: int = 2, factor: float = 0.1,
                 min_lr: float = 0.0):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = -float("inf")
        self.bad_steps = 0

    def step(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.bad_steps = 0
        else:
            self.bad_steps += 1
            if self.bad_steps > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_steps = 0
        return self.lr


def train_loop(loader: ShuffleBufferLoader, test_data: Optional[Dict],
               model_dir: str, epoch_limit: int = 10, step_size: int = 100,
               lr: float = 1e-4, weight_decay: float = 1e-6,
               retrain_model_path: Optional[str] = None, seed: int = 0,
               device="cuda") -> str:
    """The training loop over a loader object (`ShuffleBufferLoader`, from
    an image directory or `from_arrays`). test_data: a dict with "images"
    and "type_label", or None for no eval (then no checkpoint is written,
    as in the JAX package). Returns the best model's path."""
    device = resolve_device(device)
    if not loader.n_examples:
        raise ValueError("training requires labeled images (make_train_images)")
    os.makedirs(model_dir, exist_ok=True)
    batch_size = loader.batch_size
    _log(f"TRAIN EXAMPLES: {loader.n_examples}  TEST: "
         f"{0 if test_data is None else len(test_data['images'])}"
         + ("" if loader.eager_arrays() is not None else
            f"  (streaming shuffle buffer: {loader.buffer_examples} examples)")
         + f"  DEVICE: {device}")

    start_epoch = 0
    if retrain_model_path:
        params = trainable(_load_model_params(retrain_model_path), device)
        if retrain_model_path.endswith(".npz"):
            _, prev_meta = load_checkpoint(retrain_model_path)
            start_epoch = int(prev_meta.get("epochs", 0))
        _log(f"RETRAIN MODEL LOADED: {retrain_model_path}")
    else:
        # window/feature geometry inferred from the data, so HP images
        # ([B,21,48]) and base images ([B,33,26]) both train unchanged
        window, features = loader.example_shape
        params = trainable(init_variant_params(
            torch.Generator().manual_seed(seed), image_features=features,
            window=window), device)

    optimizer = make_optimizer(params, lr, weight_decay)
    opt_steps = 0
    if retrain_model_path and retrain_model_path.endswith(".npz"):
        # resume Adam moments + step count (reference restores
        # 'model_optimizer', ModelHander.py:17-59)
        saved = load_opt_state(retrain_model_path)
        if saved is not None:
            opt_steps = restore_optimizer(optimizer, params, saved)
            _log("OPTIMIZER STATE RESTORED")
    set_learning_rate(optimizer, lr)
    step_fn = make_train_step(params, optimizer)
    scheduler = ReduceLROnPlateau(lr, patience=2, min_lr=0.75 * lr)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    # run-stamped stats artifacts (reference train_distributed.py:49-51)
    stats_dir = os.path.join(model_dir,
                             "stats_" + time.strftime("%m%d%Y_%H%M%S"))
    os.makedirs(stats_dir, exist_ok=True)
    cm_path = os.path.join(stats_dir, "confusion_matrix.txt")

    rng = np.random.RandomState(seed)
    step_no = 0
    best_accuracy = -1.0
    best_path = os.path.join(model_dir, "PEPPER_VARIANT_BEST.npz")
    n_steps_per_epoch = max(1, loader.n_examples // batch_size)
    total_steps = epoch_limit * min(step_size, n_steps_per_epoch)
    epoch = start_epoch
    t0 = time.time()
    with open(os.path.join(stats_dir, "train_loss.csv"), "w") as train_csv, \
            open(os.path.join(stats_dir, "test_loss.csv"), "w") as test_csv:
        while step_no < total_steps:
            for bx, by in loader.epoch_batches(rng):
                loss = float(step_fn(bx, by, dropout_gen))
                step_no += 1
                train_csv.write(f"{epoch},{step_no},{loss}\n")
                if (step_no % step_size == 0 or step_no >= total_steps) \
                        and test_data is not None:
                    cm, accuracy = confusion_and_accuracy(
                        params, test_data["images"],
                        test_data["type_label"].astype(np.int64))
                    new_lr = scheduler.step(accuracy)
                    set_learning_rate(optimizer, new_lr)
                    _log(f"STEP {step_no} LOSS {loss:.3f} "
                         f"ACCURACY {accuracy:.3f} LR {new_lr:.2e}")
                    test_csv.write(f"{epoch},{step_no},{loss},{accuracy}\n")
                    with open(cm_path, "w") as fh:  # latest eval's matrix
                        fh.write(f"step {step_no} accuracy {accuracy:.4f}\n")
                        fh.write(np.array2string(cm) + "\n")
                    meta = {"epochs": epoch, "step": step_no,
                            "accuracy": accuracy}
                    opt_state = optimizer_leaves(optimizer, params,
                                                 opt_steps + step_no)
                    paths = [os.path.join(
                        model_dir, f"PEPPER_VARIANT_STEP_{step_no}.npz")]
                    if accuracy > best_accuracy:
                        best_accuracy = accuracy
                        paths.append(best_path)
                    for path in paths:
                        save_checkpoint(path, params, meta,
                                        opt_state=opt_state)
                if step_no >= total_steps:
                    break
            epoch += 1
    _log(f"TRAINING COMPLETE [{time.time() - t0:.1f}s] "
         f"BEST ACCURACY: {best_accuracy:.3f} STATS: {stats_dir}")
    return best_path


def train(train_image_dir: str, test_image_dir: str, model_dir: str,
          batch_size: int = 64, epoch_limit: int = 10, step_size: int = 100,
          lr: float = 1e-4, weight_decay: float = 1e-6,
          retrain_model_path: Optional[str] = None, seed: int = 0,
          device="cuda", buffer_bytes: int = 512 << 20) -> str:
    """Train loop (train_distributed.py:47-243). Returns best model path.

    Training data streams through a bounded shuffle buffer (train/
    dataloader.py): RSS stays within ~buffer_bytes however large the image
    set is; datasets that fit the buffer take the eager path. `device` is
    "cuda" (raises when there is no CUDA device) or "cpu"."""
    resolve_device(device)   # before any image is read
    loader = ShuffleBufferLoader(train_image_dir, batch_size,
                                 buffer_bytes=buffer_bytes, train_mode=True)
    test_data = load_all_summaries(test_image_dir, train_mode=True)
    if test_data is not None and "type_label" not in test_data:
        test_data = None
    return train_loop(loader, test_data, model_dir, epoch_limit=epoch_limit,
                      step_size=step_size, lr=lr, weight_decay=weight_decay,
                      retrain_model_path=retrain_model_path, seed=seed,
                      device=device)
