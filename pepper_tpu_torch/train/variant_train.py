"""Variant-model training, on one device or data parallel (PyTorch).

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
device).

Data parallel: the JAX trainer runs its step over a mesh of every
process's devices and XLA inserts the gradient psum. Here each rank of a
torch.distributed group (parallel/multihost.py; `torchrun
--nproc_per_node N` starts one rank per card) feeds its contiguous block of
every global batch, and after the backward every gradient and the loss are
all-reduced with SUM (the loss is a sum over the global batch) in one flat
f32 buffer, before the optimizer adds the weight decay; every rank gets the
same bytes, so the replicas stay bit-identical. Dropout masks are drawn for
the global batch, each rank keeping its rows, so N ranks train as one
process would. The eval splits over the ranks and sums the confusion
matrices; only rank 0 writes checkpoints, stats and logs.
"""
import os
import sys
import time
from datetime import datetime
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pepper_tpu_torch.models.checkpoint import (load_checkpoint,
                                                load_opt_state,
                                                save_checkpoint)
from pepper_tpu_torch.models.variant_model import (init_variant_params,
                                                   variant_forward)
from pepper_tpu_torch.options import ImageOptions
from pepper_tpu_torch.parallel import multihost
from pepper_tpu_torch.parallel.mesh import rank_block, rank_card
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


def train_device(device, group) -> torch.device:
    """The device a trainer runs on. Under a process group, "cuda" means
    the rank's own card (`mesh.rank_card`). Without one the trainer uses
    one card, and says so where it sees several: data-parallel training
    runs one rank per card."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if group is not None:
        dev = rank_card(group)
        torch.cuda.set_device(dev)
    elif count > 1:
        _log(f"TRAINING ON ONE OF {count} CARDS: data-parallel training "
             f"runs one rank per card (torchrun --nproc_per_node {count})")
    return dev


def check_group(group) -> None:
    """A trainer runs in one process or in a torch.distributed group:
    filesystem-mode hosts (--num_hosts) never exchange gradients."""
    if group is None and multihost.host_count() > 1:
        raise ValueError("data-parallel training needs a torch.distributed "
                         "group (torchrun, or a coordinator address); "
                         "filesystem-mode hosts cannot sync gradients")


def is_rank0(group) -> bool:
    if group is None:
        return True
    import torch.distributed as dist
    return dist.get_rank(group) == 0


def flat_step(params: Dict, loss: torch.Tensor) -> torch.Tensor:
    """Every gradient of `params` and the loss in one flat f32 buffer, in
    sorted_leaves order with the loss last: what a data-parallel step
    reduces."""
    return torch.cat([p.grad.reshape(-1) for _, p in sorted_leaves(params)]
                     + [loss.detach().float().reshape(1)])


def set_flat_grads(params: Dict, flat: torch.Tensor) -> None:
    """Copy a reduced `flat_step` buffer back into the gradients."""
    offset = 0
    for _, p in sorted_leaves(params):
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()


def reduce_flat(flat: torch.Tensor, group) -> None:
    """Sum a `flat_step` buffer over the ranks of `group` in place, by one
    all_reduce: one collective on one buffer gives every rank the same
    bytes. The trainers' default `allreduce`."""
    import torch.distributed as dist
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)


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


def make_train_step(params, optimizer, group=None,
                    allreduce: Callable = reduce_flat):
    """step(images int8 [B,T,F], labels [B], dropout_gen=None) -> the summed
    loss of the global batch as a 0-d tensor, after one update of the
    parameters in place. On a CUDA device each block is staged in pinned
    memory, copied asynchronously and cast to f32 on the card.

    params, optimizer: one parameter tree and its optimizer, or lists of
    them, in-process replicas (a mesh in one process, as the JAX step over
    one process's devices); then dropout_gen is a list with one generator
    per replica, on its device and seeded alike. group: a torch.distributed
    group, each rank of which feeds its block of the global batch
    (`rank_block`). The block splits again over the replicas; each replica
    differentiates its rows, their `flat_step` buffers are summed in order
    and `allreduce(flat, group)` sums that over the ranks (the loss is a
    sum over the global batch), and every replica takes the result as its
    gradients before its optimizer adds the weight decay. With one replica
    and no group the step is the plain one-device step."""
    replicas = params if isinstance(params, list) else [params]
    optimizers = optimizer if isinstance(optimizer, list) else [optimizer]
    devices = [next(p for _, p in sorted_leaves(r)).device for r in replicas]
    reduced = group is not None or len(replicas) > 1

    def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return host
        return host.pin_memory().to(device, non_blocking=True)

    def step(images: np.ndarray, labels: np.ndarray,
             dropout_gen=None) -> torch.Tensor:
        gens = dropout_gen if isinstance(dropout_gen, list) \
            else [dropout_gen] * len(replicas)
        n = len(images)
        lo, hi = rank_block(n, group, exact=True)
        if (hi - lo) % len(replicas):
            raise ValueError(f"a block of {hi - lo} rows does not split "
                             f"over {len(replicas)} replicas")
        rows = (hi - lo) // len(replicas)
        total = None
        for r, (tree, opt, dev) in enumerate(zip(replicas, optimizers,
                                                devices)):
            first = lo + r * rows
            x = upload(images[first:first + rows], dev).float()
            y = upload(np.asarray(labels[first:first + rows])
                       .astype(np.int64), dev)
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_sum(variant_forward(
                tree, x, train_mode=True, dropout_gen=gens[r],
                dropout_block=(first, n)), y)
            loss.backward()
            if reduced:
                flat = flat_step(tree, loss).to(devices[0])
                total = flat if total is None else total + flat
        if reduced:
            if group is not None:
                allreduce(total, group)
            for tree, dev in zip(replicas, devices):
                set_flat_grads(tree, total.to(dev))
            loss = total[-1]
        for opt in optimizers:
            opt.step()
        return loss.detach()

    return step


def sum_over_ranks(cm: np.ndarray, device, group) -> np.ndarray:
    """A confusion matrix summed over the ranks of `group` (as is without
    one)."""
    if group is None:
        return cm
    import torch.distributed as dist
    total = torch.from_numpy(cm).to(device)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.cpu().numpy()


def confusion_and_accuracy(params: Dict, images: np.ndarray,
                           labels: np.ndarray, batch_size: int = 512,
                           group=None) -> Tuple[np.ndarray, float]:
    """torchnet ConfusionMeter parity (test.py:35-108): 3x3 matrix,
    accuracy = 100 * trace / sum. Runs the inference forward on the
    parameters' device; under a group each rank evaluates its block of
    the images and the matrices are summed."""
    n_cls = ImageOptions.TOTAL_TYPE_LABELS
    device = next(p for _, p in sorted_leaves(params)).device
    cm = np.zeros((n_cls, n_cls), dtype=np.int64)
    first, end = rank_block(len(images), group)
    with torch.inference_mode():
        for lo in range(first, end, batch_size):
            hi = min(lo + batch_size, end)
            x = torch.from_numpy(np.ascontiguousarray(
                images[lo:hi])).to(device).float()
            pred = variant_forward(params, x).argmax(-1).cpu().numpy()
            np.add.at(cm, (np.asarray(labels[lo:hi]), pred), 1)
    cm = sum_over_ranks(cm, device, group)
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
    as in the JAX package). Returns the best model's path.

    In a torch.distributed group (`multihost.process_group()`) every rank
    runs this loop over the same loader and seed: the loader's batches are
    the global batches, each rank steps on its block of them and on its
    card ("cuda" is the rank's own), and only rank 0 writes."""
    group = multihost.process_group()
    check_group(group)
    device = train_device(device, group)
    rank0 = is_rank0(group)
    log = _log if rank0 else (lambda msg: None)
    if not loader.n_examples:
        raise ValueError("training requires labeled images (make_train_images)")
    batch_size = loader.batch_size
    rank_block(batch_size, group, exact=True)   # the batch splits evenly
    if rank0:
        os.makedirs(model_dir, exist_ok=True)
    log(f"TRAIN EXAMPLES: {loader.n_examples}  TEST: "
        f"{0 if test_data is None else len(test_data['images'])}"
        + ("" if loader.eager_arrays() is not None else
           f"  (streaming shuffle buffer: {loader.buffer_examples} examples)")
        + f"  DEVICE: {device}"
        + ("" if group is None else
           f"  RANKS: {multihost.host_count()} (batch {batch_size} global)"))

    start_epoch = 0
    if retrain_model_path:
        params = trainable(_load_model_params(retrain_model_path), device)
        if retrain_model_path.endswith(".npz"):
            _, prev_meta = load_checkpoint(retrain_model_path)
            start_epoch = int(prev_meta.get("epochs", 0))
        log(f"RETRAIN MODEL LOADED: {retrain_model_path}")
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
            log("OPTIMIZER STATE RESTORED")
    set_learning_rate(optimizer, lr)
    step_fn = make_train_step(params, optimizer, group)
    scheduler = ReduceLROnPlateau(lr, patience=2, min_lr=0.75 * lr)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    # run-stamped stats artifacts (reference train_distributed.py:49-51)
    stats_dir = os.path.join(model_dir,
                             "stats_" + time.strftime("%m%d%Y_%H%M%S"))
    if rank0:
        os.makedirs(stats_dir, exist_ok=True)
    cm_path = os.path.join(stats_dir, "confusion_matrix.txt")

    def stats_file(name):
        return open(os.path.join(stats_dir, name) if rank0 else os.devnull,
                    "w")

    rng = np.random.RandomState(seed)
    step_no = 0
    best_accuracy = -1.0
    best_path = os.path.join(model_dir, "PEPPER_VARIANT_BEST.npz")
    n_steps_per_epoch = max(1, loader.n_examples // batch_size)
    total_steps = epoch_limit * min(step_size, n_steps_per_epoch)
    epoch = start_epoch
    t0 = time.time()
    with stats_file("train_loss.csv") as train_csv, \
            stats_file("test_loss.csv") as test_csv:
        while step_no < total_steps:
            for bx, by in loader.epoch_batches(rng):
                loss = float(step_fn(bx, by, dropout_gen))
                step_no += 1
                train_csv.write(f"{epoch},{step_no},{loss}\n")
                if (step_no % step_size == 0 or step_no >= total_steps) \
                        and test_data is not None:
                    cm, accuracy = confusion_and_accuracy(
                        params, test_data["images"],
                        test_data["type_label"].astype(np.int64),
                        group=group)
                    new_lr = scheduler.step(accuracy)
                    set_learning_rate(optimizer, new_lr)
                    log(f"STEP {step_no} LOSS {loss:.3f} "
                        f"ACCURACY {accuracy:.3f} LR {new_lr:.2e}")
                    test_csv.write(f"{epoch},{step_no},{loss},{accuracy}\n")
                    paths = [os.path.join(
                        model_dir, f"PEPPER_VARIANT_STEP_{step_no}.npz")]
                    if accuracy > best_accuracy:
                        best_accuracy = accuracy
                        paths.append(best_path)
                    if rank0:
                        with open(cm_path, "w") as fh:  # latest eval's matrix
                            fh.write(f"step {step_no} accuracy "
                                     f"{accuracy:.4f}\n")
                            fh.write(np.array2string(cm) + "\n")
                        meta = {"epochs": epoch, "step": step_no,
                                "accuracy": accuracy}
                        opt_state = optimizer_leaves(optimizer, params,
                                                     opt_steps + step_no)
                        for path in paths:
                            save_checkpoint(path, params, meta,
                                            opt_state=opt_state)
                if step_no >= total_steps:
                    break
            epoch += 1
    log(f"TRAINING COMPLETE [{time.time() - t0:.1f}s] "
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
    "cuda" (raises when there is no CUDA device) or "cpu". Data parallel
    in a torch.distributed group (see `train_loop`)."""
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
