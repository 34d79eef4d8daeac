"""Polish-model training, on one device or data parallel (PyTorch).

Parity: pepper/modules/python/models/train_distributed.py and
pepper_tpu/train/polish_train.py — per 100-wide window (jump 50) of each
1000-long image: the forward with the hidden carried from the previous
window, the mean cross entropy over the window's positions (CLASS_WEIGHTS
all 1.0), one optimizer step per window, the hidden detached between
windows. Inside one window the encoder's final hidden seeds the decoder
with its gradient, as in the reference.

The step differentiates `polish_forward(..., fused_rnn=False)`, the plain
biGRU step loop (models/rnn.py::gru), as the JAX trainer differentiates
its `lax.scan`; the eval (`polish_accuracy`) runs under inference_mode
with `fused_rnn=True`, which on a CUDA device launches kernel K2 twice a
window. The optimizer is variant training's Adam (L2 weight decay added to
the gradient). The checkpoints (`PEPPER_POLISH_EPOCH_<n>.npz`,
`PEPPER_POLISH_BEST.npz`, with the optimizer state as `__opt__/` leaves)
are the JAX package's format, so a run resumes from either package's file.

Data parallel, as variant training (train/variant_train.py): the JAX
package's mesh becomes one rank per card of a torch.distributed group.
Each rank takes its contiguous block of every global batch and carries the
hidden state of its own rows from window to window; the loss is a mean, so
each window's gradients and loss are averaged over the ranks (equal
blocks) in one flat buffer. The eval splits over the ranks and sums the
confusion matrices; only rank 0 writes.
"""
import os
import sys
import time
from datetime import datetime
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pepper_tpu_torch.models.checkpoint import (load_opt_state,
                                                save_checkpoint)
from pepper_tpu_torch.models.polish_model import (hidden_size,
                                                  init_hidden,
                                                  init_polish_params,
                                                  polish_forward)
from pepper_tpu_torch.options import PolishImageOptions, PolishTrainOptions
from pepper_tpu_torch.runtime.inference import _load_model_params
from pepper_tpu_torch.runtime.streaming import resolve_device
from pepper_tpu_torch.parallel import multihost
from pepper_tpu_torch.parallel.mesh import rank_block
from pepper_tpu_torch.train.variant_train import (check_group, flat_step,
                                                  is_rank0, make_optimizer,
                                                  optimizer_leaves,
                                                  reduce_flat,
                                                  restore_optimizer,
                                                  set_flat_grads,
                                                  set_learning_rate,
                                                  sorted_leaves,
                                                  sum_over_ranks,
                                                  train_device, trainable)

Arrays = Tuple[np.ndarray, np.ndarray]


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def polish_training_arrays(images, labels) -> Arrays:
    """Labeled polish images held in memory (images [N,1000,10], labels
    [N,1000], e.g. from polish/make_images.py::create_polish_summary in
    train mode) as `load_polish_training_data` returns them: (f32 images,
    int32 labels), or (None, None) when there are none."""
    if len(images) != len(labels):
        raise ValueError(f"{len(images)} images but {len(labels)} labels")
    if not len(images):
        return None, None
    return (np.stack(images).astype(np.float32),
            np.stack(labels).astype(np.int32))


def load_polish_training_data(image_dir: str) -> Arrays:
    """Every summary of the polish image stores in `image_dir` (h5py)."""
    from pepper_tpu_torch.polish.datastore import (PolishImageStore,
                                                   polish_image_files)
    images, labels = [], []
    for path in polish_image_files(image_dir):
        with PolishImageStore(path, "r") as store:
            for name in store.summary_names():
                s = store.read_summary(name)
                images.append(s["image"])
                labels.append(s["label"])
    return polish_training_arrays(images, labels)


def cross_entropy_mean(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss(weight=ones) == the plain mean cross entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def make_polish_train_step(params: Dict, optimizer: torch.optim.Optimizer,
                           group=None, allreduce: Callable = reduce_flat):
    """step(chunk f32 [B,T,F], label_chunk [B,T], hidden [B,2,H]) ->
    (the decoder's final hidden, detached; the loss as a 0-d tensor), after
    one update of `params` in place.

    group: a torch.distributed group. Then the inputs are this rank's rows
    (its block of the global batch, its own hidden), the gradients and the
    loss, in one `flat_step` buffer, are summed over the ranks by
    `allreduce(flat, group)` and divided by the world size (the loss is a
    mean over equal blocks; gloo has no AVG), and the returned loss is the
    global batch's mean."""
    def step(chunk: torch.Tensor, label_chunk: torch.Tensor,
             hidden: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        logits, hidden_out = polish_forward(params, chunk, hidden,
                                            fused_rnn=False)
        loss = cross_entropy_mean(logits, label_chunk)
        loss.backward()
        if group is not None:
            import torch.distributed as dist
            flat = flat_step(params, loss)
            allreduce(flat, group)
            flat /= dist.get_world_size(group)
            set_flat_grads(params, flat)
            loss = flat[-1]
        optimizer.step()
        return hidden_out.detach(), loss.detach()

    return step


def _windows():
    """Start of each 100-wide window (jump 50) that fits a sequence."""
    window = PolishTrainOptions.TRAIN_WINDOW
    seq_len = PolishImageOptions.SEQ_LENGTH
    return range(0, seq_len - window + 1, PolishTrainOptions.WINDOW_JUMP)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def polish_accuracy(params: Dict, images: np.ndarray, labels: np.ndarray,
                    batch_size: int = 64, group=None
                    ) -> Tuple[np.ndarray, float]:
    """Windowed eval (reference test.py semantics) on the parameters'
    device: (confusion matrix int64 [5,5] true x predicted, accuracy %).
    Runs `polish_forward(fused_rnn=True)` under inference_mode; under a
    group each rank evaluates its block of the images and the matrices
    are summed."""
    window = PolishTrainOptions.TRAIN_WINDOW
    n_cls = PolishImageOptions.TOTAL_LABELS
    device = next(p for _, p in sorted_leaves(params)).device
    width = hidden_size(params)
    cm = np.zeros((n_cls, n_cls), np.int64)
    first, end = rank_block(len(images), group)
    with torch.inference_mode():
        for lo in range(first, end, batch_size):
            hi = min(lo + batch_size, end)
            x = _upload(images[lo:hi], device).float()
            y = np.asarray(labels[lo:hi]).astype(np.int64)
            hidden = init_hidden(x.shape[0], width, device=device)
            for i in _windows():
                logits, hidden = polish_forward(
                    params, x[:, i:i + window], hidden, fused_rnn=True)
                pred = logits.argmax(-1).cpu().numpy()
                np.add.at(cm, (y[:, i:i + window], pred), 1)
    cm = sum_over_ranks(cm, device, group)
    return cm, 100.0 * np.trace(cm) / max(1, cm.sum())


def train_polish_loop(train: Arrays, test: Optional[Arrays], model_dir: str,
                      batch_size: int = 64, epoch_limit: int = 10,
                      lr: float = 1e-4, weight_decay: float = 1e-6,
                      retrain_model_path: Optional[str] = None,
                      seed: int = 0, device="cuda") -> str:
    """The training loop over labeled images in memory: `train` and `test`
    are (images [N,1000,10], labels [N,1000]) pairs (`test` may be None:
    then no eval runs and only the best checkpoint is written, each
    epoch). Returns the best model's path.

    In a torch.distributed group (`multihost.process_group()`) every rank
    runs this loop over the same arrays and seed: batch_size is the global
    batch, each rank steps on its block of it and on its card, and only
    rank 0 writes."""
    group = multihost.process_group()
    check_group(group)
    device = train_device(device, group)
    rank0 = is_rank0(group)
    log = _log if rank0 else (lambda msg: None)
    images, labels = train
    if images is None or not len(images):
        raise ValueError("no labeled polish images found")
    first, end = rank_block(batch_size, group, exact=True)
    test_images, test_labels = test if test is not None else (None, None)
    if rank0:
        os.makedirs(model_dir, exist_ok=True)
    log(f"TRAIN SEQUENCES: {len(images)}  DEVICE: {device}"
        + ("" if group is None else
           f"  RANKS: {multihost.host_count()} (batch {batch_size} global)"))

    if retrain_model_path:
        params = trainable(_load_model_params(retrain_model_path), device)
    else:
        params = trainable(init_polish_params(
            torch.Generator().manual_seed(seed)), device)
    optimizer = make_optimizer(params, lr, weight_decay)
    opt_steps = 0
    if retrain_model_path and retrain_model_path.endswith(".npz"):
        saved = load_opt_state(retrain_model_path)
        if saved is not None:
            opt_steps = restore_optimizer(optimizer, params, saved)
            log("OPTIMIZER STATE RESTORED")
    set_learning_rate(optimizer, lr)
    step_fn = make_polish_train_step(params, optimizer, group)
    width = hidden_size(params)

    # run-stamped stats artifacts (reference train_distributed.py)
    stats_dir = os.path.join(model_dir,
                             "stats_" + time.strftime("%m%d%Y_%H%M%S"))
    if rank0:
        os.makedirs(stats_dir, exist_ok=True)
    cm_path = os.path.join(stats_dir, "confusion_matrix.txt")

    def stats_file(name):
        return open(os.path.join(stats_dir, name) if rank0 else os.devnull,
                    "w")

    window = PolishTrainOptions.TRAIN_WINDOW
    rng = np.random.RandomState(seed)
    steps = 0
    best_accuracy = -1.0
    best_path = os.path.join(model_dir, "PEPPER_POLISH_BEST.npz")
    t0 = time.time()
    with stats_file("train_loss.csv") as train_csv, \
            stats_file("test_loss.csv") as test_csv:
        for epoch in range(epoch_limit):
            order = rng.permutation(len(images))
            total_loss, total_windows = 0.0, 0
            for lo in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[lo:lo + batch_size][first:end]   # this rank's
                x = _upload(images[idx], device).float()
                y = _upload(np.asarray(labels[idx]).astype(np.int64), device)
                hidden = init_hidden(len(idx), width, device=device)
                for i in _windows():
                    hidden, loss = step_fn(x[:, i:i + window],
                                           y[:, i:i + window], hidden)
                    total_loss += float(loss)
                    total_windows += 1
                    steps += 1
            epoch_loss = total_loss / max(1, total_windows)
            train_csv.write(f"{epoch + 1},{epoch_loss}\n")
            if test_images is None:
                if rank0:
                    save_checkpoint(best_path, params, {"epochs": epoch + 1},
                                    opt_state=optimizer_leaves(
                                        optimizer, params, opt_steps + steps))
                continue
            cm, accuracy = polish_accuracy(params, test_images, test_labels,
                                           group=group)
            log(f"EPOCH {epoch + 1} LOSS {epoch_loss:.4f} "
                f"ACCURACY {accuracy:.3f}")
            test_csv.write(f"{epoch + 1},{epoch_loss},{accuracy}\n")
            paths = [os.path.join(model_dir,
                                  f"PEPPER_POLISH_EPOCH_{epoch + 1}.npz")]
            if accuracy > best_accuracy:
                best_accuracy = accuracy
                paths.append(best_path)
            if rank0:
                with open(cm_path, "w") as fh:
                    fh.write(f"epoch {epoch + 1} accuracy {accuracy:.4f}\n")
                    fh.write(np.array2string(cm) + "\n")
                meta = {"epochs": epoch + 1, "accuracy": accuracy}
                opt_state = optimizer_leaves(optimizer, params,
                                             opt_steps + steps)
                for path in paths:
                    save_checkpoint(path, params, meta, opt_state=opt_state)
    log(f"POLISH TRAINING COMPLETE [{time.time() - t0:.1f}s] "
        f"BEST ACCURACY: {best_accuracy:.3f} STATS: {stats_dir}")
    return best_path


def train_polish(train_image_dir: str, test_image_dir: str, model_dir: str,
                 batch_size: int = 64, epoch_limit: int = 10,
                 lr: float = 1e-4, weight_decay: float = 1e-6,
                 retrain_model_path: Optional[str] = None, seed: int = 0,
                 device="cuda") -> str:
    """`train_polish_loop` on the polish image stores of two directories
    (h5py). `device` is "cuda" (raises when there is no CUDA device) or
    "cpu". Data parallel in a torch.distributed group (see
    `train_polish_loop`). Returns the best model's path."""
    resolve_device(device)   # before any image is read
    train = load_polish_training_data(train_image_dir)
    test = load_polish_training_data(test_image_dir)
    return train_polish_loop(
        train, None if test[0] is None else test, model_dir,
        batch_size=batch_size, epoch_limit=epoch_limit, lr=lr,
        weight_decay=weight_decay, retrain_model_path=retrain_model_path,
        seed=seed, device=device)
