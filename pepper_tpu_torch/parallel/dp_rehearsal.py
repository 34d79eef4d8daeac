"""One rank of a data-parallel training rehearsal: N ranks against 1.

Takes `--steps` train steps of the variant classifier or the polish model
over a fixed global batch and writes the parameters, the losses and the
step timings to an .npz. With `--world 1` the one process runs the global
batch with no process group; with `--blocks K` it runs K in-process
replicas that take the blocks K ranks would and sum their gradients in
order (`variant_train.make_train_step` over a list of replicas), as the
JAX package's one-process run uses a mesh of the same size. With `--world N` each of N
processes joins a torch.distributed group at `--coordinator`
(parallel/multihost.py), feeds its contiguous block of each global batch,
and the trainers all-reduce the gradients. Equal parameters from both, and
bit-identical ones across the ranks, show that N ranks train as one
process does.

variant: `data/images.npy` int8 [N,T,F] and `data/labels.npy` [N]; step s
takes the global batch in the order `RandomState(100 + s).permutation(N)`
(the JAX package's multi-host training test uses the same). polish:
`data/images.npy` [N,1000,10] and `data/labels.npy` [N,1000]; step s is the
s-th 100-wide window (jump 50) of all N rows, the hidden carried.

    python -m pepper_tpu_torch.parallel.dp_rehearsal variant --rank 0 \\
        --world 2 --coordinator 127.0.0.1:29500 --data DIR --steps 4 \\
        --out rank0.npz --device cpu --dropout

`--device` is "cuda" (the rank's own card; raises with no card) unless
the caller asks for the CPU.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

LR, WEIGHT_DECAY = 1e-3, 1e-6


def _timed(fn, device, times):
    """fn, with the wall ms of each call (the device synchronized around
    it) appended to `times`."""
    def wrapper(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    return wrapper


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.parallel import multihost
    from pepper_tpu_torch.runtime.inference import _load_model_params
    from pepper_tpu_torch.train import polish_train as pt
    from pepper_tpu_torch.train import variant_train as vt

    if args.world > 1:
        multihost.initialize(args.coordinator, args.world, args.rank,
                             backend=args.backend)
    group = multihost.process_group()
    device = vt.train_device(args.device, group)
    images = np.load(os.path.join(args.data, "images.npy"))
    labels = np.load(os.path.join(args.data, "labels.npy"))
    n = len(images)
    gen = torch.Generator().manual_seed(0)
    if args.init:
        tree = _load_model_params(args.init)
    elif args.model == "variant":
        from pepper_tpu_torch.models.variant_model import init_variant_params
        tree = init_variant_params(gen, image_features=images.shape[2],
                                   window=images.shape[1],
                                   hidden=args.hidden)
    else:
        from pepper_tpu_torch.models.polish_model import init_polish_params
        tree = init_polish_params(gen, hidden=args.hidden)
    replicas = [vt.trainable(tree, device) for _ in range(args.blocks)]
    optimizers = [vt.make_optimizer(p, LR, WEIGHT_DECAY) for p in replicas]
    params, optimizer = replicas[0], optimizers[0]
    allreduce_ms, step_ms, losses = [], [], []
    allreduce = _timed(vt.reduce_flat, device, allreduce_ms)
    fl.train_fwd_launches = fl.train_bwd_launches = 0
    if args.model == "variant":
        gens = [torch.Generator(device=device).manual_seed(200)
                for _ in replicas] if args.dropout else None
        step = _timed(vt.make_train_step(replicas, optimizers, group,
                                         allreduce), device, step_ms)
        for s in range(args.steps):
            order = np.random.RandomState(100 + s).permutation(n)
            losses.append(float(step(images[order], labels[order], gens)))
    else:
        if args.blocks > 1:
            raise ValueError("--blocks is a variant option")
        from pepper_tpu_torch.models.polish_model import (hidden_size,
                                                          init_hidden)
        from pepper_tpu_torch.parallel.mesh import rank_block
        lo, hi = rank_block(n, group, exact=True)
        step = _timed(pt.make_polish_train_step(params, optimizer, group,
                                                allreduce), device, step_ms)
        x = torch.from_numpy(images[lo:hi].astype(np.float32)).to(device)
        y = torch.from_numpy(labels[lo:hi].astype(np.int64)).to(device)
        hidden = init_hidden(hi - lo, hidden_size(params), device=device)
        starts = list(pt._windows())
        for s in range(args.steps):
            i = starts[s % len(starts)]
            hidden, loss = step(x[:, i:i + 100], y[:, i:i + 100], hidden)
            losses.append(float(loss))
    out = {path: p.detach().cpu().numpy()
           for path, p in vt.sorted_leaves(params)}
    out.update(__losses__=np.asarray(losses),
               __step_ms__=np.asarray(step_ms),
               __allreduce_ms__=np.asarray(allreduce_ms),
               __launches__=np.asarray([fl.train_fwd_launches,
                                        fl.train_bwd_launches]))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="One rank of a data-parallel training rehearsal.")
    parser.add_argument("model", choices=("variant", "polish"))
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (world > 1)")
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--data", required=True)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the rank's own card), cuda:N or cpu")
    parser.add_argument("--dropout", action="store_true",
                        help="variant: dropout on, one generator seed for "
                             "every rank")
    parser.add_argument("--blocks", type=int, default=1,
                        help="variant, --world 1: in-process replicas")
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--init", default=None,
                        help="start from this checkpoint (.npz)")
    args = parser.parse_args(argv)
    result = run(args)
    from pepper_tpu_torch.parallel import multihost
    if multihost.process_group() is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    np.savez(args.out, **result)
    print("OK", args.rank, args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
