"""Device meshes and batch sharding (PyTorch).

Counterpart of pepper_tpu/parallel/mesh.py. The parallelism model
(SURVEY.md §2.6): genomic regions are the outer, embarrassingly-parallel
axis handled host-side; on-device work is batch data parallelism over a
1-axis mesh. Model params are replicated; batches are split on axis 0.

A mesh is an ordered list of `torch.device`. An entry is one replica: its
own copy of the parameters and, on a card, its own CUDA stream. A device
may be listed more than once: two entries on one card are two replicas
there, each on its own stream (a one-card machine runs a 2-entry mesh that
way), and a mesh of CPU entries runs the same sharded code on the CPU.

Training is one rank per card instead: each rank of a torch.distributed
group (parallel/multihost.py) takes its contiguous block of every global
batch (`rank_block`, `shard_batch_from_local`) and the trainers all-reduce
the gradients (train/variant_train.py).
"""
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Mesh = List[torch.device]


def _entry(device) -> torch.device:
    from pepper_tpu_torch.runtime.streaming import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of `devices` (names or torch.device, repeats allowed), or
    of every visible CUDA device, the counterpart of `jax.devices()`.
    A CUDA entry with no CUDA device raises; entries are all CUDA or all
    CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh(): no CUDA device is available "
                               "(pass the devices, e.g. ['cpu'] * 4, for a "
                               "mesh of CPU entries)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = [_entry(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"a mesh is all CUDA or all CPU, got {mesh}")
    return mesh


def rank_card(group) -> torch.device:
    """The card of this rank of `group`: LOCAL_RANK as torchrun sets it,
    else the rank modulo the card count."""
    import torch.distributed as dist
    return torch.device("cuda", int(os.environ.get(
        "LOCAL_RANK", dist.get_rank(group) % torch.cuda.device_count())))


def mesh_for(device) -> Mesh:
    """The runners' mesh for a `device` argument: "cuda" means every
    visible card (in a torch.distributed group, one process per card: the
    rank's own card), "cuda:N" that card, "cpu" the CPU, and a list of
    devices that mesh."""
    if isinstance(device, (list, tuple)):
        return data_mesh(device)
    from pepper_tpu_torch.parallel import multihost
    from pepper_tpu_torch.runtime.streaming import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        group = multihost.process_group()
        return data_mesh() if group is None else [rank_card(group)]
    return [dev]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch) -> list:
    """Split axis 0 of every array in `batch` (a tensor, a numpy array, or
    a dict/list/tuple of them) into len(mesh) equal contiguous blocks, in
    mesh order: one tree per entry, each block on its entry's device."""
    n = len(mesh)

    def block(x, r):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over a mesh of {n}")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b].to(mesh[r])

    return [_tree_map(lambda x: block(x, r), batch) for r in range(n)]


def replicate(mesh: Mesh, tree) -> list:
    """One copy of `tree` (tensors or numpy arrays) per mesh entry, on its
    device; two entries on one device get two copies."""
    return [_tree_map(lambda x: torch.tensor(x).to(dev)
                      if isinstance(x, np.ndarray)
                      else x.to(dev, copy=True), tree) for dev in mesh]


def rank_block(n: int, group=None, exact: bool = False) -> Tuple[int, int]:
    """Rows [lo, hi) of an n-row global batch that this rank of `group`
    feeds (contiguous blocks in rank order; (0, n) without a group).
    exact: the batch must split evenly (a train step's global batch)."""
    if group is None:
        return 0, n
    import torch.distributed as dist
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if exact and n % world:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{world} ranks")
    return rank * n // world, (rank + 1) * n // world


def shard_batch_from_local(mesh: Mesh, batch, group=None) -> list:
    """Multi-process batch feeding: this rank's rows of the global `batch`
    (`rank_block`), split over the rank's own mesh (one card per rank: one
    entry). Every rank holds the global batch on the host (the same loader
    with the same seed) and keeps its block, the DistributedSampler analog
    of JAX's process-local feeding. Without a group this is shard_batch."""
    def rows(x):
        lo, hi = rank_block(len(x), group)
        return x[lo:hi]
    return shard_batch(mesh, _tree_map(rows, batch))


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def replica_streams(mesh: Mesh) -> List[Optional[torch.cuda.Stream]]:
    """One CUDA stream per CUDA entry (None for a CPU entry), ordered after
    the work already queued on its device's current stream (the parameter
    uploads)."""
    streams = []
    for dev in mesh:
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
        streams.append(stream)
    return streams


def run_replicas(mesh: Mesh, streams, fn: Callable,
                 batch: torch.Tensor) -> list:
    """[fn(r, block) for each mesh entry r], each call made on entry r's
    device and stream, where block is the r-th of len(mesh) equal row
    blocks of `batch` (on any device, or pinned on the host), copied to
    that device after the work queued for it on its own device's current
    stream."""
    n = len(mesh)
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not split "
                         f"over a mesh of {n}")
    b = batch.shape[0] // n
    outs = []
    for r, (dev, stream) in enumerate(zip(mesh, streams)):
        block = batch[r * b:(r + 1) * b]
        if stream is None:
            outs.append(fn(r, block.to(dev)))
            continue
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if block.is_cuda:
                stream.wait_stream(torch.cuda.current_stream(batch.device))
                block.record_stream(stream)
            outs.append(fn(r, block.to(dev, non_blocking=True)))
    return outs


def map_replicas(mesh: Mesh, streams, fn: Callable, batch: torch.Tensor):
    """run_replicas, with the outputs (a tensor or a tuple of tensors per
    entry) concatenated on batch's device, ordered after every replica's
    work on the caller's current stream."""
    outs = run_replicas(mesh, streams, fn, batch)
    for dev, stream, out in zip(mesh, streams, outs):
        if stream is not None:
            # later reads of `out` run on the device's current stream
            current = torch.cuda.current_stream(dev)
            current.wait_stream(stream)
            for t in (out if isinstance(out, tuple) else (out,)):
                t.record_stream(current)
    src = batch.device
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i].to(src) for o in outs])
                     for i in range(len(outs[0])))
    return torch.cat([o.to(src) for o in outs])
