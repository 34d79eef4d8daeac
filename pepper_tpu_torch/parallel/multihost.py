"""Multi-host scale-out: region sharding across hosts + candidate merging.

The scaling model (SURVEY.md §2.6, §5.8): genomic regions are statically
striped across hosts (the reference's `i % workers` pattern —
pepper_variant/modules/python/ImageGenerationUI.py:326-339 — lifted to the
host level, the analog of the reference's only live distributed mode,
pepper/modules/python/models/train_distributed.py:253-286). Each host runs
the full image->inference->candidate pipeline on its shard with its own
BAM/FASTA handles (share-nothing); per-host candidate lists are then
gathered through the shared output directory and host 0 assembles the
single global VCF. Model params are replicated; on-device work is
batch-data-parallel over each host's devices (parallel/mesh.py), and the
trainers all-reduce their gradients over the process group.

A copy of pepper_tpu/parallel/multihost.py with its coordinator mode moved
from jax.distributed to torch.distributed. Two coordination modes:

* **torch.distributed** — pass a coordinator address (host:port) with the
  process count and this process's rank, or nothing under `torchrun`
  (its RANK / WORLD_SIZE / MASTER_ADDR environment); `host_count()` and
  `host_index()` then come from the process group. The backend is
  explicit: "nccl" for a process on a CUDA device, "gloo" on the CPU (gloo
  also carries CUDA tensors, so two ranks can share one card). A failed
  rendezvous raises.
* **filesystem** — pass `--num_hosts N --host_id I` (or set
  PEPPER_TPU_NUM_HOSTS / PEPPER_TPU_HOST_ID): hosts never rendezvous;
  work striping is static and the only sync point is the candidate gather
  before VCF assembly, done through atomically-renamed files in the shared
  output directory. This is the mode for plain multi-machine deployments
  (shared FS / object store) and for CI, where two local processes stand in
  for two hosts.
"""
import os
import pickle
import sys
import time
from datetime import datetime, timedelta
from typing import List, Optional, Sequence, Tuple

_num_hosts: Optional[int] = None
_host_id: Optional[int] = None
_initialized = False

# the environment `torchrun` gives every rank it starts
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def default_backend(device) -> str:
    """The collective backend for a process whose tensors live on
    `device`: "nccl" on a CUDA device, "gloo" on the CPU."""
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Establish this process's host identity; no-op for single-host runs.

    With a coordinator address (host:port), joins a torch.distributed
    process group of `num_processes` ranks as rank `process_id`; with no
    address, no host count and the `torchrun` environment present, joins
    the group that environment describes. A group needs its `backend`
    ("nccl" or "gloo", see `default_backend`): none is picked for the
    caller. Without either, a host count > 1 selects filesystem mode:
    identity is taken from the arguments (or the PEPPER_TPU_NUM_HOSTS /
    PEPPER_TPU_HOST_ID environment) and no network rendezvous happens."""
    global _num_hosts, _host_id, _initialized
    if _initialized:  # idempotent: CLI main and pipeline entry points both call
        return
    _initialized = True
    if num_processes is None:
        env = os.environ.get("PEPPER_TPU_NUM_HOSTS")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("PEPPER_TPU_HOST_ID")
        process_id = int(env) if env else None
    torchrun = (num_processes is None
                and all(k in os.environ for k in _TORCHRUN_ENV))
    if coordinator_address or torchrun:
        import torch.distributed as dist
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"a torch.distributed group needs its backend, "
                             f"'nccl' or 'gloo'; got {backend!r}")
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized; "
                               "multihost.initialize brings the group up "
                               "itself")
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address requires the process "
                                 "count and this process's rank")
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
                timeout=timedelta(seconds=timeout_s))
        else:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timedelta(seconds=timeout_s))
        _num_hosts, _host_id = None, None  # defer to the process group
        _log(f"MULTI-HOST: torch.distributed up ({backend}), host "
             f"{dist.get_rank()}/{dist.get_world_size()}")
        return
    if num_processes is not None and num_processes > 1:
        if process_id is None:
            raise ValueError("--num_hosts > 1 requires --host_id (or "
                             "PEPPER_TPU_HOST_ID)")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"host_id {process_id} out of range for "
                             f"{num_processes} hosts")
        _num_hosts, _host_id = num_processes, process_id
        _log(f"MULTI-HOST: filesystem mode, host {_host_id}/{_num_hosts}")


def initialize_from_config(config) -> None:
    """`initialize` from a PipelineConfig: nccl for a CUDA run, gloo for a
    CPU or dry run (the group only names the hosts there)."""
    device = "cpu" if getattr(config, "dry", False) else getattr(
        config, "device", "cpu")
    initialize(getattr(config, "coordinator_address", None),
               getattr(config, "num_hosts", None),
               getattr(config, "host_id", None),
               backend=default_backend(device))


def process_group():
    """The torch.distributed default group when one is up (the trainers'
    data-parallel group), else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def host_count() -> int:
    if _num_hosts is not None:
        return _num_hosts
    if process_group() is not None:
        import torch.distributed as dist
        return dist.get_world_size()
    env = os.environ.get("PEPPER_TPU_NUM_HOSTS")
    if env and int(env) > 1:
        raise RuntimeError("PEPPER_TPU_NUM_HOSTS is set but "
                           "multihost.initialize() was never called")
    return 1


def host_index() -> int:
    if _host_id is not None:
        return _host_id
    if process_group() is not None:
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def host_shard(items: Sequence) -> List:
    """Static striping of a work list over hosts (i % hosts == this host)."""
    n, i = host_count(), host_index()
    if n == 1:
        return list(items)
    return [item for k, item in enumerate(items) if k % n == i]


def shard_intervals_by_host(intervals: Sequence[Tuple[str, int, int]]
                            ) -> List[Tuple[str, int, int]]:
    return host_shard(intervals)


def host_tag() -> str:
    """Filename tag making per-host artifacts collision-free on shared FS."""
    return f"host_{host_index()}_" if host_count() > 1 else ""


def merge_candidate_dicts(dicts: Sequence[dict]) -> dict:
    """Merge per-host candidate dictionaries (keyed (contig, position))
    before VCF assembly. Host-side gather: candidate payloads are ragged
    Python records, so the merge is filesystem-level rather than a device
    all_gather (the device path carries only dense tensors)."""
    merged: dict = {}
    for d in dicts:
        for key, value in d.items():
            merged.setdefault(key, []).extend(value)
    return merged


# -------------------------------------------------- candidate-list gather
def _shard_path(output_dir: str, host: int) -> str:
    return os.path.join(output_dir, f".pepper_candidates_host_{host}.pkl")


def gather_candidate_lists(output_dir: str, margin_list: list, dv_list: list,
                           timeout: float = 3600.0, poll: float = 0.25
                           ) -> Optional[Tuple[list, list]]:
    """The pipeline's single multi-host sync point.

    Non-zero hosts persist their (margin, dv) candidate lists into the
    shared output directory (write-to-temp + atomic rename) and return
    None — their pipeline run is complete. Host 0 waits for every shard,
    merges, cleans up, and returns the global lists for VCF assembly.

    Determinism: each (prediction file, batch) is processed wholly by one
    host, so candidates sharing a (contig, position) key arrive in one
    shard in stable order; the global sort in aggregate_candidates then
    yields byte-identical VCFs regardless of host count."""
    n, i = host_count(), host_index()
    if n == 1:
        return margin_list, dv_list
    if i != 0:
        path = _shard_path(output_dir, i)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump((margin_list, dv_list), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        _log(f"HOST {i}: candidate shard shipped "
             f"({len(margin_list)} margin, {len(dv_list)} dv records)")
        return None
    merged_margin, merged_dv = list(margin_list), list(dv_list)
    deadline = time.time() + timeout
    t0 = time.time()
    for h in range(1, n):
        path = _shard_path(output_dir, h)
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(
                    f"host 0 timed out waiting for candidate shard of host "
                    f"{h} ({path}); a host failed or the shared filesystem "
                    f"is not shared")
            time.sleep(poll)
        with open(path, "rb") as fh:
            m, d = pickle.load(fh)
        merged_margin.extend(m)
        merged_dv.extend(d)
        os.remove(path)
        _log(f"HOST 0: merged candidate shard from host {h} "
             f"({len(m)} margin, {len(d)} dv records)")
    _log(f"HOST 0: GATHER WAIT {time.time() - t0:.3f}s")
    return merged_margin, merged_dv
