"""The benchmark's shared machinery: the files it is driven by, seeds,
caches, the device's description, the profiler's reduction and the result
line.

Everything that belongs to one configuration, one cell or one per-layer
metric lives in a file of its own and is found by its name:
`configs/<config>.json`, `workloads/<cell>.json` (its entry, traffic
parameters and limits), `entries/<entry>.py` (the driver of one entry
point of the program) and `metrics/<metric>.py` (one reader each).
"""
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")

# top-level module names that must never be loaded by a run: the JAX stack
# and the JAX package the port was made from (compared whole, so the
# port's own `pepper_tpu_torch` is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "pepper_tpu")


class Context:
    """What an entry is given: the cell's workload file (`work`), its
    configuration (`conf`), the run's seed, window length, trace flag,
    device, and the clock reading at the process's start."""

    def __init__(self, work, conf, seed, seconds, trace, device, t_start):
        self.work, self.conf = work, conf
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.params = work["traffic_params"]
        self.limits = work["limits"]


class Outcome:
    """What an entry hands back: the end-to-end rate of the window, the
    set-up seconds, jobs or steps attempted and failed, the observations
    the per-layer readers take (`obs`, with the trace's summary under
    "trace"), `free()` to drop the program's state, and `check()`, which
    runs the reference and returns {number: (value, limit)}."""

    def __init__(self, rate, setup_s, attempted, failed, obs, check, free):
        self.rate, self.setup_s = rate, setup_s
        self.attempted, self.failed = attempted, failed
        self.obs, self.check, self.free = obs, check, free


def log(msg: str) -> None:
    sys.stderr.write(f"[benchmark] {msg}\n")
    sys.stderr.flush()


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """A module from a file path (metric files carry dots in their names)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def cell(name: str) -> dict:
    """The cell's workload file, checked against its BENCHMARK.json entry."""
    entries = {w["name"]: w for w in spec()["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(entries)}")
    work = load_json(os.path.join(BENCH, "workloads", name + ".json"))
    for key in ("config", "traffic", "chips"):
        if work[key] != entries[name][key]:
            raise SystemExit(f"workloads/{name}.json's {key} "
                             f"{work[key]!r} differs from BENCHMARK.json's "
                             f"{entries[name][key]!r}")
    work["name"] = name
    return work


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH, "configs", name + ".json"))


def entry(name: str):
    return load_module(os.path.join(BENCH, "entries", name + ".py"),
                       f"benchmark_entry_{name}")


def reports(cell_name: str) -> List[str]:
    """The end-to-end metrics the cell reports (setup_s and those that name
    it, or that name no cells)."""
    out = []
    for m in spec()["end_to_end"]:
        if "workloads" not in m or cell_name in m["workloads"]:
            out.append(m["name"])
    return out


def per_layer(cell_name: str) -> List[dict]:
    """The per-layer metrics read in this cell's traced run."""
    mine = set(reports(cell_name))
    return [m for m in spec()["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def metric_reader(name: str):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_"))


def load_weights(conf: dict) -> Dict[str, np.ndarray]:
    """{'layer/name': float32 array} of the configuration's committed
    weights: bfloat16 values stored as their uint16 bit patterns, widened.
    Refuses a file whose sha256 is not the configuration's."""
    import hashlib
    w = conf["weights"]
    path = os.path.join(ROOT, w["file"])
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    if digest != w["sha256"]:
        raise SystemExit(f"{w['file']} has sha256 {digest}, the "
                         f"configuration {conf['name']} states {w['sha256']}")
    with np.load(path) as z:
        return {k: (z[k].astype(np.uint32) << 16).view(np.float32)
                for k in z.files}


def tree(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        layer, name = key.split("/")
        out.setdefault(layer, {})[name] = v
    return out


def program_checkpoint(conf: dict) -> str:
    """The committed weights as a checkpoint in the program's format (a
    flat .npz keyed 'layer/name', float32), cached by the file's sha256."""
    path = os.path.join(CACHE, "weights",
                        conf["weights"]["sha256"][:16] + ".npz")
    if not os.path.isfile(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        side = path + ".partial.npz"
        np.savez(side, **load_weights(conf))
        os.replace(side, path)
    return path


def sub_seeds(seed: int, n: int) -> List[int]:
    """n seeds below 2**31 drawn from the run's seed (any whole number):
    the program's own seeds (numpy's RandomState takes 32 bits) and the
    generator's."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(n)
    return [int(w) % (2 ** 31) for w in words]


def set_cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc and g++ builds already go to its `build/`)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def scratch_dir(cell_name: str) -> str:
    """Where a run writes its outputs: under TMPDIR, one directory per cell
    (emptied by the run that uses it)."""
    base = os.environ.get("TMPDIR") or os.path.join(CACHE, "tmp")
    return os.path.join(base, "pepper_benchmark", cell_name)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: str, chips: int) -> dict:
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


class DeviceTrace:
    """torch.profiler over one steady part of the window. `summary()`
    reduces it to the device's busy seconds (the union of kernel, copy and
    set intervals), the traced window's length, device time and launches
    by kernel name, and the longest idle gaps named by the host operation
    that covered them."""

    MARK = "benchmark_traced_window"

    def __init__(self, device: str):
        self.device = device
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._mark = record_function(self.MARK)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return False

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        mark = [e for e in events if e.name == self.MARK]
        lo = min(e.time_range.start for e in mark)
        hi = max(e.time_range.end for e in mark)
        dev, host = [], []
        kernels: Dict[str, list] = {}
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    continue   # an annotation's device span covers kernels
                s, t = e.time_range.start, e.time_range.end
                dev.append((s, t))
                k = kernels.setdefault(e.name, [0.0, 0])
                k[0] += (t - s) / 1e6
                k[1] += 1
            elif e.name != self.MARK:
                host.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        busy, gaps, cursor = 0.0, [], lo
        for s, t in dev:
            s, t = max(s, lo), min(t, hi)
            if t <= cursor:
                continue
            if s > cursor:
                gaps.append((cursor, s))
                busy += t - s
            else:
                busy += t - cursor
            cursor = t
        if cursor < hi:
            gaps.append((cursor, hi))
        gaps.sort(key=lambda g: g[0] - g[1])

        def doing(a, b):
            mid = (a + b) / 2
            cover = [(t - s, n) for s, t, n in host if s <= mid <= t]
            return max(cover)[1] if cover else "no traced host operation"

        idle = [[doing(a, b)[:120], (b - a) / 1e6] for a, b in gaps[:10]]
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
                "kernels": kernels,
                "breakdown": {"device_ops": [[n[:120], v[0]] for n, v in top],
                              "idle_gaps": idle}}


def kernel_time(kernels: dict, patterns) -> (float, int):
    """(summed seconds, launches) of the traced kernels whose name holds
    one of `patterns`."""
    secs, count = 0.0, 0
    for name, (s, n) in kernels.items():
        if any(p in name for p in patterns):
            secs += s
            count += n
    return secs, count


def emit(result: dict, checks: Dict[str, tuple]) -> None:
    """Print the numbers compared with their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the checks under the key that comes last."""
    for name, (value, limit) in checks.items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    result["checks"] = {n: {"value": v, "limit": l}
                        for n, (v, l) in checks.items()}
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


def now() -> float:
    return time.perf_counter()
