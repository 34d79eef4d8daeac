"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under `pepper_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, written into
`build/pepper_tpu_torch/csrc/` at the root of the checkout (git-ignored).
A library is rebuilt when its source or a header beside it is newer. First
uses of different libraries build at the same time; concurrent first uses of
one library (test workers, threads) serialize on a file lock, and the library
is renamed into place only when complete.
"""
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pepper_tpu_torch",
                         "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# seconds each library took to build in this process (0.0 when it was
# already built); read by chip_smoke.py
build_seconds: Dict[str, float] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()                      # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}   # one build or load per library


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills)."""
    path = os.path.join(BUILD_DIR, f"lib{name}.build.log")
    if not os.path.isfile(path):
        return ""
    with open(path) as fh:
        return fh.read()


def _build(name: str, source: str, defines: Sequence[str]) -> float:
    lib = library_path(name)
    inputs = [source] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    if (os.path.isfile(lib) and os.path.getmtime(lib)
            >= max(os.path.getmtime(p) for p in inputs)):
        return 0.0
    t0 = time.time()
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ([nvcc()] + NVCC_FLAGS + [f"-D{d}" for d in defines]
           + ["-o", tmp, source])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(os.path.join(BUILD_DIR, f"lib{name}.build.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n"
                           + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, lib)
    return time.time() - t0


def load_library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The CDLL built from csrc/<name>.cu, building it first if needed.
    With `defines` (preprocessor macros) it is a variant of that source,
    built beside it as lib<name>_<macros>.so."""
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    name = "_".join([name] + [d.lower() for d in defines])
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f"lib{name}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                build_seconds[name] = _build(name, source, defines)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
