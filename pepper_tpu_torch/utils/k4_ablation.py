"""Where a step of K4's cluster recurrence goes, on one NVIDIA card.

    python3 -m pepper_tpu_torch.utils.k4_ablation

Builds variants of `pepper_tpu_torch/csrc/fused_lstm_train.cu` from a copy
of the sources under the git-ignored `build/k4_ablation/`, each leaving out
one part of the cluster recurrence's step (`bilstm_bwd_cluster_kernel` in
`fused_lstm_bwd_cluster.cuh`), and prints the recurrence's device time
(torch.profiler, mean per launch over 5 calls) for each at the trainer's
shapes (f32, T=33, H=256, batch 64 and 512):

  base                    the kernel as committed;
  no_product              without dgates @ W_hh (the partials sent are 0);
  no_exchange             without the stores into the peers' shared memory
                          (the product, whose result is then unused, is
                          left out by the compiler too);
  no_exchange_no_barrier  also without the per-step cluster barrier;
  no_io                   without the step's loads of the residuals and its
                          stores of dxp.

The variants compute wrong gradients; they only time the parts. Exits with
another code than 0 where there is no CUDA device.
"""
import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(ROOT, "build", "k4_ablation")
VARIANTS = {"base": [], "no_product": ["ABL_NO_PRODUCT"],
            "no_exchange": ["ABL_NO_EXCHANGE"],
            "no_exchange_no_barrier": ["ABL_NO_EXCHANGE", "ABL_NO_BARRIER"],
            "no_io": ["ABL_NO_IO"]}
# (first line, last line, macro) of each part, as the header has them
PARTS = [
    ("#pragma unroll 4\n      for (int j = 0; j < kBwdCols; j += 4) {",
     "acc[r] = fmaf(d4.w, w4.w, acc[r]);\n        }\n      }",
     "ABL_NO_PRODUCT"),
    ("#pragma unroll\n      for (int r = 0; r < kRows; r += 2)\n"
     "        store_peer(", "make_float2(acc[r], acc[r + 1]));",
     "ABL_NO_EXCHANGE"),
    ("      cluster_arrive();\n      cluster_wait();\n      // dh of this",
     "cluster_wait();", "ABL_NO_BARRIER"),
    ("          for (int q = 0; q < 4; ++q) dx[q * kH] = dg[rr][q];",
     "dg[rr][q];", "ABL_NO_IO"),
    ("#pragma unroll\n      for (int rr = 0; rr < 2; ++rr)\n"
     "        res[rr] = load_residuals(", "s + 1, unit);", "ABL_NO_IO"),
]


def patched_sources() -> str:
    """A copy of csrc/ whose cluster recurrence has each part of PARTS
    between `#ifndef MACRO` and `#endif`; its directory."""
    src = os.path.join(WORK, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "pepper_tpu_torch", "csrc"), src)
    path = os.path.join(src, "fused_lstm_bwd_cluster.cuh")
    with open(path) as fh:
        text = fh.read()
    for first, last, macro in PARTS:
        a = text.index(first)
        b = text.index(last, a) + len(last)
        text = (text[:a] + f"#ifndef {macro}\n" + text[a:b] + "\n#endif\n"
                + text[b:])
    with open(path, "w") as fh:
        fh.write(text)
    return src


def build_all(src: str) -> dict:
    """Every variant's library, built at the same time."""
    from pepper_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, macros in VARIANTS.items():
        out = os.path.join(WORK, f"lib_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc()] + flags + [f"-D{m}" for m in macros]
            + ["-o", out, os.path.join(src, "fused_lstm_train.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(out)
    return libs


def recurrence_ms(fn, reps: int = 5) -> float:
    """Device ms of the cluster recurrence per launch (one a call of fn):
    the mean over the launches a trace of `reps` calls recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "bilstm_bwd_cluster" in e.name]
    return sum(times) / len(times) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_ablation: no CUDA device", file=sys.stderr)
        return 2
    from pepper_tpu_torch.ops import fused_lstm as fl

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    libs = build_all(patched_sources())
    real = fl._train_kernel_lib()
    for lib in libs.values():
        for fn in ("pepper_bilstm_train_backward",
                   "pepper_bilstm_train_backward_scratch"):
            getattr(lib, fn).restype = getattr(real, fn).restype
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    H, T, F = 256, 33, 26
    params = {n: ((torch.rand((4 * H, F) if "weight_ih" in n else (4 * H, H)
                              if "weight_hh" in n else (4 * H,),
                              generator=gen) * 2 - 1) / H ** 0.5).to(dev)
              for n in fl._PARAM_NAMES}
    pack = fl.packed_layer(params, "cluster_fma")
    for B in (64, 512):
        x = torch.randn(B, T, F, generator=gen).to(dev)
        out, gates, cs = fl.bilstm_train_forward_packed(
            pack, *fl.packed_projections(pack, x))
        gout = torch.randn(B, T, 2 * H, generator=gen).to(dev)
        times = {}
        try:
            for name, lib in libs.items():
                fl._train_lib = lib
                times[name] = recurrence_ms(lambda: fl.launch_backward(
                    "cluster_fma", pack, gout, gates, cs, out))
        finally:
            fl._train_lib = real
        print(f"K4 cluster recurrence B={B} T={T} H={H} f32 on {card} "
              f"(torch.profiler, mean per launch over 5 calls): "
              + ", ".join(f"{name} {ms:.4f} ms"
                          for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
