"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel library (nvcc, from pepper_tpu_torch/csrc/)
and its native host library (g++, from pepper_tpu_torch/native/src/) into
the git-ignored build/ directory, then:

  1. prints the card, its power limit, the torch/CUDA versions, the build
     times, and whether the native host encoder and h5py are there;
  2. holds kernel K1 (fused biLSTM recurrence) against its plain PyTorch
     version at the runner's shapes and on a ragged HP-window shape, bf16
     and f32, and times it beside its bound, the plain version and
     nn.LSTM (cuDNN) as a yardstick;
  3. runs the classifier forward at full width on the card and holds it
     against the plain f32 CPU forward;
  4. runs the streamed call_variant end to end on a synthetic ~100 kb
     dataset on the card (bf16, then f32) and on the CPU (f32), checks
     that K1 was launched and that the VCFs agree;
  5. prints one JSON line describing every ported kernel.

The last line is {"ok": true, "device": {...}}. Any failed phase raises, so
the run exits non-zero without that line; so does a machine with no CUDA
device or a directory that holds this script alone.
"""
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# datasheet peaks of one H100 SXM (dense): bf16 tensor cores, fp32 (no
# tensor cores), HBM bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
H = 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over `reps` CUDA-event timings of fn() on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_breakdown(fn, reps: int = 3) -> dict:
    """Device milliseconds per call of fn, by kernel name, from a
    torch.profiler (CUPTI) trace of `reps` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / reps)
    return per_kernel


def numpy_variant_tree(seed: int, features: int = 26, window: int = 33):
    """Seeded torch-default init (U(+-1/sqrt(fan))) of the classifier, as
    numpy arrays with the torch-layout names the checkpoints use."""
    rng = np.random.default_rng(seed)

    def u(shape, fan):
        b = 1.0 / np.sqrt(fan)
        return rng.uniform(-b, b, shape).astype(np.float32)

    def rnn(f):
        out = {}
        for sfx in ("", "_reverse"):
            out["weight_ih_l0" + sfx] = u((4 * H, f), H)
            out["weight_hh_l0" + sfx] = u((4 * H, H), H)
            out["bias_ih_l0" + sfx] = u((4 * H,), H)
            out["bias_hh_l0" + sfx] = u((4 * H,), H)
        return out

    def lin(i, o):
        return {"weight": u((o, i), i), "bias": u((o,), i)}

    tree = {"encoder": rnn(features), "decoder": rnn(2 * H),
            "linear_1": lin(2 * H * window, 512)}
    for k in range(2, 6):
        tree[f"linear_{k}"] = lin(512, 512)
    tree["output_layer_type"] = lin(512, 3)
    return tree


def images(rng, n: int, window: int = 33, features: int = 26) -> np.ndarray:
    """int8 candidate images: sparse pileup-like counts in [-125, 125]."""
    x = rng.integers(-125, 126, (n, window, features))
    x[rng.random(x.shape) < 0.7] = 0
    return x.astype(np.int8)


# --------------------------------------------------------------- phase 1
def phase_environment():
    from pepper_tpu_torch.native import bamio
    from pepper_tpu_torch.ops import cuda_build, fused_lstm
    from pepper_tpu_torch.pipelines.datastore import h5py_available

    errors = []

    def build(fn):
        try:
            fn()
        except Exception as exc:   # re-raised on the main thread below
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(fused_lstm._kernel_lib,)),
               threading.Thread(target=build, args=(bamio.available,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ptxas = [ln.strip() for ln in cuda_build.build_log("fused_lstm")
             .splitlines() if "registers" in ln or "spill" in ln]
    env = {"card": card(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kernel_build_s": round(cuda_build.build_seconds["fused_lstm"], 2),
           "native_build_s": (None if bamio.build_seconds is None
                              else round(bamio.build_seconds, 2)),
           "native_host": bamio.available(),
           "h5py": h5py_available()}
    print("environment: " + json.dumps(env), flush=True)
    if not env["native_host"]:
        print("native_host: false — the host encoder falls back to the "
              "pure-Python path: " + str(bamio.build_error())[-500:],
              flush=True)
    print("ptxas: " + " | ".join(ptxas), flush=True)
    return env


# --------------------------------------------------------------- phase 2
def k1_bound_ms(B: int, T: int, elem: int, peak_ops: float):
    """(bound ms, bound_by): xp (both directions) read once, out written
    once, W_hh^T read once; 2*2*T*B*H*4H operations."""
    nbytes = (2 * B * T * 4 * H + B * T * 2 * H + 2 * H * 4 * H) * elem
    ops = 2 * 2 * T * B * H * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.ops import fused_lstm as fl

    rng = np.random.default_rng(11)
    tree = numpy_variant_tree(12)
    hp_tree = numpy_variant_tree(13, features=48, window=21)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    timed = None
    cases = [("runner", 16384, 33, 26, tree), ("hp_ragged", 1000, 21, 48,
                                                hp_tree)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, T, F, t in cases:
            params = params_from_jax(t, dev, dtype)
            x = torch.from_numpy(images(rng, B, T, F)).to(dev, dtype)
            for layer in ("encoder", "decoder"):
                p = params[layer]
                xp_f, xp_b = fl.input_projections(p, x)
                w_f, w_b = p["weight_hh_l0"].t(), p["weight_hh_l0_reverse"].t()
                got = fl.bilstm_recurrence_kernel(xp_f, xp_b, w_f, w_b)
                torch.cuda.synchronize()
                want = fl.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b)
                err = (got.float() - want.float()).abs().max().item()
                check(bool(torch.isfinite(got.float()).all()),
                      f"K1 non-finite output ({label} {layer} {dtype})")
                print(f"K1 {label} B={B} T={T} {layer} (F={x.shape[-1]}) "
                      f"{str(dtype)[6:]}: max_abs_err {err:.3e} "
                      f"(tolerance {tol[dtype]:g})", flush=True)
                check(err <= tol[dtype], f"K1 disagrees with its plain "
                      f"version: {err} > {tol[dtype]} ({label} {layer} "
                      f"{dtype})")
                worst[dtype] = max(worst[dtype], err)
                if (label, layer, dtype) == ("runner", "encoder",
                                             torch.bfloat16):
                    timed = (xp_f, xp_b, w_f, w_b)
                x = want   # the next layer reads this layer's output
    xp_f, xp_b, w_f, w_b = timed
    B, T = xp_f.shape[:2]
    kernel_ms = median_ms(
        lambda: fl.bilstm_recurrence_kernel(xp_f, xp_b, w_f, w_b))
    plain_ms = median_ms(
        lambda: fl.bilstm_recurrence_plain(xp_f, xp_b, w_f, w_b))
    lstm = torch.nn.LSTM(26, H, batch_first=True, bidirectional=True).to(
        dev, torch.bfloat16)
    lstm.flatten_parameters()
    x = torch.from_numpy(images(rng, B, T, 26)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        library_ms = median_ms(lambda: lstm(x))
    bound_ms, bound_by = k1_bound_ms(B, T, 2, PEAK_BF16)
    f32_bound_ms, _ = k1_bound_ms(B, T, 4, PEAK_FP32)
    print(f"K1 timing B={B} T={T} H={H} bf16 (median of 10, CUDA events): "
          f"kernel_ms {kernel_ms:.3f} plain_ms {plain_ms:.3f} bound_ms "
          f"{bound_ms:.3f} ({bound_by}) library_ms {library_ms:.3f} "
          f"(nn.LSTM bf16, cuDNN, incl. its input projection); "
          f"f32 bound at the FP32 peak {f32_bound_ms:.3f} ms", flush=True)
    return {"name": "K1 fused_bilstm", "route": "cuda",
            "source": "pepper_tpu_torch/csrc/fused_lstm.cu",
            "replaces": "pepper_tpu/ops/fused_lstm.py:27",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# --------------------------------------------------------------- phase 3
def phase_model(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.variant_model import variant_forward

    tree = numpy_variant_tree(21)
    x8 = torch.from_numpy(images(np.random.default_rng(22), 512))
    with torch.inference_mode():
        want = variant_forward(params_from_jax(tree), x8.float())
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            got = variant_forward(params_from_jax(tree, dev, dtype),
                                  x8.to(dev).to(dtype)).float().cpu()
            check(got.shape == (512, 3) and bool(torch.isfinite(got).all()),
                  f"classifier output malformed ({dtype})")
            errs[dtype] = (got - want).abs().max().item()
    print(f"model: full-width variant_forward on the card vs the plain CPU "
          f"f32 forward, 512 rows: max_abs_prob_diff bf16 "
          f"{errs[torch.bfloat16]:.3e} (tolerance 2e-2), f32 "
          f"{errs[torch.float32]:.3e} (tolerance 1e-3)", flush=True)
    check(errs[torch.bfloat16] <= 2e-2, "bf16 classifier disagrees")
    check(errs[torch.float32] <= 1e-3, "f32 classifier disagrees")


# --------------------------------------------------------------- phase 4
def _call_records(out_dir):
    from pepper_tpu_torch.io.vcf import read_vcf

    paths = sorted(glob.glob(os.path.join(out_dir, "*.vcf.gz")))
    check(len(paths) == 5, f"expected 5 VCFs in {out_dir}, got {paths}")
    recs = set()
    for path in paths:
        check(os.path.getsize(path) > 0, f"empty VCF {path}")
        for r in read_vcf(path):
            gt = r.samples[0][r.format.index("GT")]
            recs.add((os.path.basename(path), r.contig, r.pos, r.ref,
                      ",".join(r.alts), gt))
    return recs


def phase_end_to_end(dev, work_dir, name):
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.pipelines.call_variant import call_variant
    from pepper_tpu_torch.presets import set_parameters
    from pepper_tpu_torch.runtime import streaming
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads, write_dataset)

    genome_len = 100_000
    t0 = time.time()
    genome = random_genome(genome_len, seed=31)
    variants = plant_variants(dict(genome), 100, 20, 20, seed=32)
    fasta, bam = write_dataset(work_dir, genome, simulate_reads(
        genome, variants, coverage=30, seed=33))
    model = os.path.join(work_dir, "model.npz")
    save_checkpoint(model, numpy_variant_tree(34), {"epochs": 0})
    print(f"e2e dataset: {genome_len} bp, 140 planted variants, coverage "
          f"30 [{time.time() - t0:.1f}s]", flush=True)

    stream_totals = []
    real_stream = streaming.stream_inference

    def counted_stream(*args, **kwargs):
        stream_totals.append(real_stream(*args, **kwargs))
        return stream_totals[-1]

    streaming.stream_inference = counted_stream

    def run(label, device, precision):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        out = os.path.join(work_dir, label) + "/"
        config = set_parameters(PipelineConfig(
            bam=bam, fasta=fasta, output_dir=out, model_path=model,
            ont_r9_guppy5_sup=True, threads=4, region_size=25000,
            device=device))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        call_variant(config)
        wall = time.time() - t
        return out, wall

    try:
        fl.launches = 0                       # count the main path only
        out_cuda, wall_cuda = run("cuda_bf16", "cuda", "bf16")
        launches = fl.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches > 0, "the streamed run on the card never launched K1")
        cands = stream_totals[-1]
        runner = streaming.get_device_runner(model, 16384, "cuda")
        x8 = torch.from_numpy(images(np.random.default_rng(35),
                                     runner.batch)).to(dev)
        forward_ms = median_ms(lambda: runner.forward(x8), reps=10)
        per_kernel = device_breakdown(lambda: runner.forward(x8))
        rec_cuda = _call_records(out_cuda)
        out_cpu, wall_cpu = run("cpu_f32", "cpu", "f32")
        rec_cpu = _call_records(out_cpu)
        out_f32, wall_f32 = run("cuda_f32", "cuda", "f32")
        rec_f32 = _call_records(out_f32)
    finally:
        streaming.stream_inference = real_stream
        os.environ.pop("PEPPER_TPU_PRECISION", None)
    mbp = genome_len / 1e6
    print(f"e2e streamed call_variant on {name}: {cands} candidates; "
          f"cuda bf16 wall {wall_cuda:.2f}s ({mbp / wall_cuda:.4f} Mbp/s), "
          f"K1 launches {launches}, device forward {forward_ms:.2f} ms per "
          f"{runner.batch}-row batch, peak CUDA memory {peak_gb:.2f} GB; "
          f"cuda f32 wall {wall_f32:.2f}s; cpu f32 wall {wall_cpu:.2f}s "
          f"({mbp / wall_cpu:.4f} Mbp/s)", flush=True)
    total = sum(per_kernel.values())
    if total:
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile of one {runner.batch}-row forward (torch.profiler, "
              f"mean of 3): device busy {total:.2f} ms; " + "; ".join(
                  f"{name[:70]} {ms:.2f} ms ({100 * ms / total:.0f}%)"
                  for name, ms in top), flush=True)
    else:
        print("profile: torch.profiler recorded no device time (device "
              "breakdown not measured)", flush=True)
    diff_bf16 = len(rec_cuda ^ rec_cpu)
    diff_f32 = len(rec_f32 ^ rec_cpu)
    print(f"e2e VCF records (file, contig, pos, ref, alt, GT): cpu f32 "
          f"{len(rec_cpu)}, cuda bf16 {len(rec_cuda)} ({diff_bf16} differ "
          f"from cpu f32), cuda f32 {len(rec_f32)} ({diff_f32} differ)",
          flush=True)
    check(len(rec_cpu) > 0, "the CPU run called no variants")
    check(diff_f32 == 0, "cuda f32 and cpu f32 call different records")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    env = phase_environment()
    kernel = phase_kernel(dev)
    phase_model(dev)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(ROOT, "build"))
    try:
        kernel["launches"] = phase_end_to_end(dev, work_dir, env["card"])
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
