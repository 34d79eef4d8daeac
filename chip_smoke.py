"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel libraries (nvcc, from pepper_tpu_torch/csrc/)
and its native host library (g++, from pepper_tpu_torch/native/src/), all
at once, into the git-ignored build/ directory, then:

  1. prints the card, its power limit, the torch/CUDA versions, the build
     times, and whether the native host encoder and h5py are there;
  2. holds kernel K1 (fused biLSTM recurrence: the tensor-core cluster
     kernel in bf16, the FMA cluster kernel in f32, the generic kernel for
     other widths) against its plain PyTorch version at the runner's
     shapes, on a ragged HP-window shape, one row past many tiles, fewer
     rows than a tile, one step and hidden 128 and 32, two calls
     bit-identical, and times it beside its bound, the generic kernel, the
     plain version, nn.LSTM (cuDNN) as a yardstick, and a build of the same
     kernel with exact tanhf/expf in place of tanh.approx;
  3. holds kernel K2 (fused biGRU recurrence, h0 in, final h out: the
     tensor-core kernel in bf16, the generic kernel in f32) against its
     plain version at the polish shapes (encoder and decoder layers), on a
     ragged batch and at one row, one step, hidden 64, two calls
     bit-identical, and times it beside its bound, the generic kernel, the
     plain version, nn.GRU (cuDNN) and a build with exact tanhf/expf;
  4. runs the classifier forward at full width on the card and holds it
     against the plain f32 CPU forward;
  5. runs the polish model and the window/vote consensus at full width on
     the card and holds them against the plain f32 CPU versions;
  6. runs the streamed call_variant end to end on a synthetic ~100 kb
     dataset on the card (bf16, then f32) and on the CPU (f32), checks
     that K1 was launched and that the VCFs agree, and that the forward's
     device time by kernel holds no elementwise pass over the input
     projections (the biases are added inside K1);
  7. runs the streamed polish end to end on a synthetic ~100 kb draft on
     the card (bf16, then f32) and on the CPU (f32), checks that K2 was
     launched 38 times per device batch and that the consensus agrees;
     prints one batch's device time, busy and idle share and K2's share;
  8. holds kernels K3 (residual-saving biLSTM forward) and K4 (BPTT
     backward and dW_hh, the cluster pair or the generic pair) against
     their plain versions at the trainer's shapes (batch 512 and 64,
     encoder and decoder layers), on a ragged HP-window shape, at the
     cluster kernels' tile edges and at hidden 128 and 32, K3 also in bf16,
     two calls bit-identical, and through the autograd function every
     gradient against autograd through the plain step loop; times both
     beside their bounds, the generic kernels, the plain versions and
     nn.LSTM (cuDNN) forward and backward, K4 split into its recurrence and
     dW_hh, both kernels of each past their selection thresholds, and the
     host time per K3 and K4 launch;
  9. takes one full-width train step on the card and holds its loss, every
     gradient and the updated parameters against the same step on the CPU;
 10. trains for ~20 steps at batch 64 on labeled images encoded in memory
     from a synthetic dataset with a truth VCF, with evals and checkpoints,
     checks that K3 and K4 were each launched twice per step and K1 by the
     evals, that the loss fell, and that the checkpoint resumes with its
     optimizer state; prints ms per step, its busy and idle share, the
     device time by kernel (K4's share) and the peak memory;
 11. runs the streamed call_variant --use_hp_info (21x48 images, a
     48-feature classifier) on a synthetic ~60 kb dataset with
     haplotype-tagged reads on the card (bf16, then f32) and on the CPU
     (f32), checks that K1 was launched and that CUDA f32 calls the CPU's
     records, and merges a DeepVariant VCF into the output with
     merge_variants (positional overlay, indexed);
 12. trains the polish model on labeled images encoded in memory from a
     synthetic draft with a truth BAM: 3 window steps at batch 64 on the
     card held against the CPU, then one epoch of train_polish's loop with
     an eval, checking that K2 was launched twice per eval window and never
     under grad, that the stats files and checkpoints exist and that a
     resume restores the optimizer state, and that a CUDA fused_bigru under
     grad raises; prints ms per window step, its busy and idle share and
     the peak memory;
 13. runs the classifier's runner over a 2-entry mesh on the one card (two
     replicas, each on its own stream) at 16384 rows of 33x26 and of the
     HP 21x48 geometry, and the polish vote function over the same mesh,
     against one replica in bf16: bitwise equal, and K1 and K2 on two
     halves of a batch bitwise equal to the whole; at 4096 rows, where
     the linear layers' cuBLAS kernels differ between the shard's row
     count and the whole's, within bf16 rounding; times both;
 14. runs the streamed call_variant of phase 6's dataset as two hosts in
     filesystem mode (two processes, --num_hosts 2 --host_id 0/1, one
     shared output directory) and holds host 0's VCFs byte for byte
     against phase 6's 1-host run; prints each host's wall time and the
     candidate gather's wait;
 15. trains the full-width classifier for 4 steps at global batch 128 with
     dropout on in two ranks of a gloo group on the one card (NCCL refuses
     two ranks on one card), holds the parameters and losses against one
     process that runs the same two blocks as in-process replicas and the
     ranks against each other (bit-identical), checks that K3 and K4
     launched in each rank, and prints the ms per step and the
     all-reduce's share of it;
 16. runs parallel/dryrun.py::dryrun_multichip(2) on the card;
 17. runs the alternate models at full width on the card in f32 (TF32
     off) against the port on the CPU in f32: the transformer (F=26,
     window 33, 6 layers, d=104) and the no-CNN biLSTM (hidden 128, a
     random carried state) on 4096 rows, the Seq2Seq encoder (hidden 128,
     3 biGRU layers) on a [64,1,1000,20] image and its decoder (seq_len
     1000, 5 classes) on that context: probabilities, hidden states and
     attention within 1e-4, and no kernel launched (none serves them);
     prints each one's ms per forward and the bf16 error;
 18. runs the legacy chunked-HP chain on phase 11's dataset: the port's
     RegionalSummaryHP makes the 48-feature matrix, make_chunked_hp_images
     chunks it, a full-width polish model (F=48, H=128, 5 classes) votes
     through K2 (76 launches per 64-chunk batch, checked) on the card in
     bf16 and f32 and through the plain step loop on the CPU, and
     CandidateFinderCPP.find_candidates_hp reads each run's votes from the
     in-memory records: the f32 votes within +-2 of the CPU's and the same
     candidates called; prints ms per batch, K2's share of it, and the
     bf16 vote and candidate differences;
 19. runs the scale rehearsal (pepper_tpu_torch/utils/scale_rehearsal.py)
     on the card at 6 Mbp over 3 contigs, coverage 30, 10 kb reads, in
     bf16 at the 16384-row batch: two uninterrupted streamed call_variant
     runs, a kill -9 after half of the batches that must exit 9, and a
     resume that must replay at least one interval and write 5 VCFs
     byte-identical to the uninterrupted run's; prints its JSON record
     (with the card's busy time in the stream and the child's resident
     memory by kind), and checks that K1 was launched twice per batch in
     the measured run;
 20. runs the streamed polish of phase 7's dataset on the card (bf16) in a
     subprocess, uninterrupted, then killed after half of its sequences
     (exit 9, journal left), then resumed: the polished FASTA must be
     byte-identical to the uninterrupted run's, with at least one interval
     replayed and K2 launched 38 times per batch in each run;
 21. runs the port's bench (pepper_tpu_torch/utils/bench.py) on the card
     at 1 Mbp with one timed e2e run in a subprocess: it must exit 0 and
     print its headline, and its launches per stage must be K1 twice per
     16384-row batch in each device-only and e2e pass, K2 38 times per
     128-sequence polish batch, K3 and K4 twice per train step; prints its
     stage lines and the phase's wall time;
 22. runs the port's host profiler (utils/profile_stream.py) at 1 Mbp, one
     run per variant, on phase 21's dataset: it must exit 0 and print its
     three variants;
 23. trains the full-width classifier with the port's train_loop on the
     card (batch 64, lr 3e-4) on labeled images of a 1 Mbp dataset at the
     bench's read settings (seeds 41/42/43, a tenth held out), in rounds
     of 100 steps that resume with their optimizer state until the
     held-out accuracy has not risen for two rounds (at least 300 steps),
     checking K3 and K4 twice per step and K1 in every eval; then calls
     variants through the port's call_variant CLI with the best checkpoint
     on phase 21's 1 Mbp dataset on the card (bf16, f32) and the CPU
     (f32), and once with the bench's random weights: planted-SNP recall
     >= 0.6 in both dtypes (tests/test_e2e_model.py's bar), K1 twice per
     16384-row batch in every card run, CUDA f32 calling the CPU's
     (contig, pos, ref, alt, GT) set, and bf16 against f32 at most 0.5%
     of the records differing, none gained or lost, SNP and INDEL F1
     within 0.01; prints SNP and INDEL precision, recall and F1
     (utils/acceptance.py::evaluate on the contig), the record diffs,
     and each run's candidates, records, PASS records and the stream's
     gates and vcf_emit core-seconds;
 24. trains the full-width polish model with train_polish_loop on the card
     (batch 32, one epoch, lr 1e-3) on a 100 kb draft with 110 planted
     corrections and a truth-to-draft BAM, then polishes the draft through
     the port's polish CLI with that checkpoint on the card (bf16, f32)
     and the CPU (f32): length > 0.95 of the truth's, 21-mer identity >
     0.95 and >= 70% of the corrections recovered in both dtypes
     (tests/test_polish.py's bars), K2 twice per eval window and 38 times
     per 128-sequence batch in both card runs, CUDA f32's base labels
     equal to the CPU's except at a CPU vote margin under 1e-4, and bf16
     against f32 at most 0.05% of the bases and 0.001 of identity apart;
 25. prints one JSON line describing every ported kernel, with each one's
     launches in phase 21's bench (launches_bench) and on phases 23-24's
     trained path (launches_trained).

The last line is {"ok": true, "device": {...}}. Any failed phase raises, so
the run exits non-zero without that line; so does a machine with no CUDA
device or a directory that holds this script alone.
"""
import glob
import json
import os
import shutil
import socket
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
H = 256            # classifier biLSTM hidden size
PH = 128           # polish biGRU hidden size
WINDOW = 100       # polish window (19 per 1000-long sequence)
POLISH_BATCH = 128
SHARD_ROWS = 16384   # the streamed runner's batch on the card
ALT_ROWS = 4096      # rows of the alternate classifiers' batch (phase 17)
# builds the tensor-core K1 and K2 with tanhf/expf in place of tanh.approx
EXACT_ACTIVATIONS = ("PEPPER_EXACT_ACTIVATIONS",)


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


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of fn() while the device queue has room:
    n calls enqueued back to back from an idle device, no wait between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


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
        # kernels and copies only: an annotation's span on the device (the
        # optimizer's step) covers kernels that are counted themselves
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / reps)
    return per_kernel


def per_launch_ms(fn, reps: int = 5) -> dict:
    """Device milliseconds per launch by kernel name, with the number of
    launches: the mean over the launches a torch.profiler (CUPTI) trace of
    `reps` calls of fn recorded, after one warm-up. A mean per recorded
    launch, not a sum over the calls: a trace can miss a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = total.get(e.name, (0.0, 0))
            total[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {name: (ms / n, n) for name, (ms, n) in total.items()}


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _rel_err(got, want) -> float:
    """Max abs error relative to the reference's largest entry (at least
    1): sums of B*T products taken in another order."""
    return _max_err(got, want) / max(1.0, want.float().abs().max().item())


def images(rng, n: int, window: int = 33, features: int = 26) -> np.ndarray:
    """int8 candidate images: sparse pileup-like counts in [-125, 125]."""
    x = rng.integers(-125, 126, (n, window, features))
    x[rng.random(x.shape) < 0.7] = 0
    return x.astype(np.int8)


def polish_images(rng, n: int) -> np.ndarray:
    """uint8 polish pileup images [n, 1000, 10]: counts 0..254, half of the
    nonzero ones above 127 (int8 staging would wrap them)."""
    x = rng.integers(0, 255, (n, 1000, 10))
    x[rng.random(x.shape) < 0.5] = 0
    return x.astype(np.uint8)


# --------------------------------------------------------------- phase 1
def phase_environment():
    from pepper_tpu_torch.native import bamio
    from pepper_tpu_torch.ops import cuda_build, fused_gru, fused_lstm
    from pepper_tpu_torch.pipelines.datastore import h5py_available

    errors = []

    def build(fn):
        try:
            fn()
        except Exception as exc:   # re-raised on the main thread below
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(fn,)) for fn in (
        fused_lstm._kernel_lib, fused_lstm._train_kernel_lib,
        fused_gru._kernel_lib, bamio.available,
        lambda: fused_lstm.load_forward_library(EXACT_ACTIVATIONS),
        lambda: fused_gru.load_kernel_library(EXACT_ACTIVATIONS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ptxas = [f"{name}: {ln.strip()}" for name in ("fused_lstm", "fused_lstm_train",
                                                    "fused_gru")
             for ln in cuda_build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    env = {"card": card(), "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "kernel_build_s": {name: round(sec, 2) for name, sec in
                              cuda_build.build_seconds.items()},
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


def _layer_args(p):
    """(W_hh^T forward, W_hh^T reverse, the four biases) of a layer."""
    from pepper_tpu_torch.ops import fused_lstm as fl

    return (p["weight_hh_l0"].t(), p["weight_hh_l0_reverse"].t(),
            fl.layer_biases(p))


def phase_kernel(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_lstm as fl

    rng = np.random.default_rng(11)
    tree = numpy_variant_params(12)
    hp_tree = numpy_variant_params(13, image_features=48, window=21)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    timed = {}
    # the runner's batch, a ragged HP-window batch, and where a cluster
    # kernel's tiles can go wrong: one row past many tiles, fewer rows than
    # one tile, one step
    cases = [("runner", 16384, 33, 26, tree),
             ("hp_ragged", 1000, 21, 48, hp_tree),
             ("one_past_the_tiles", 16385, 2, 26, tree),
             ("below_one_tile", 5, 33, 26, tree),
             ("one_step", 37, 1, 26, tree)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, T, F, t in cases:
            params = params_from_jax(t, dev, dtype)
            x = torch.from_numpy(images(rng, B, T, F)).to(dev, dtype)
            for layer in ("encoder", "decoder"):
                p = params[layer]
                name = fl.select_kernel(B, T, H, dtype)
                pack = fl.packed_layer(p, name)
                xp = fl.packed_projections(pack, x)
                got = fl.bilstm_recurrence_packed(pack, *xp)
                again = fl.bilstm_recurrence_packed(pack, *xp)
                torch.cuda.synchronize()
                raw = fl.raw_projections(p, x)
                want = fl.bilstm_recurrence_plain(*raw, *_layer_args(p))
                err = (got.float() - want.float()).abs().max().item()
                check(bool(torch.isfinite(got.float()).all()),
                      f"K1 non-finite output ({label} {layer} {dtype})")
                check(torch.equal(got, again), f"K1 is not bit-identical "
                      f"across two calls ({label} {layer} {dtype})")
                print(f"K1 {name} {label} B={B} T={T} {layer} (F="
                      f"{x.shape[-1]}) {str(dtype)[6:]}: max_abs_err "
                      f"{err:.3e} (tolerance {tol[dtype]:g}); two calls "
                      f"bit-identical", flush=True)
                check(err <= tol[dtype], f"K1 disagrees with its plain "
                      f"version: {err} > {tol[dtype]} ({label} {layer} "
                      f"{dtype})")
                worst[dtype] = max(worst[dtype], err)
                if (label, layer) == ("runner", "encoder"):
                    timed[dtype] = (p, x, pack, xp, raw)
                x = want   # the next layer reads this layer's output
    # H=128 (the cluster kernels' other width) and a width only the generic
    # kernel takes, through the layer function
    for Hs, dtype in ((128, torch.bfloat16), (128, torch.float32),
                      (32, torch.bfloat16)):
        g = torch.Generator().manual_seed(Hs)
        p = {n: ((torch.rand((4 * Hs, 26) if "weight_ih" in n else
                             (4 * Hs, Hs) if "weight_hh" in n else (4 * Hs,),
                             generator=g) * 2 - 1) / Hs ** 0.5).to(dev, dtype)
             for n in fl._PARAM_NAMES}
        x = torch.from_numpy(images(rng, 37, 17, 26)).to(dev, dtype)
        got = fl.fused_bilstm(p, x)
        torch.cuda.synchronize()
        want = fl.bilstm_recurrence_plain(*fl.raw_projections(p, x),
                                          *_layer_args(p))
        err = (got.float() - want.float()).abs().max().item()
        print(f"K1 {fl.select_kernel(37, 17, Hs, dtype)} H={Hs} B=37 T=17 "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} (tolerance "
              f"{tol[dtype]:g})", flush=True)
        check(err <= tol[dtype], f"K1 disagrees with its plain version at "
              f"H={Hs} {dtype}: {err}")
        worst[dtype] = max(worst[dtype], err)

    p, x, pack, xp, raw = timed[torch.bfloat16]
    B, T = x.shape[:2]
    # the generic kernel (the only K1 before the cluster kernels), on the
    # same raw projections in its own column order
    old_pack = fl.packed_layer(p, "generic")
    old_xp = fl.packed_projections(old_pack, x)
    runs = {"cluster_mma": [], "generic": []}
    for name, pk, xs in (("generic", old_pack, old_xp),
                         ("cluster_mma", pack, xp),
                         ("cluster_mma", pack, xp),
                         ("generic", old_pack, old_xp)):
        runs[name].append(median_ms(
            lambda: fl.bilstm_recurrence_packed(pk, *xs)))
    kernel_ms, old_ms = min(runs["cluster_mma"]), min(runs["generic"])
    del old_xp
    # what tanh.approx buys: the same kernel built with tanhf/expf, timed
    # approx, exact, exact, approx, and both held to the plain version
    want = fl.bilstm_recurrence_plain(*raw, *_layer_args(p))
    approx_err = _max_err(fl.bilstm_recurrence_packed(pack, *xp), want)
    approx_lib = fl._kernel_lib()
    exact_lib = fl.load_forward_library(EXACT_ACTIVATIONS)
    act_runs = {"approx": [], "exact": []}
    try:
        for label in ("approx", "exact", "exact", "approx"):
            fl._lib = exact_lib if label == "exact" else approx_lib
            act_runs[label].append(median_ms(
                lambda: fl.bilstm_recurrence_packed(pack, *xp)))
        fl._lib = exact_lib
        exact_err = _max_err(fl.bilstm_recurrence_packed(pack, *xp), want)
    finally:
        fl._lib = approx_lib
    exact_ms = min(act_runs["exact"])
    check(exact_err <= tol[torch.bfloat16], f"K1 built with exact "
          f"activations disagrees with its plain version: {exact_err}")
    del want
    print(f"K1 activations B={B} T={T} H={H} bf16 (median of 10, timed "
          f"approx, exact, exact, approx): tanh.approx {act_runs['approx']} "
          f"ms, max_abs_err {approx_err:.3e}; tanhf/expf "
          f"{act_runs['exact']} ms, max_abs_err {exact_err:.3e}", flush=True)
    plain_ms = median_ms(
        lambda: fl.bilstm_recurrence_plain(*raw, *_layer_args(p)), reps=3,
        warmup=1)
    lstm = torch.nn.LSTM(26, H, batch_first=True, bidirectional=True).to(
        dev, torch.bfloat16)
    lstm.flatten_parameters()
    with torch.inference_mode():
        library_ms = median_ms(lambda: lstm(x))
    # f32 at the runner's batch: select_kernel's choice (the generic
    # kernel above 640 rows) beside the FMA cluster kernel
    p32, x32, pack32, xp32, _ = timed[torch.float32]
    f32_name = pack32.name
    f32_ms = median_ms(lambda: fl.bilstm_recurrence_packed(pack32, *xp32),
                       reps=3, warmup=1)
    del xp32
    fma32 = fl.packed_layer(p32, "cluster_fma")
    fma_xp32 = fl.packed_projections(fma32, x32)
    f32_fma_ms = median_ms(
        lambda: fl.bilstm_recurrence_packed(fma32, *fma_xp32), reps=3,
        warmup=1)
    del fma_xp32
    bound_ms, bound_by = k1_bound_ms(B, T, 2, PEAK_BF16)
    f32_bound_ms, _ = k1_bound_ms(B, T, 4, PEAK_FP32)
    print(f"K1 timing B={B} T={T} H={H} bf16 (median of 10, CUDA events; "
          f"kernels timed generic, cluster_mma, cluster_mma, generic, the "
          f"smaller median of each): kernel_ms {kernel_ms:.3f} "
          f"(cluster_mma; {runs['cluster_mma']}) generic_kernel_ms "
          f"{old_ms:.3f} ({runs['generic']}) plain_ms {plain_ms:.3f} "
          f"bound_ms {bound_ms:.3f} ({bound_by}) library_ms "
          f"{library_ms:.3f} (nn.LSTM bf16, cuDNN, incl. its input "
          f"projection); f32 (median of 3): {f32_name} (selected) "
          f"{f32_ms:.3f} ms, cluster_fma {f32_fma_ms:.3f} ms, bound at the "
          f"FP32 peak {f32_bound_ms:.3f} ms", flush=True)
    return {"name": "K1 fused_bilstm", "route": "cuda",
            "source": "pepper_tpu_torch/csrc/fused_lstm.cu",
            "replaces": "pepper_tpu/ops/fused_lstm.py:27",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "kernel": "cluster_mma", "generic_kernel_ms": old_ms,
            "exact_activations_ms": exact_ms,
            "exact_activations_max_abs_err": exact_err,
            "kernel_f32": f32_name, "ms_f32": f32_ms,
            "cluster_fma_ms_f32": f32_fma_ms}


# --------------------------------------------------------------- phase 3
def k2_bound_ms(B: int, T: int, elem: int, peak_ops: float, H: int = PH):
    """(bound ms, bound_by): xp (both directions), W_hh^T and h0 read once,
    out and the final h written once, b_hh (f32) read once;
    2*2*T*B*H*3H operations."""
    nbytes = ((2 * B * T * 3 * H + B * T * 2 * H + 2 * H * 3 * H
               + 2 * 2 * B * H) * elem + 2 * 3 * H * 4)
    ops = 2 * 2 * T * B * H * 3 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_k2(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.polish_model import numpy_polish_params
    from pepper_tpu_torch.ops import fused_gru as fg

    rng = np.random.default_rng(41)
    tree = numpy_polish_params(42)
    small = numpy_polish_params(43, hidden=64)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    timed = {}
    # the consensus batch and a ragged one through both layers (each layer
    # reads the previous one's output and final h), then one row, one step
    # at hidden 64
    cases = [("polish", POLISH_BATCH, WINDOW, tree),
             ("ragged", 37, WINDOW, tree), ("one_row_one_step", 1, 1, small)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, T, t in cases:
            params = params_from_jax(t, dev, dtype)
            hidden = params["gru_encoder"]["weight_hh_l0"].shape[1]
            x = torch.from_numpy(polish_images(rng, B)[:, :T]).to(
                dev).to(dtype)
            h = torch.from_numpy(0.5 * rng.standard_normal(
                (B, 2, hidden)).astype(np.float32)).to(dev, dtype)
            for layer in ("gru_encoder", "gru_decoder"):
                p = params[layer]
                name = fg.select_kernel(B, T, hidden, dtype)
                pack = fg.packed_layer(p, name)
                xp = fg.input_projections(p, x)
                got = fg.bigru_recurrence_packed(pack, *xp, h)
                again = fg.bigru_recurrence_packed(pack, *xp, h)
                torch.cuda.synchronize()
                want = fg.bigru_recurrence_plain(
                    *xp, p["weight_hh_l0"].t(), p["weight_hh_l0_reverse"].t(),
                    p["bias_hh_l0"], p["bias_hh_l0_reverse"], h[:, 0],
                    h[:, 1])
                errs = [_max_err(g, w) for g, w in zip(got, want)]
                tag = (f"{label} B={B} T={T} H={hidden} {layer} (F="
                       f"{x.shape[-1]}, nonzero h0) {str(dtype)[6:]}")
                check(all(bool(torch.isfinite(g.float()).all())
                          for g in got), f"K2 non-finite output ({tag})")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K2 is not bit-identical across two calls ({tag})")
                print(f"K2 {name} {tag}: max_abs_err out {errs[0]:.3e} "
                      f"h_final {errs[1]:.3e} (tolerance {tol[dtype]:g}); "
                      f"two calls bit-identical", flush=True)
                check(max(errs) <= tol[dtype], f"K2 disagrees with its "
                      f"plain version: {errs} > {tol[dtype]} ({tag})")
                worst[dtype] = max(worst[dtype], *errs)
                if label == "polish" and layer == "gru_encoder":
                    timed[dtype] = (p, xp, h, want)
                # the next layer reads this layer's output and final h
                x, h = want
    p, xp, h, want = timed[torch.bfloat16]
    mma, generic = fg.packed_layer(p, "mma"), fg.packed_layer(p, "generic")
    runs = {"mma": [], "generic": []}
    for name, pk in (("generic", generic), ("mma", mma), ("mma", mma),
                     ("generic", generic)):
        runs[name].append(median_ms(
            lambda: fg.bigru_recurrence_packed(pk, *xp, h)))
    kernel_ms, old_ms = min(runs["mma"]), min(runs["generic"])
    plain_args = (*xp, p["weight_hh_l0"].t(), p["weight_hh_l0_reverse"].t(),
                  p["bias_hh_l0"], p["bias_hh_l0_reverse"], h[:, 0], h[:, 1])
    plain_ms = median_ms(lambda: fg.bigru_recurrence_plain(*plain_args))
    # what tanh.approx buys: the same kernel built with tanhf/expf, timed
    # approx, exact, exact, approx, and both held to the plain version
    approx_err = max(_max_err(g, w) for g, w in zip(
        fg.bigru_recurrence_packed(mma, *xp, h), want))
    approx_lib = fg._kernel_lib()
    exact_lib = fg.load_kernel_library(EXACT_ACTIVATIONS)
    act_runs = {"approx": [], "exact": []}
    try:
        for label in ("approx", "exact", "exact", "approx"):
            fg._lib = exact_lib if label == "exact" else approx_lib
            act_runs[label].append(median_ms(
                lambda: fg.bigru_recurrence_packed(mma, *xp, h)))
        fg._lib = exact_lib
        exact_err = max(_max_err(g, w) for g, w in zip(
            fg.bigru_recurrence_packed(mma, *xp, h), want))
    finally:
        fg._lib = approx_lib
    exact_ms = min(act_runs["exact"])
    check(exact_err <= tol[torch.bfloat16], f"K2 built with exact "
          f"activations disagrees with its plain version: {exact_err}")
    print(f"K2 activations B={POLISH_BATCH} T={WINDOW} H={PH} bf16 (median "
          f"of 10, timed approx, exact, exact, approx): tanh.approx "
          f"{act_runs['approx']} ms, max_abs_err {approx_err:.3e}; "
          f"tanhf/expf {act_runs['exact']} ms, max_abs_err "
          f"{exact_err:.3e}", flush=True)
    p32, xp32, h32, _ = timed[torch.float32]
    pack32 = fg.packed_layer(p32, fg.select_kernel(POLISH_BATCH, WINDOW, PH,
                                                   torch.float32))
    f32_ms = median_ms(lambda: fg.bigru_recurrence_packed(pack32, *xp32, h32))
    # device time alone (CUDA events also count the wrapper's host time
    # before the launch): mma, and the generic kernel in bf16 and in f32
    device = {
        label: sum(ms for name, (ms, _) in per_launch_ms(
            lambda: fg.bigru_recurrence_packed(pk, *xs, h0)).items()
            if "bigru" in name)
        for label, pk, xs, h0 in (("mma", mma, xp, h),
                                  ("generic_bf16", generic, xp, h),
                                  ("generic_f32", pack32, xp32, h32))}
    print(f"K2 device time B={POLISH_BATCH} T={WINDOW} H={PH} "
          f"(torch.profiler, mean per recorded launch of 5 calls): mma "
          f"{device['mma']:.4f} ms; generic "
          f"bf16 {device['generic_bf16']:.4f} ms, f32 "
          f"{device['generic_f32']:.4f} ms", flush=True)
    host = host_us(lambda: fg.bigru_recurrence_packed(mma, *xp, h))
    library = {}
    for F in (10, 2 * PH):
        gru = torch.nn.GRU(F, PH, batch_first=True, bidirectional=True).to(
            dev, torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(POLISH_BATCH, WINDOW, F, device=dev,
                        dtype=torch.bfloat16)
        h0 = torch.randn(2, POLISH_BATCH, PH, device=dev,
                         dtype=torch.bfloat16)    # nn.GRU's [2,B,H] layout
        with torch.inference_mode():
            library[F] = median_ms(lambda: gru(x, h0))
    bound_ms, bound_by = k2_bound_ms(POLISH_BATCH, WINDOW, 2, PEAK_BF16)
    f32_bound_ms, f32_bound_by = k2_bound_ms(POLISH_BATCH, WINDOW, 4,
                                             PEAK_FP32)
    print(f"K2 timing B={POLISH_BATCH} T={WINDOW} H={PH} bf16 (median of 10,"
          f" CUDA events; kernels timed generic, mma, mma, generic, the "
          f"smaller median of each): kernel_ms {kernel_ms:.4f} (mma, 16-row "
          f"tiles, {2 * -(-POLISH_BATCH // 16)} CTAs; {runs['mma']}) "
          f"generic_kernel_ms {old_ms:.4f} (4-row tiles, "
          f"{2 * -(-POLISH_BATCH // 4)} CTAs; {runs['generic']}) plain_ms "
          f"{plain_ms:.3f} bound_ms {bound_ms:.4f} ({bound_by}) library_ms "
          f"{library[10]:.4f} (nn.GRU(10, {PH}) bf16, cuDNN, h0 given, incl. "
          f"its input projection), {library[2 * PH]:.4f} for nn.GRU("
          f"{2 * PH}, {PH}); f32 kernel_ms {f32_ms:.4f} ({pack32.name}) "
          f"bound_ms {f32_bound_ms:.4f} ({f32_bound_by}, FP32 peak); host "
          f"{host:.1f} us per launch (wrapper, mean of 200 enqueued back to "
          f"back)", flush=True)
    return {"name": "K2 fused_bigru", "route": "cuda",
            "source": "pepper_tpu_torch/csrc/fused_gru.cu",
            "replaces": "pepper_tpu/ops/fused_gru.py:26",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library[10],
            "kernel": "mma", "generic_kernel_ms": old_ms,
            "exact_activations_ms": exact_ms,
            "exact_activations_max_abs_err": exact_err,
            "kernel_f32": pack32.name, "ms_f32": f32_ms,
            "device_ms": device["mma"],
            "generic_device_ms_bf16": device["generic_bf16"],
            "generic_device_ms_f32": device["generic_f32"],
            "host_us_per_launch": host}


# --------------------------------------------------------------- phase 4
def phase_model(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.variant_model import (numpy_variant_params,
                                                       variant_forward)

    tree = numpy_variant_params(21)
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


# --------------------------------------------------------------- phase 5
def vote_margins(votes: torch.Tensor) -> torch.Tensor:
    """Top-two vote margin per position of f32 votes [..., 5]."""
    top2 = votes.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_polish_model(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.polish_model import (numpy_polish_params,
                                                      polish_forward)
    from pepper_tpu_torch.polish.consensus import (make_window_vote_fn,
                                                   window_votes)

    tree = numpy_polish_params(51)
    rng = np.random.default_rng(52)
    x8 = torch.from_numpy(polish_images(rng, POLISH_BATCH))
    h0 = torch.from_numpy(0.5 * rng.standard_normal(
        (POLISH_BATCH, 2, PH)).astype(np.float32))
    cpu_params = params_from_jax(tree)
    with torch.inference_mode():
        want_logits, want_h = polish_forward(
            cpu_params, x8[:, :WINDOW].float(), h0, fused_rnn=True)
        solid = vote_margins(window_votes(cpu_params, x8.float())) > 1e-4
    want_labels, want_phred = make_window_vote_fn(
        tree, torch.device("cpu"), torch.float32)(x8)
    errs, n_diff, n_diff_solid = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.inference_mode():
            logits, hid = polish_forward(
                params_from_jax(tree, dev, dtype),
                x8[:, :WINDOW].to(dev).to(dtype), h0.to(dev, dtype),
                fused_rnn=True)
        labels, phred = make_window_vote_fn(tree, dev, dtype)(x8.to(dev))
        labels, phred = labels.cpu(), phred.cpu()
        check(logits.shape == want_logits.shape
              and labels.shape == (POLISH_BATCH, 1000)
              and bool(torch.isfinite(logits.float()).all())
              and bool(torch.isfinite(phred).all()),
              f"polish model output malformed ({dtype})")
        errs[dtype] = ((logits.float().cpu() - want_logits).abs().max().item(),
                       (hid.float().cpu() - want_h).abs().max().item())
        diff = labels != want_labels
        n_diff[dtype] = int(diff.sum())
        n_diff_solid[dtype] = int((diff & solid).sum())
    bf, f32 = torch.bfloat16, torch.float32
    print(f"polish model: full-width polish_forward (one window, nonzero "
          f"h0) and the 19-window vote on the card vs the plain CPU f32 "
          f"versions, {POLISH_BATCH} sequences: max_abs_err logits/hidden "
          f"bf16 {errs[bf][0]:.3e}/{errs[bf][1]:.3e}, f32 "
          f"{errs[f32][0]:.3e}/{errs[f32][1]:.3e} (f32 tolerance 1e-3); "
          f"base labels differing from cpu f32: bf16 {n_diff[bf]}, f32 "
          f"{n_diff[f32]} of {POLISH_BATCH * 1000}, of which at a cpu "
          f"top-two vote margin above 1e-4: bf16 {n_diff_solid[bf]}, f32 "
          f"{n_diff_solid[f32]} (must be 0); positions at a margin under "
          f"1e-4: {int((~solid).sum())}", flush=True)
    check(max(errs[f32]) <= 1e-3, "f32 polish model disagrees")
    check(n_diff_solid[f32] == 0, "f32 consensus labels disagree where "
          "the cpu vote margin exceeds 1e-4")


# --------------------------------------------------------------- phase 6
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
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
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
    save_checkpoint(model, numpy_variant_params(34), {"epochs": 0})
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
        groups = {"K1": 0.0, "elementwise": 0.0, "other (GEMMs, softmax, "
                  "copies)": 0.0}
        for k, ms in per_kernel.items():
            if "bilstm" in k:
                groups["K1"] += ms
            elif "elementwise" in k:
                groups["elementwise"] += ms
            else:
                groups["other (GEMMs, softmax, copies)"] += ms
        widest = max((ms for k, ms in per_kernel.items()
                      if "elementwise" in k), default=0.0)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile of one {runner.batch}-row forward (torch.profiler, "
              f"mean of 3): device busy {total:.2f} ms; " + "; ".join(
                  f"{k} {ms:.2f} ms ({100 * ms / total:.0f}%)"
                  for k, ms in groups.items()) + f"; the elementwise kernel "
              f"with the most time {widest:.2f} ms (one pass over a "
              f"[{runner.batch}, 33, 1024] bf16 projection takes ~2.9 ms: "
              f"none is left); top kernels: " + "; ".join(
                  f"{name[:70]} {ms:.2f} ms ({100 * ms / total:.0f}%)"
                  for name, ms in top), flush=True)
        # the bias adds run inside K1: no elementwise kernel between the
        # input projections and the recurrence
        check(groups["elementwise"] < 2.0, "an elementwise pass over the "
              "input projections is back in the classifier forward: "
              f"{groups['elementwise']:.2f} ms of elementwise kernels")
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
    return launches, {"bam": bam, "fasta": fasta, "model": model,
                      "out": out_cuda, "wall": wall_cuda}


# --------------------------------------------------------------- phase 7
def _fasta_contigs(text: str) -> dict:
    contigs, name = {}, None
    for line in text.splitlines():
        if line.startswith(">"):
            name = line[1:]
            contigs[name] = ""
        else:
            contigs[name] += line
    return contigs


def recorded_polish(run, device):
    """run() (a streamed polish on `device`, by API or CLI) with the
    consensus runner's device batches and the stitcher's sequences
    recorded: (run()'s result, the number of device batches, {sequence key:
    (positions, indices, base labels, image)}) for the sequences in flush
    order (batch by batch, the real rows of each; every batch but the last
    is full)."""
    from pepper_tpu_torch.polish import consensus, stitch

    batches, seqs = [], []
    real_submit = consensus.ConsensusRunner.submit
    real_add = stitch.StreamingStitcher.add

    def counted_submit(self, images):
        out = real_submit(self, images)
        batches.append((images, out))
        return out

    def recorded_add(self, contig, start, end, chunk_id, position, index,
                     bases):
        seqs.append(((contig, start, end, chunk_id), np.asarray(position),
                     np.asarray(index), np.asarray(bases)))
        return real_add(self, contig, start, end, chunk_id, position, index,
                        bases)

    consensus.ConsensusRunner.submit = counted_submit
    stitch.StreamingStitcher.add = recorded_add
    try:
        result = run()
    finally:
        consensus.ConsensusRunner.submit = real_submit
        stitch.StreamingStitcher.add = real_add
    recs = {}
    for k, (key, pos, idx, bases) in enumerate(seqs):
        images, labels = batches[k // POLISH_BATCH]
        if device == "cpu":   # its labels are on the host already
            check(np.array_equal(labels[k % POLISH_BATCH], bases),
                  "polish sequences and device batches do not line up")
        recs[key] = (pos, idx, bases, images[k % POLISH_BATCH])
    return result, len(batches), recs


def polish_label_diffs(rec, rec_cpu, cpu_params=None):
    """Differing base labels of a recorded polish against the cpu f32 one
    at the columns that reach the FASTA: (contig, position, insert index,
    the cpu top-two vote margin there, or NaN without `cpu_params`)."""
    from pepper_tpu_torch.polish import consensus

    check(rec.keys() == rec_cpu.keys(), "the runs polished different "
          "sequences")
    out = []
    for key, (pos, idx, bases, image) in rec_cpu.items():
        cols = np.nonzero((rec[key][2] != bases) & (pos >= 0)
                          & (idx >= 0))[0]
        if not cols.size:
            continue
        margin = np.full(len(bases), np.nan)
        if cpu_params is not None:
            with torch.inference_mode():
                margin = vote_margins(consensus.window_votes(
                    cpu_params, torch.from_numpy(image[None]).float())
                )[0].numpy()
        out += [(key[0], int(pos[c]), int(idx[c]), float(margin[c]))
                for c in cols]
    return out


def phase_polish_end_to_end(dev, work_dir, name):
    from pepper_tpu_torch.models.checkpoint import (params_from_jax,
                                                    save_checkpoint)
    from pepper_tpu_torch.models.polish_model import numpy_polish_params
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.polish import consensus
    from pepper_tpu_torch.polish.pipeline import polish
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads_fast,
                                              write_dataset)

    contig_len, n_contigs = 50_000, 2
    draft_len = contig_len * n_contigs
    t0 = time.time()
    genome = random_genome(contig_len, seed=61, n_contigs=n_contigs)
    edits = plant_variants(dict(genome), 14, 3, 3, seed=62)
    edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in edits]
    draft, bam = write_dataset(work_dir, genome, simulate_reads_fast(
        genome, edits, coverage=30, read_length=10_000, error_rate=0.02,
        seed=63))
    tree = numpy_polish_params(64)
    model = os.path.join(work_dir, "polish_model.npz")
    save_checkpoint(model, tree, {"epochs": 0})
    print(f"polish dataset: {n_contigs} contigs x {contig_len} bp draft, "
          f"{len(edits)} planted hom-alt corrections, 10 kb reads at "
          f"coverage 30 "
          f"[{time.time() - t0:.1f}s]", flush=True)

    def run(label, device, precision):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        fasta, n_batches, recs = recorded_polish(lambda: polish(
            bam, draft, model, os.path.join(work_dir, label), threads=4,
            batch_size=POLISH_BATCH, realignment=True, device=device),
            device)
        wall = time.time() - t
        with open(fasta) as fh:
            text = fh.read()
        return text, wall, n_batches, recs

    try:
        fg.launches = 0                       # count the main path only
        text_bf16, wall_bf16, n_batches, rec_bf16 = run("cuda_bf16", "cuda",
                                                        "bf16")
        launches = fg.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(n_batches > 0 and launches == 38 * n_batches,
              f"the streamed polish on the card launched K2 {launches} "
              f"times for {n_batches} device batches (expected 38 each)")
        text_cpu, wall_cpu, _, rec_cpu = run("cpu_f32", "cpu", "f32")
        text_f32, wall_f32, _, rec_f32 = run("cuda_f32", "cuda", "f32")
    finally:
        os.environ.pop("PEPPER_TPU_PRECISION", None)

    # one 128-sequence batch on the card (bf16), its device time by kernel
    runner = consensus.ConsensusRunner(tree, "cuda")
    batch = torch.from_numpy(consensus.pad_consensus_batch(
        [rec[3] for rec in list(rec_bf16.values())[:POLISH_BATCH]],
        POLISH_BATCH)).to(dev)
    batch_ms = median_ms(lambda: runner.forward(batch), reps=10)
    per_kernel = device_breakdown(lambda: runner.forward(batch))

    cpu_params = params_from_jax(tree)
    diff_f32 = polish_label_diffs(rec_f32, rec_cpu, cpu_params)
    diff_bf16 = polish_label_diffs(rec_bf16, rec_cpu)
    mbp = draft_len / 1e6
    print(f"e2e streamed polish on {name}: {len(rec_cpu)} sequences in "
          f"{n_batches} device batches of {POLISH_BATCH}; cuda bf16 wall "
          f"{wall_bf16:.2f}s ({mbp / wall_bf16:.4f} Mbp/s), K2 launches "
          f"{launches}, peak CUDA memory {peak_gb:.2f} GB, device time of "
          f"one {POLISH_BATCH}-sequence batch {batch_ms:.2f} ms (CUDA "
          f"events, median of 10); cuda f32 wall {wall_f32:.2f}s "
          f"({mbp / wall_f32:.4f} Mbp/s); cpu f32 wall {wall_cpu:.2f}s "
          f"({mbp / wall_cpu:.4f} Mbp/s)", flush=True)
    total = sum(per_kernel.values())
    if total:
        k2_ms = sum(ms for k, ms in per_kernel.items() if "bigru" in k)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile of one {POLISH_BATCH}-sequence consensus batch "
              f"(torch.profiler, mean of 3): device busy {total:.2f} ms of "
              f"{batch_ms:.2f} ms ({100 * (1 - total / batch_ms):.0f}% "
              f"idle); K2 {k2_ms:.2f} ms ({100 * k2_ms / total:.0f}% of "
              f"busy); " + "; ".join(
                  f"{k[:70]} {ms:.2f} ms ({100 * ms / total:.0f}%)"
                  for k, ms in top), flush=True)
    else:
        print("profile: torch.profiler recorded no device time (device "
              "breakdown not measured)", flush=True)
    contigs = {label: _fasta_contigs(text) for label, text in
               (("cpu f32", text_cpu), ("cuda f32", text_f32),
                ("cuda bf16", text_bf16))}
    for label, seqs_by_contig in contigs.items():
        check(sorted(seqs_by_contig) == [g[0] for g in genome]
              and all(seqs_by_contig.values()),
              f"{label} polished FASTA misses a contig: "
              f"{ {k: len(v) for k, v in seqs_by_contig.items()} }")
    low = [d for d in diff_f32 if d[3] < 1e-4]
    print(f"e2e polished consensus vs cpu f32: cuda f32 differs at "
          f"{len(diff_f32)} bases, all at a cpu vote margin under 1e-4: "
          f"{len(low) == len(diff_f32)} {diff_f32[:20]}; FASTA identical: "
          f"{text_f32 == text_cpu}; cuda bf16 differs at {len(diff_bf16)} "
          f"bases (FASTA identical: {text_bf16 == text_cpu}); polished "
          f"lengths {[len(v) for v in contigs['cpu f32'].values()]}",
          flush=True)
    check(len(low) == len(diff_f32), "cuda f32 consensus differs from cpu "
          "f32 where the cpu vote margin exceeds 1e-4")
    check(diff_f32 or text_f32 == text_cpu, "cuda f32 and cpu f32 polished "
          "FASTAs differ although every base label agrees")
    return launches, {"bam": bam, "draft": draft, "model": model}


# --------------------------------------------------------------- phase 8
def k3_bound_ms(B: int, T: int, elem: int, peak_ops: float):
    """(bound ms, bound_by): xp (both directions) and W_hh^T read once; out,
    the f32 gates and the f32 cell states written once; 2*2*T*B*H*4H
    operations."""
    nbytes = ((2 * B * T * 4 * H + 2 * H * 4 * H + B * T * 2 * H) * elem
              + (2 * B * T * 4 * H + 2 * B * T * H) * 4)
    ops = 2 * 2 * T * B * H * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k4_bound_ms(B: int, T: int, elem: int, hidden: int = H):
    """(bound ms, bound_by): gout and out (h_prev) read once in the layer's
    dtype; gates, cs and W_hh read once and dxp and dW_hh written once in
    f32; two products (dgates @ W_hh and h_prev^T @ dgates) of
    2*2*T*B*H*4H operations each, in f32."""
    Hd = hidden
    nbytes = (2 * B * T * 2 * Hd * elem
              + (2 * 2 * B * T * 4 * Hd + 2 * B * T * Hd
                 + 2 * 2 * 4 * Hd * Hd) * 4)
    ops = 2 * 2 * 2 * T * B * Hd * 4 * Hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k4_parts_ms(fn) -> dict:
    """K4's device time per call split into its recurrence and its dW_hh
    kernels (the chunk sum included; each kernel launches once a call),
    and the fewest launches the trace recorded of any of them."""
    parts = {"recurrence": 0.0, "dW_hh": 0.0, "recorded": 5}
    for name, (ms, n) in per_launch_ms(fn).items():
        if "bilstm_bwd" in name:
            parts["recurrence"] += ms
        elif "dwhh" in name or "sum_chunks" in name:
            parts["dW_hh"] += ms
        else:
            continue
        parts["recorded"] = min(parts["recorded"], n)
    return parts


def k3_host_us(pack, xp) -> dict:
    """Host microseconds per K3 launch: the Python wrapper, and the
    library's C function alone (attribute and occupancy look-up, launch)."""
    from pepper_tpu_torch.ops import fused_lstm as fl

    B, T, G = xp[0].shape
    out, gates, cs = fl.bilstm_train_forward_packed(pack, *xp)
    lib = fl._train_kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    args = (fl.KERNEL_CODES[pack.name], xp[0].data_ptr(), xp[1].data_ptr(),
            pack.w_hh[0].data_ptr(), pack.w_hh[1].data_ptr(),
            pack.bias.data_ptr(), out.data_ptr(), gates.data_ptr(),
            cs.data_ptr(), B, T, G // 4, 0, stream)

    def c_call():
        check(lib.pepper_bilstm_train_forward(*args) == 0,
              "K3's C function failed")

    return {"wrapper": host_us(
                lambda: fl.bilstm_train_forward_packed(pack, *xp)),
            "c_call": host_us(c_call)}


def k4_host_us(pack, gout, gates, cs, out) -> dict:
    """Host microseconds per K4 launch (the selected pair): the Python
    wrapper, and the library's C function alone (both kernels' launches,
    the shared-memory and occupancy look-ups)."""
    from pepper_tpu_torch.ops import fused_lstm as fl

    B, T, H2 = gout.shape
    code = fl.BACKWARD_CODES[fl.select_backward_kernel(B, T, H2 // 2,
                                                       out.dtype)]
    lib = fl._train_kernel_lib()
    dxp, dwhh = fl.bilstm_train_backward_kernel(pack, gout, gates, cs, out)
    scratch = torch.empty(
        (lib.pepper_bilstm_train_backward_scratch(code, B, T, H2 // 2),),
        device=out.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (code, gout.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            out.data_ptr(), pack.w_hh[0].data_ptr(), pack.w_hh[1].data_ptr(),
            dxp.data_ptr(), dwhh.data_ptr(), scratch.data_ptr(), B, T,
            H2 // 2, 0, stream)

    def c_call():
        check(lib.pepper_bilstm_train_backward(*args) == 0,
              "K4's C function failed")

    return {"wrapper": host_us(lambda: fl.bilstm_train_backward_kernel(
                pack, gout, gates, cs, out)),
            "c_call": host_us(c_call)}


def phase_train_kernels(dev):
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.rnn import lstm as plain_lstm
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_lstm as fl

    rng = np.random.default_rng(71)
    tree = numpy_variant_params(72)
    hp_tree = numpy_variant_params(73, image_features=48, window=21)
    narrow = {Hs: numpy_variant_params(74 + Hs, window=9, hidden=Hs)
              for Hs in (128, 32)}
    f32, bf16 = torch.float32, torch.bfloat16
    fwd_tol = {bf16: 2e-2, f32: 1e-4}
    worst = {"k3": {bf16: 0.0, f32: 0.0}, "k4": 0.0, "k4_dwhh": 0.0,
             "grads": 0.0}
    timed = {}
    # the trainer's batches, a ragged HP-window batch, and where the cluster
    # kernels' 16-row tiles can go wrong: one row past many tiles, fewer
    # rows than one tile, one step; the cluster kernels' other width and a
    # width only the generic kernels take
    cases = [("trainer", 512, 33, 26, tree), ("trainer", 64, 33, 26, tree),
             ("hp_ragged", 37, 21, 48, hp_tree),
             ("one_past_the_tiles", 513, 3, 26, tree),
             ("below_one_tile", 5, 33, 26, tree), ("one_step", 37, 1, 26, tree),
             ("hidden_128", 37, 9, 26, narrow[128]),
             ("hidden_32", 17, 9, 26, narrow[32])]
    for label, B, T, F, t in cases:
        x8 = images(rng, B, T, F)
        for dtype in (f32, bf16):
            params = params_from_jax(t, dev, dtype)
            x = torch.from_numpy(x8).to(dev, dtype)
            for layer in ("encoder", "decoder"):
                p = params[layer]
                hidden = p["weight_hh_l0"].shape[1]
                tag = (f"{label} B={B} T={T} H={hidden} {layer} (F="
                       f"{x.shape[-1]}) {str(dtype)[6:]}")
                w_f, w_b = p["weight_hh_l0"], p["weight_hh_l0_reverse"]
                name = fl.select_kernel(B, T, hidden, dtype, residuals=True)
                pack = fl.packed_layer(p, name)
                xp = fl.packed_projections(pack, x)
                got = fl.bilstm_train_forward_packed(pack, *xp)
                again = fl.bilstm_train_forward_packed(pack, *xp)
                torch.cuda.synchronize()
                raw = fl.raw_projections(p, x)
                want = fl.bilstm_train_forward_plain(*raw, *_layer_args(p))
                check(all(bool(torch.isfinite(g.float()).all())
                          for g in got), f"K3 non-finite output ({tag})")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K3 is not bit-identical across two calls ({tag})")
                errs = [_max_err(g, w) for g, w in zip(got, want)]
                print(f"K3 {name} {tag}: max_abs_err out {errs[0]:.3e} gates "
                      f"{errs[1]:.3e} cs {errs[2]:.3e} (tolerance "
                      f"{fwd_tol[dtype]:g}); two calls bit-identical",
                      flush=True)
                check(max(errs) <= fwd_tol[dtype], f"K3 disagrees with its "
                      f"plain version: {errs} ({tag})")
                worst["k3"][dtype] = max(worst["k3"][dtype], *errs)
                x_next = want[0]
                if dtype == bf16:      # K4 is held to its plain version in
                    x = x_next         # f32, the trainer's type
                    continue
                # K4 on the plain forward's residuals
                out, gates, cs = want
                gout = torch.from_numpy(rng.standard_normal(
                    (B, T, 2 * hidden)).astype(np.float32)).to(dev)
                pair = fl.select_backward_kernel(B, T, hidden, dtype)
                dxp, dwhh = fl.bilstm_train_backward_kernel(
                    pack, gout, gates, cs, out)
                again = fl.bilstm_train_backward_kernel(
                    pack, gout, gates, cs, out)
                torch.cuda.synchronize()
                want_dxp, want_dwhh = fl.bilstm_train_backward_plain(
                    gout, gates, cs, out, w_f, w_b)
                check(torch.equal(dxp, again[0])
                      and torch.equal(dwhh, again[1]),
                      f"K4 is not bit-identical across two calls ({tag})")
                e_dxp, e_dw = _max_err(dxp, want_dxp), _rel_err(dwhh,
                                                                 want_dwhh)
                print(f"K4 {pair} {tag}: max_abs_err dxp {e_dxp:.3e} "
                      f"(tolerance 1e-4), dW_hh {e_dw:.3e} of its largest "
                      f"entry {want_dwhh.abs().max().item():.3e} (tolerance "
                      f"1e-3); "
                      f"two calls bit-identical", flush=True)
                check(e_dxp <= 1e-4 and e_dw <= 1e-3,
                      f"K4 disagrees with its plain version ({tag})")
                worst["k4"] = max(worst["k4"], e_dxp)
                worst["k4_dwhh"] = max(worst["k4_dwhh"], e_dw)
                # through the autograd function: every gradient against
                # autograd through the plain step loop, on the card
                grads = {}
                for name, fn in (("kernel", fl.fused_bilstm_train),
                                 ("plain", plain_lstm)):
                    leaves = {k: v.clone().requires_grad_()
                              for k, v in p.items()}
                    xg = x.clone().requires_grad_()
                    (fn(leaves, xg) * gout).sum().backward()
                    grads[name] = {**{k: v.grad for k, v in leaves.items()},
                                   "x": xg.grad}
                torch.cuda.synchronize()
                rel = {k: _rel_err(grads["kernel"][k], grads["plain"][k])
                       for k in grads["plain"]}
                top = max(rel, key=rel.get)
                print(f"K3+K4 {tag} through the autograd function vs "
                      f"autograd through the plain step loop: 8 parameter "
                      f"gradients and dx, worst {top} {rel[top]:.3e} of its "
                      f"largest entry (tolerance 1e-3)", flush=True)
                check(rel[top] <= 1e-3, f"fused_bilstm_train gradients "
                      f"disagree: {rel} ({tag})")
                worst["grads"] = max(worst["grads"], rel[top])
                if label == "trainer" and layer == "encoder":
                    timed[B] = (p, x, pack, xp, raw, w_f, w_b, gout, gates,
                                cs, out)
                x = x_next

    rows = {}
    for B in (64, 512):
        p, x, pack, xp, raw, w_f, w_b, gout, gates, cs, out = timed[B]
        T = x.shape[1]
        lstm = torch.nn.LSTM(26, H, batch_first=True,
                             bidirectional=True).to(dev)
        lstm.flatten_parameters()
        lib_out = lstm(x)[0]
        # the generic kernel (the only K3 before the cluster kernel), on the
        # same raw projections in its own column order
        old_pack = fl.packed_layer(p, "generic")
        old_xp = fl.packed_projections(old_pack, x)
        runs = {"cluster_fma": [], "generic": []}
        for name, pk, xs in (("generic", old_pack, old_xp),
                             ("cluster_fma", pack, xp),
                             ("cluster_fma", pack, xp),
                             ("generic", old_pack, old_xp)):
            runs[name].append(median_ms(
                lambda: fl.bilstm_train_forward_packed(pk, *xs)))
        # K4's two pairs on the same residuals and pack, in turns
        res = (pack, gout, gates, cs, out)
        bwd = {"cluster_fma": [], "generic": []}
        for name in ("generic", "cluster_fma", "cluster_fma", "generic"):
            bwd[name].append(median_ms(
                lambda: fl.launch_backward(name, *res)))
        row = {
            "k3": min(runs["cluster_fma"]), "k3_generic": min(runs["generic"]),
            "k3_plain": median_ms(lambda: fl.bilstm_train_forward_plain(
                *raw, *_layer_args(p))),
            "k4": min(bwd["cluster_fma"]), "k4_generic": min(bwd["generic"]),
            "k4_parts": k4_parts_ms(
                lambda: fl.launch_backward("cluster_fma", *res)),
            "k4_generic_parts": k4_parts_ms(
                lambda: fl.launch_backward("generic", *res)),
            "k4_plain": median_ms(lambda: fl.bilstm_train_backward_plain(
                gout, gates, cs, out, w_f, w_b)),
            "lib_fwd": median_ms(lambda: lstm(x)),
            "lib_bwd": median_ms(lambda: lib_out.backward(
                gout, retain_graph=True)),
        }
        row["k3_bound"], row["k3_by"] = k3_bound_ms(B, T, 4, PEAK_FP32)
        row["k4_bound"], row["k4_by"] = k4_bound_ms(B, T, 4)
        rows[B] = row
        print(f"K3 timing B={B} T={T} H={H} f32 (median of 10, CUDA "
              f"events; kernels timed generic, cluster_fma, cluster_fma, "
              f"generic, the smaller median of each): kernel_ms "
              f"{row['k3']:.4f} (cluster_fma; {runs['cluster_fma']}) "
              f"generic_kernel_ms {row['k3_generic']:.4f} "
              f"({runs['generic']}) plain_ms "
              f"{row['k3_plain']:.3f} bound_ms {row['k3_bound']:.4f} "
              f"({row['k3_by']}, FP32 peak) library_ms {row['lib_fwd']:.4f} "
              f"(nn.LSTM(26, {H}) f32 forward with grad enabled, cuDNN, "
              f"incl. its input projection)", flush=True)
        parts = row["k4_parts"]
        old_parts = row["k4_generic_parts"]
        print(f"K4 timing B={B} T={T} H={H} f32 (median of 10, CUDA "
              f"events; pairs timed generic, cluster_fma, cluster_fma, "
              f"generic, the smaller median of each; selected "
              f"{fl.select_backward_kernel(B, T, H, f32)}): kernel_ms "
              f"{row['k4']:.4f} (cluster_fma; {bwd['cluster_fma']}; by "
              f"kernel, torch.profiler mean per recorded launch, at least "
              f"{parts['recorded']} of 5 recorded: recurrence "
              f"{parts['recurrence']:.4f}, dW_hh {parts['dW_hh']:.4f}) "
              f"generic_kernel_ms {row['k4_generic']:.4f} ({bwd['generic']}; "
              f"recurrence {old_parts['recurrence']:.4f}, dW_hh "
              f"{old_parts['dW_hh']:.4f}) plain_ms {row['k4_plain']:.3f} "
              f"bound_ms {row['k4_bound']:.4f} ({row['k4_by']}, FP32 peak) "
              f"library_ms {row['lib_bwd']:.4f} (nn.LSTM(26, {H}) f32 "
              f"backward, cuDNN, incl. its input projection's gradients)",
              flush=True)
    # where select_kernel hands K3 (and K1 in f32) from the FMA cluster kernel
    # to the generic one, past its 640-row threshold; and K4's two pairs at
    # the same batches: select_backward_kernel has no threshold, since the
    # cluster pair measured faster at every batch
    p = timed[512][0]
    cross = {}
    for B in (1024, 2048, 4096):
        x = torch.from_numpy(images(rng, B)).to(dev, f32)
        forward = {}
        for name in ("generic", "cluster_fma"):
            pk = fl.packed_layer(p, name)
            xs = fl.packed_projections(pk, x)
            forward[name] = median_ms(
                lambda: fl.bilstm_train_forward_packed(pk, *xs), reps=5)
        out, gates, cs = fl.bilstm_train_forward_packed(pk, *xs)
        gout = torch.randn(B, 33, 2 * H, device=dev)
        backward = {name: median_ms(
            lambda: fl.launch_backward(name, pk, gout, gates, cs, out),
            reps=5) for name in ("generic", "cluster_fma")}
        cross[B] = {"k3": forward, "k4": backward}
        print(f"K3/K4 crossover B={B} T=33 H={H} f32 (median of 5): K3 "
              f"{fl.select_kernel(B, 33, H, f32, residuals=True)} selected, "
              f"generic {forward['generic']:.4f} ms, cluster_fma "
              f"{forward['cluster_fma']:.4f} ms; K4 "
              f"{fl.select_backward_kernel(B, 33, H, f32)} selected, generic "
              f"{backward['generic']:.4f} ms, cluster_fma "
              f"{backward['cluster_fma']:.4f} ms", flush=True)
    host = k3_host_us(timed[64][2], timed[64][3])
    host4 = k4_host_us(*(timed[64][i] for i in (2, 7, 8, 9, 10)))
    print(f"host time per launch B=64 T=33 H={H} f32 (mean of 200 launches "
          f"enqueued back to back): K3 wrapper {host['wrapper']:.1f} us, of "
          f"which the library's C function {host['c_call']:.1f} us (the "
          f"kernel runs {rows[64]['k3']:.4f} ms); K4 wrapper "
          f"{host4['wrapper']:.1f} us, of which the C function "
          f"{host4['c_call']:.1f} us (the pair runs {rows[64]['k4']:.4f} ms)",
          flush=True)
    main_b, big = rows[64], rows[512]
    k3 = {"name": "K3 fused_bilstm_train forward", "route": "cuda",
          "source": "pepper_tpu_torch/csrc/fused_lstm_train.cu",
          "replaces": "pepper_tpu/ops/fused_lstm.py:131",
          "max_abs_err": worst["k3"][f32],
          "max_abs_err_bf16": worst["k3"][bf16],
          "ms": main_b["k3"], "plain_ms": main_b["k3_plain"],
          "bound_ms": main_b["k3_bound"], "bound_by": main_b["k3_by"],
          "library_ms": main_b["lib_fwd"], "shape": "B=64 T=33 H=256 f32",
          "kernel": "cluster_fma", "generic_kernel_ms": main_b["k3_generic"],
          "host_us_per_launch": host["wrapper"],
          "host_us_per_c_call": host["c_call"],
          "generic_kernel_ms_b512": big["k3_generic"],
          "generic_kernel_ms_b1024": cross[1024]["k3"]["generic"],
          "cluster_fma_ms_b1024": cross[1024]["k3"]["cluster_fma"],
          "ms_b512": big["k3"], "plain_ms_b512": big["k3_plain"],
          "bound_ms_b512": big["k3_bound"], "library_ms_b512": big["lib_fwd"]}
    k4 = {"name": "K4 fused_bilstm_train backward", "route": "cuda",
          "source": "pepper_tpu_torch/csrc/fused_lstm_bwd_cluster.cuh",
          "replaces": "pepper_tpu/ops/fused_lstm.py:167",
          "max_abs_err": worst["k4"], "max_rel_err_dwhh": worst["k4_dwhh"],
          "max_rel_err_gradients": worst["grads"],
          "ms": main_b["k4"], "plain_ms": main_b["k4_plain"],
          "bound_ms": main_b["k4_bound"], "bound_by": main_b["k4_by"],
          "library_ms": main_b["lib_bwd"], "shape": "B=64 T=33 H=256 f32",
          "kernel": fl.select_backward_kernel(64, 33, H, f32),
          "recurrence_ms": main_b["k4_parts"]["recurrence"],
          "dwhh_ms": main_b["k4_parts"]["dW_hh"],
          "generic_kernel_ms": main_b["k4_generic"],
          "host_us_per_launch": host4["wrapper"],
          "host_us_per_c_call": host4["c_call"],
          "ms_b512": big["k4"], "plain_ms_b512": big["k4_plain"],
          "recurrence_ms_b512": big["k4_parts"]["recurrence"],
          "dwhh_ms_b512": big["k4_parts"]["dW_hh"],
          "generic_kernel_ms_b512": big["k4_generic"],
          "bound_ms_b512": big["k4_bound"], "library_ms_b512": big["lib_bwd"],
          "crossover_ms": {str(B): c["k4"] for B, c in cross.items()}}
    return k3, k4


# --------------------------------------------------------------- phase 9
TRAIN_BATCH = 64     # the trainer CLI's default batch size


def _one_step(tree, device, x8, y, lr, weight_decay):
    """One train step (dropout off) from the numpy tree on `device`:
    (loss, gradients, updated parameters), all on the host."""
    from pepper_tpu_torch.train import variant_train as vt

    params = vt.trainable(tree, device)
    optimizer = vt.make_optimizer(params, lr, weight_decay)
    loss = float(vt.make_train_step(params, optimizer)(x8, y))
    leaves = dict(vt.sorted_leaves(params))
    return (loss, {k: p.grad.cpu() for k, p in leaves.items()},
            {k: p.detach().cpu() for k, p in leaves.items()})


def phase_train_step(dev):
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_lstm as fl

    tree = numpy_variant_params(81)
    rng = np.random.default_rng(82)
    x8 = images(rng, TRAIN_BATCH)
    y = rng.integers(0, 3, TRAIN_BATCH)
    lr, wd = 1e-4, 1e-6
    before = (fl.train_fwd_launches, fl.train_bwd_launches)
    loss, grads, after = _one_step(tree, dev, x8, y, lr, wd)
    check((fl.train_fwd_launches - before[0], fl.train_bwd_launches
           - before[1]) == (2, 2), "a train step on the card must launch "
          "K3 and K4 twice each")
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        want_loss, want_grads, want_after = _one_step(tree, "cpu", x8, y, lr,
                                                      wd)
    finally:
        torch.set_num_threads(threads)
    check(np.isfinite(loss), "train-step loss is not finite")
    rel = {k: _rel_err(grads[k], want_grads[k]) for k in want_grads}
    top = max(rel, key=rel.get)
    # Adam's first update is lr * g / (|g| + eps): where |g| is near eps
    # the two devices may round g to either side of zero, so the updated
    # parameters are compared in units of lr
    moved = torch.cat([(after[k] - want_after[k]).abs().flatten()
                       for k in want_after]) / lr
    far = float((moved > 0.01).float().mean())
    print(f"train step: one full-width step at batch {TRAIN_BATCH} on the "
          f"card vs the same step on the CPU (f32, dropout off, Adam lr "
          f"{lr:g}, weight decay {wd:g}): loss {loss:.6f} vs {want_loss:.6f} "
          f"(tolerance 1e-4 relative); {len(rel)} gradients, worst {top} "
          f"{rel[top]:.3e} of its largest entry (tolerance 1e-3); updated "
          f"parameters differ by at most {float(moved.max()):.3e} lr "
          f"(tolerance 2 lr), {100 * far:.4f}% of {moved.numel()} by more "
          f"than 0.01 lr (tolerance 0.1%)", flush=True)
    check(abs(loss - want_loss) <= 1e-4 * abs(want_loss),
          "train-step loss disagrees with the CPU step")
    check(rel[top] <= 1e-3, f"train-step gradients disagree: {rel}")
    check(float(moved.max()) <= 2.0 and far <= 1e-3,
          "updated parameters disagree with the CPU step")


# -------------------------------------------------------------- phase 10
def encode_labeled(work_dir, fasta, bam, truth):
    """(int8 images [N,33,26], type labels [N]) of a dataset with a truth
    VCF: the native encoder in train mode, region by region, in memory (no
    HDF5 store)."""
    from pepper_tpu_torch.encode.region_encoder import CandidateBatch
    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.pipelines.make_images import (build_intervals,
                                                        create_region_summary)
    from pepper_tpu_torch.presets import set_parameters

    config = set_parameters(PipelineConfig(
        bam=bam, fasta=fasta, output_dir=work_dir,
        sub_command="make_train_images", ont_r9_guppy5_sup=True, threads=1,
        region_size=20_000, train_mode=True, truth_vcf=truth,
        random_draw_probability=1.0))
    xs, ys = [], []
    with BamReader(bam) as reader, FastaReader(fasta) as fa:
        for contig, start, end in build_intervals(config):
            cands = create_region_summary(config, reader, fa, contig, start,
                                          end)
            if not cands:
                continue
            if isinstance(cands, CandidateBatch):
                xs.append(np.asarray(cands.images))
                ys.append(np.asarray(cands.type_labels))
            else:
                xs.append(np.stack([np.asarray(c.image) for c in cands]))
                ys.append(np.array([c.type_label for c in cands]))
    check(bool(xs), "the train-mode encoder produced no labeled image")
    return (np.concatenate(xs).astype(np.int8),
            np.concatenate(ys).astype(np.int32))


def labeled_images(work_dir):
    """(int8 images [N,33,26], type labels [N], planted count) of a
    synthetic 60 kb dataset with a truth VCF (`encode_labeled`)."""
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads, write_dataset,
                                              write_truth_vcf)

    genome = random_genome(60_000, seed=91)
    variants = plant_variants(dict(genome), 500, 80, 80, seed=92)
    fasta, bam = write_dataset(work_dir, genome, simulate_reads(
        genome, variants, coverage=30, seed=93, error_rate=0.03))
    truth = write_truth_vcf(os.path.join(work_dir, "truth.vcf"), genome,
                            variants)
    return encode_labeled(work_dir, fasta, bam, truth) + (len(variants),)


def phase_trainer(dev, work_dir, name):
    from pepper_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    load_opt_state)
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.train import variant_train as vt
    from pepper_tpu_torch.train.dataloader import ShuffleBufferLoader

    t0 = time.time()
    x8, y, n_variants = labeled_images(work_dir)
    n = len(x8)
    check(x8.shape[1:] == (33, 26) and n >= 2 * TRAIN_BATCH,
          f"too few labeled images for the trainer: {x8.shape}")
    print(f"training dataset: 60000 bp, {n_variants} planted variants, "
          f"coverage 30, {n} labeled images {x8.shape[1:]} (labels "
          f"{np.bincount(y, minlength=3).tolist()}) "
          f"[{time.time() - t0:.1f}s]", flush=True)
    per_epoch = n // TRAIN_BATCH
    step_size = min(10, per_epoch)
    epochs = -(-20 // step_size)
    steps = epochs * step_size
    evals = steps // step_size
    eval_batches = -(-n // 512)
    test = {"images": x8, "type_label": y}

    def csv_losses(model_dir):
        path = glob.glob(os.path.join(model_dir, "stats_*",
                                      "train_loss.csv"))[0]
        with open(path) as fh:
            return [float(ln.split(",")[2]) for ln in fh]

    # the main path: the port's training loop on the card
    model_dir = os.path.join(work_dir, "models")
    torch.cuda.reset_peak_memory_stats()
    fl.launches = fl.train_fwd_launches = fl.train_bwd_launches = 0
    t = time.time()
    best = vt.train_loop(
        ShuffleBufferLoader.from_arrays(x8, y, TRAIN_BATCH), test, model_dir,
        epoch_limit=epochs, step_size=step_size, seed=7, device="cuda")
    wall = time.time() - t
    counts = (fl.launches, fl.train_fwd_launches, fl.train_bwd_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts[1] == 2 * steps and counts[2] == 2 * steps,
          f"{steps} train steps launched K3 {counts[1]} and K4 {counts[2]} "
          f"times (expected {2 * steps} each)")
    check(counts[0] == 2 * eval_batches * evals,
          f"{evals} evals of {eval_batches} batches launched K1 {counts[0]} "
          f"times (expected {2 * eval_batches * evals})")
    losses = csv_losses(model_dir)
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"expected {steps} finite losses, got {losses}")
    head, tail = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(tail < head, f"the loss did not fall: {losses}")
    params, meta = load_checkpoint(best)
    saved = load_opt_state(best)
    check(saved is not None and len(saved) == 3 + 2 * 28
          and meta["step"] <= steps, "the checkpoint lacks optimizer state")
    check(all(np.isfinite(v).all() for _, v in vt.sorted_leaves(params)),
          "the checkpoint holds non-finite parameters")

    # resume from the checkpoint with its optimizer state
    resumed_dir = os.path.join(work_dir, "resumed")
    resumed = vt.train_loop(
        ShuffleBufferLoader.from_arrays(x8, y, TRAIN_BATCH), test,
        resumed_dir, epoch_limit=1, step_size=3, seed=8, device="cuda",
        retrain_model_path=best)
    resumed_losses = csv_losses(resumed_dir)
    steps_after = int(load_opt_state(resumed)[2])
    check(steps_after == int(saved[2]) + 3, f"the resumed run's optimizer "
          f"count is {steps_after}, expected {int(saved[2]) + 3}")
    check(float(np.mean(resumed_losses)) < head, "the resumed run did not "
          f"start from the trained parameters: {resumed_losses}")

    # steady-state step time and its device time by kernel
    trained = vt.trainable(params, dev)
    optimizer = vt.make_optimizer(trained, 1e-4, 1e-6)
    step = vt.make_train_step(trained, optimizer)
    gen = torch.Generator(device=dev).manual_seed(9)
    bx, by = x8[:TRAIN_BATCH], y[:TRAIN_BATCH]
    step_ms = median_ms(lambda: step(bx, by, gen))
    per_kernel = device_breakdown(lambda: step(bx, by, gen))
    print(f"trainer on {name}: {steps} steps at batch {TRAIN_BATCH} with "
          f"{evals} evals ({n} images each) and checkpoints in {wall:.2f}s "
          f"wall; loss {head:.3f} (mean of the first 3 steps) -> {tail:.3f} "
          f"(last 3); K3 launches {counts[1]}, K4 launches {counts[2]} (2 "
          f"per step each), K1 launches {counts[0]} (evals); best accuracy "
          f"{meta['accuracy']:.2f}% at step {meta['step']}; resumed 3 steps "
          f"from the checkpoint: optimizer count {int(saved[2])} -> "
          f"{steps_after}, loss {np.mean(resumed_losses):.3f}; one train "
          f"step {step_ms:.3f} ms (CUDA events, median of 10, upload "
          f"included); peak CUDA memory {peak_gb:.2f} GB", flush=True)
    total = sum(per_kernel.values())
    if total:
        groups = {"K3": 0.0, "K4 recurrence": 0.0, "K4 dW_hh": 0.0}
        for k, ms in per_kernel.items():
            if "bilstm_bwd" in k:
                groups["K4 recurrence"] += ms
            elif "dwhh" in k or "sum_chunks" in k:
                groups["K4 dW_hh"] += ms
            elif "bilstm_cluster_fma_kernel" in k or "bilstm_kernel" in k:
                groups["K3"] += ms
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
        print(f"profile of one train step at batch {TRAIN_BATCH} "
              f"(torch.profiler, mean of 3): device busy {total:.3f} ms of "
              f"{step_ms:.3f} ms ({100 * (1 - total / step_ms):.0f}% idle); "
              + "; ".join(f"{k} {ms:.3f} ms ({100 * ms / total:.0f}%)"
                          for k, ms in groups.items()) + "; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in top),
              flush=True)
    else:
        print("profile: torch.profiler recorded no device time (device "
              "breakdown not measured)", flush=True)
    return counts


# -------------------------------------------------------------- phase 11
def _write_dv_vcf(path, records, contigs):
    """A DeepVariant-style VCF (AD with the ref depth first) at every other
    record of `records`."""
    lines = ["##fileformat=VCFv4.2"]
    lines += [f"##contig=<ID={c},length={n}>" for c, n in contigs]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tDV")
    for r in records[::2]:
        lines.append(f"{r.contig}\t{r.pos + 1}\t.\t{r.ref}\t"
                     f"{','.join(r.alts) or '.'}\t40\tPASS\t.\t"
                     f"GT:GQ:DP:AD:VAF\t0/1:30:30:15,15:0.5")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return {(r.contig, r.pos) for r in records[::2]}


def phase_hp_end_to_end(dev, work_dir, name):
    from pepper_tpu_torch.io.vcf import read_vcf
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.pipelines.call_variant import call_variant
    from pepper_tpu_torch.pipelines.merge_variants import merge_variants
    from pepper_tpu_torch.presets import set_parameters
    from pepper_tpu_torch.runtime import streaming
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads, write_dataset)

    genome_len = 60_000
    t0 = time.time()
    genome = random_genome(genome_len, seed=111)
    variants = plant_variants(dict(genome), 60, 12, 12, seed=112)
    fasta, bam = write_dataset(work_dir, genome, simulate_reads(
        genome, variants, coverage=30, seed=113, hp_tags=True))
    model = os.path.join(work_dir, "hp_model.npz")
    save_checkpoint(model, numpy_variant_params(114, image_features=48,
                                                window=21), {"epochs": 0})
    print(f"HP dataset: {genome_len} bp, {len(variants)} planted variants, "
          f"haplotype-tagged reads at coverage 30; classifier 21x48 -> "
          f"biLSTM {H} x2 -> 5x Linear 512 -> 3 [{time.time() - t0:.1f}s]",
          flush=True)

    def run(label, device, precision):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        out = os.path.join(work_dir, label) + "/"
        config = set_parameters(PipelineConfig(
            bam=bam, fasta=fasta, output_dir=out, model_path=model,
            ont_r9_guppy5_sup=True, threads=4, region_size=20000,
            use_hp_info=True, device=device))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        call_variant(config)
        return out, time.time() - t

    try:
        fl.launches = 0                       # count the main path only
        out_bf16, wall_bf16 = run("cuda_bf16", "cuda", "bf16")
        launches = fl.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches > 0, "the streamed HP run on the card never launched "
              "K1")
        runner = streaming.get_device_runner(model, 16384, "cuda")
        w_ih = runner._replicas[0]["encoder"]["weight_ih_l0"]
        check(tuple(w_ih.shape) == (4 * H, 48), f"the HP runner's first "
              f"W_ih is {tuple(w_ih.shape)}, expected ({4 * H}, 48)")
        x8 = torch.from_numpy(images(np.random.default_rng(115),
                                     runner.batch, 21, 48)).to(dev)
        forward_ms = median_ms(lambda: runner.forward(x8), reps=10)
        rec_bf16 = _call_records(out_bf16)
        out_cpu, wall_cpu = run("cpu_f32", "cpu", "f32")
        rec_cpu = _call_records(out_cpu)
        out_f32, wall_f32 = run("cuda_f32", "cuda", "f32")
        rec_f32 = _call_records(out_f32)
    finally:
        os.environ.pop("PEPPER_TPU_PRECISION", None)
    diff_bf16 = sorted(rec_bf16 ^ rec_cpu)
    diff_f32 = len(rec_f32 ^ rec_cpu)
    mbp = genome_len / 1e6
    print(f"e2e streamed call_variant --use_hp_info on {name}: cuda bf16 "
          f"wall {wall_bf16:.2f}s ({mbp / wall_bf16:.4f} Mbp/s), K1 launches "
          f"{launches}, device forward {forward_ms:.2f} ms per "
          f"{runner.batch}-row 21x48 batch (CUDA events, median of 10), "
          f"peak CUDA memory {peak_gb:.2f} GB; cuda f32 wall "
          f"{wall_f32:.2f}s; cpu f32 wall {wall_cpu:.2f}s", flush=True)
    print(f"HP VCF records (file, contig, pos, ref, alt, GT): cpu f32 "
          f"{len(rec_cpu)}, cuda bf16 {len(rec_bf16)} ({len(diff_bf16)} "
          f"differ from cpu f32: {diff_bf16[:10]}), cuda f32 {len(rec_f32)} "
          f"({diff_f32} differ)", flush=True)
    check(len(rec_cpu) > 0, "the HP CPU run called no variants")
    check(diff_f32 == 0, "HP: cuda f32 and cpu f32 call different records")

    # merge_variants: a DeepVariant VCF overlays the FULL VCF (every
    # candidate the random classifier called) positionally
    full = os.path.join(out_bf16, "PEPPER_VARIANT_FULL.vcf.gz")
    base = read_vcf(full)
    dv_path = os.path.join(work_dir, "deepvariant.vcf")
    dv_keys = _write_dv_vcf(dv_path, base, [(c, len(s)) for c, s in genome])
    merge_dir = os.path.join(work_dir, "merged")
    os.makedirs(merge_dir)
    merged_path = merge_variants(full, dv_path, None, None, merge_dir,
                                 "Sample")
    merged = read_vcf(merged_path)
    tags = [r.samples[0][r.format.index("C")] for r in merged]
    check(os.path.isfile(merged_path + ".tbi"), "merge_variants wrote no "
          ".tbi")
    check([(r.contig, r.pos) for r in merged]
          == [(r.contig, r.pos) for r in base]
          and tags == ["DV" if (r.contig, r.pos) in dv_keys else "P"
                       for r in base],
          "merge_variants did not overlay the DeepVariant records "
          "positionally")
    print(f"merge_variants: {len(merged)} records ({tags.count('DV')} C=DV "
          f"at the {len(dv_keys)} DeepVariant positions, {tags.count('P')} "
          f"C=P), indexed", flush=True)
    return launches, {"bam": bam, "fasta": fasta, "contig": genome[0][0],
                      "length": genome_len}


# -------------------------------------------------------------- phase 12
def polish_draft(work_dir, length, seeds, counts):
    """A synthetic one-contig draft of `length` bp whose reads carry the
    true sequence (the planted SNPs, insertions and deletions, `counts`, as
    hom-alt edits of the draft; 10 kb reads at coverage 30, 2% error) and a
    truth-to-draft BAM with one perfect read: a dict of the genome, the
    edits and the three paths (as tests/test_polish.py:103-144 builds it).
    `seeds`: the genome's, the edits' and the reads'."""
    from pepper_tpu_torch.io.bam_writer import BamWriter
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads_fast,
                                              write_dataset)

    genome = random_genome(length, seed=seeds[0])
    edits = plant_variants(dict(genome), *counts, seed=seeds[1])
    edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in edits]
    draft, bam = write_dataset(work_dir, genome, simulate_reads_fast(
        genome, edits, coverage=30, read_length=10_000, error_rate=0.02,
        seed=seeds[2]))
    truth_bam = os.path.join(work_dir, "truth.bam")
    with BamWriter(truth_bam, [(n, len(s)) for n, s in genome]) as bw:
        for rec in simulate_reads_fast(genome, edits, coverage=1,
                                       read_length=len(genome[0][1]),
                                       error_rate=0.0, seed=1, mapq=60):
            bw.write(rec)
    return {"genome": genome, "edits": edits, "draft": draft, "bam": bam,
            "truth_bam": truth_bam}


def polish_training_images(work_dir, data=None):
    """(uint8 images [N,1000,10], uint8 labels [N,1000], planted
    corrections) of a `polish_draft` (by default phase 12's 40 kb one):
    the polish encoder in train mode, interval by interval, in memory (no
    HDF5 store)."""
    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.polish.make_images import (build_polish_intervals,
                                                     create_polish_summary)

    if data is None:
        data = polish_draft(work_dir, 40_000, (121, 122, 123), (20, 8, 8))
    xs, ys = [], []
    with BamReader(data["bam"]) as reads, FastaReader(data["draft"]) as fa, \
            BamReader(data["truth_bam"]) as truth:
        for contig, start, end in build_polish_intervals(
                data["draft"], data["bam"], None):
            images_i, labels_i, _, _ = create_polish_summary(
                reads, fa, contig, start, end, train_mode=True,
                truth_bam=truth, realignment_flag=False)
            xs += images_i
            ys += labels_i
    check(bool(xs), "the train-mode polish encoder produced no image")
    return (np.asarray(xs).astype(np.uint8), np.asarray(ys).astype(np.uint8),
            len(data["edits"]))


def _polish_window_steps(tree, device, x, y, k, lr, wd):
    """k window steps of the polish trainer from the numpy tree on `device`
    over the first k windows of one batch, the hidden carried: (losses,
    updated parameters on the host)."""
    from pepper_tpu_torch.train import polish_train as pt
    from pepper_tpu_torch.train import variant_train as vt

    params = vt.trainable(tree, device)
    step = pt.make_polish_train_step(params, vt.make_optimizer(params, lr,
                                                               wd))
    xd = torch.from_numpy(x).to(device).float()
    yd = torch.from_numpy(y.astype(np.int64)).to(device)
    hidden = torch.zeros((len(x), 2, PH), device=device)
    losses = []
    for i in range(0, 50 * k, 50):
        hidden, loss = step(xd[:, i:i + WINDOW], yd[:, i:i + WINDOW], hidden)
        losses.append(float(loss))
    return losses, {k: p.detach().cpu() for k, p in vt.sorted_leaves(params)}


def phase_polish_trainer(dev, work_dir, name):
    from pepper_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    load_opt_state,
                                                    params_from_jax)
    from pepper_tpu_torch.models.polish_model import numpy_polish_params
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.train import polish_train as pt
    from pepper_tpu_torch.train import variant_train as vt

    t0 = time.time()
    x8, y8, n_edits = polish_training_images(work_dir)
    n = len(x8)
    check(x8.shape[1:] == (1000, 10) and n >= TRAIN_BATCH,
          f"too few labeled polish images: {x8.shape}")
    print(f"polish training dataset: 40000 bp draft, {n_edits} planted "
          f"corrections, 10 kb reads at coverage 30, a truth-to-draft BAM; "
          f"{n} labeled sequences (labels "
          f"{np.bincount(y8.ravel(), minlength=5).tolist()}) "
          f"[{time.time() - t0:.1f}s]", flush=True)
    tree = numpy_polish_params(124)
    lr, wd = 1e-3, 1e-6

    # k=3 window steps at the trainer's batch on the card against the CPU
    bx, by = x8[:TRAIN_BATCH], y8[:TRAIN_BATCH]
    losses, after = _polish_window_steps(tree, dev, bx, by, 3, lr, wd)
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        want_losses, want_after = _polish_window_steps(tree, "cpu", bx, by, 3,
                                                       lr, wd)
    finally:
        torch.set_num_threads(threads)
    moved = torch.cat([(after[k] - want_after[k]).abs().flatten()
                       for k in want_after]) / lr
    far = float((moved > 0.01).float().mean())
    print(f"polish train steps: 3 full-width window steps at batch "
          f"{TRAIN_BATCH} on the card vs the same steps on the CPU (f32, "
          f"Adam lr {lr:g}, weight decay {wd:g}): losses {losses} vs "
          f"{want_losses} (tolerance 1e-4 relative); updated parameters "
          f"differ by at most {float(moved.max()):.3e} lr (tolerance 2 lr), "
          f"{100 * far:.4f}% of {moved.numel()} by more than 0.01 lr "
          f"(tolerance 0.1%)", flush=True)
    check(np.allclose(losses, want_losses, rtol=1e-4, atol=0),
          "polish train-step losses disagree with the CPU steps")
    check(float(moved.max()) <= 2.0 and far <= 1e-3,
          "polish train-step parameters disagree with the CPU steps")

    # F1: K2 has no backward, so a CUDA fused_bigru under grad must raise
    grad_params = {k: v.requires_grad_() for k, v in params_from_jax(
        tree, dev)["gru_encoder"].items()}
    try:
        fg.fused_bigru(grad_params, torch.zeros(2, WINDOW, 10, device=dev),
                       torch.zeros(2, 2, PH, device=dev))
        raised = False
    except RuntimeError as exc:
        raised = "no backward" in str(exc)
    check(raised, "a CUDA fused_bigru under grad did not raise")

    # the main path: train_polish's loop on the card for one epoch with an
    # eval; every K2 launch is recorded with the grad mode it ran under
    grad_modes = []
    real_launch = fg.bigru_recurrence_packed

    def recorded_launch(*args, **kwargs):
        grad_modes.append(torch.is_grad_enabled())
        return real_launch(*args, **kwargs)

    model_dir = os.path.join(work_dir, "polish_models")
    windows = len(range(0, 1000 - WINDOW + 1, 50))
    steps = (n // TRAIN_BATCH) * windows
    eval_batches = -(-n // TRAIN_BATCH)
    fg.bigru_recurrence_packed = recorded_launch
    try:
        torch.cuda.reset_peak_memory_stats()
        fg.launches = 0                       # count the main path only
        t = time.time()
        best = pt.train_polish_loop((x8, y8), (x8, y8), model_dir,
                                    batch_size=TRAIN_BATCH, epoch_limit=1,
                                    lr=lr, weight_decay=wd, seed=5,
                                    device="cuda")
        wall = time.time() - t
        launches = fg.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        fg.bigru_recurrence_packed = real_launch
    check(launches == 2 * windows * eval_batches and not any(grad_modes),
          f"the polish eval of {eval_batches} batches launched K2 {launches} "
          f"times (expected {2 * windows * eval_batches}), under grad "
          f"{sum(grad_modes)} times (expected 0)")
    for f in ("train_loss.csv", "test_loss.csv", "confusion_matrix.txt"):
        check(len(glob.glob(os.path.join(model_dir, "stats_*", f))) == 1,
              f"the polish trainer wrote no {f}")
    check(os.path.isfile(os.path.join(model_dir, "PEPPER_POLISH_EPOCH_1.npz"))
          and os.path.isfile(best), "the polish trainer wrote no checkpoint")
    params, meta = load_checkpoint(best)
    saved = load_opt_state(best)
    check(saved is not None and len(saved) == 3 + 2 * 18
          and int(saved[2]) == steps, "the polish checkpoint lacks its "
          "optimizer state")
    check(all(np.isfinite(v).all() for _, v in vt.sorted_leaves(params)),
          "the polish checkpoint holds non-finite parameters")

    # resume from the checkpoint with its optimizer state
    resumed = pt.train_polish_loop((x8, y8), None,
                                   os.path.join(work_dir, "polish_resumed"),
                                   batch_size=TRAIN_BATCH, epoch_limit=1,
                                   lr=lr / 2, weight_decay=wd, seed=6,
                                   retrain_model_path=best, device="cuda")
    after_resume = load_opt_state(resumed)
    check(int(after_resume[2]) == int(saved[2]) + steps
          and float(after_resume[1]) == np.float32(lr / 2),
          f"the resumed polish run's optimizer count is "
          f"{int(after_resume[2])}, expected {int(saved[2]) + steps}, and "
          f"its learning rate {float(after_resume[1])}, expected {lr / 2}")

    # steady-state window step and its device time
    trained = vt.trainable(params, dev)
    step = pt.make_polish_train_step(trained, vt.make_optimizer(trained, lr,
                                                                wd))
    xd = torch.from_numpy(x8[:TRAIN_BATCH]).to(dev).float()[:, :WINDOW]
    yd = torch.from_numpy(y8[:TRAIN_BATCH].astype(np.int64)).to(dev)[
        :, :WINDOW]
    h0 = torch.zeros((TRAIN_BATCH, 2, PH), device=dev)
    step_ms = median_ms(lambda: step(xd, yd, h0))
    per_kernel = device_breakdown(lambda: step(xd, yd, h0))
    with open(glob.glob(os.path.join(model_dir, "stats_*",
                                     "train_loss.csv"))[0]) as fh:
        epoch_loss = float(fh.read().split(",")[1])
    print(f"polish trainer on {name}: {steps} window steps at batch "
          f"{TRAIN_BATCH} ({n // TRAIN_BATCH} batches x {windows} windows) "
          f"and an eval of {n} sequences in {wall:.2f}s wall; epoch loss "
          f"{epoch_loss:.4f}, accuracy {meta['accuracy']:.2f}%; K2 launches "
          f"{launches} (2 per eval window, none under grad); resumed "
          f"{steps} steps: optimizer count {int(saved[2])} -> "
          f"{int(after_resume[2])}; one window step {step_ms:.2f} ms (CUDA "
          f"events, median of 10); peak CUDA memory {peak_gb:.2f} GB",
          flush=True)
    total = sum(per_kernel.values())
    if total:
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile of one polish window step at batch {TRAIN_BATCH} "
              f"(torch.profiler, mean of 3): device busy {total:.3f} ms of "
              f"{step_ms:.2f} ms ({100 * (1 - total / step_ms):.0f}% idle); "
              f"top kernels: " + "; ".join(f"{k[:60]} {ms:.3f} ms"
                                           for k, ms in top), flush=True)
    else:
        print("profile: torch.profiler recorded no device time (device "
              "breakdown not measured)", flush=True)
    return launches


# -------------------------------------------------------------- phase 13
def _host_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of fn() (which ends in a wait on the device)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _k1_rows_independent(params, x8) -> bool:
    """K1 on a batch's input projections against K1 on its two halves:
    the kernel's rows are independent, so the halves must give the
    whole's bits."""
    from pepper_tpu_torch.ops import fused_lstm as fl

    B, T, _ = x8.shape
    dtype = params["encoder"]["weight_hh_l0"].dtype
    pack = fl.packed_layer(params["encoder"], fl.select_kernel(
        B, T, H, dtype))
    with torch.inference_mode():
        xp_f, xp_b = fl.packed_projections(pack, x8.to(dtype))
        whole = fl.bilstm_recurrence_packed(pack, xp_f, xp_b)
        half = B // 2
        halves = torch.cat([
            fl.bilstm_recurrence_packed(pack, xp_f[:half], xp_b[:half]),
            fl.bilstm_recurrence_packed(pack, xp_f[half:], xp_b[half:])])
    return bool(torch.equal(whole, halves))


def _k2_rows_independent(params, x8, h0) -> bool:
    """K2 likewise, on the encoder layer of one window with a nonzero h0."""
    from pepper_tpu_torch.ops import fused_gru as fg

    p = params["gru_encoder"]
    B = x8.shape[0]
    with torch.inference_mode():
        x = x8[:, :WINDOW].to(h0.dtype)
        whole = fg.fused_bigru(p, x, h0)
        half = B // 2
        parts = [fg.fused_bigru(p, x[:half], h0[:half]),
                 fg.fused_bigru(p, x[half:], h0[half:])]
    return all(bool(torch.equal(w, torch.cat([a, b])))
               for w, a, b in zip(whole, *parts))


def phase_sharded_inference(dev):
    """The runner and the vote function over a 2-entry mesh on the one
    card (two replicas, each on its own stream) against one replica in
    bf16. K1 and K2 take each row on its own, so a shard's kernel output
    is the whole's, bitwise. The cuBLAS GEMMs around them pick their
    kernel by row count: at the runner's 16384 rows (8192 a shard) and
    the vote's 256 sequences the results are bitwise the same; at 4096
    rows they differ at bf16 rounding (within 1e-2, a class changing only
    at a top-two margin that small)."""
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.models.polish_model import numpy_polish_params
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.parallel.mesh import data_mesh
    from pepper_tpu_torch.polish.consensus import (make_window_vote_fn,
                                                   window_votes)
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    mesh = data_mesh([dev, dev])
    check(len(mesh) == 2 and mesh[0] == mesh[1],
          f"a 2-entry mesh on one card: {mesh}")
    rng = np.random.default_rng(131)
    k1_launches = 0
    os.environ["PEPPER_TPU_PRECISION"] = "bf16"
    try:
        # the runner's batch, bitwise; then 4096 rows, where the linear
        # layers' cuBLAS kernels differ between 2048 and 4096 rows
        for seed, window, features, rows in (
                (132, 33, 26, SHARD_ROWS), (133, 21, 48, SHARD_ROWS),
                (132, 33, 26, 4096)):
            tree = numpy_variant_params(seed, features, window)
            x8 = images(rng, rows, window, features)
            sharded = DeviceRunner(tree, rows, mesh)
            single = DeviceRunner(tree, rows, mesh[:1])
            check(sharded.batch == rows and sharded.dtype == torch.bfloat16,
                  "the sharded runner's batch or dtype")
            fl.launches = 0                   # count the main path only
            got = np.asarray(sharded.submit(x8))
            launches = fl.launches
            check(launches == 4, f"two replicas launched K1 {launches} "
                  f"times for one batch (expected 2 each)")
            if rows == SHARD_ROWS:
                k1_launches += launches
            want = np.asarray(single.submit(x8))
            check(got.shape == (rows, 3) and np.isfinite(got).all(),
                  "sharded probabilities malformed")
            rows_k1 = _k1_rows_independent(
                single._replicas[0], torch.from_numpy(x8).to(dev))
            err = float(np.abs(got - want).max())
            top2 = np.sort(want, axis=1)[:, -2:]
            flipped = got.argmax(1) != want.argmax(1)
            n_diff = int((got != want).any(axis=1).sum())
            two_ms = _host_ms(lambda: np.asarray(sharded.submit(x8)))
            one_ms = _host_ms(lambda: np.asarray(single.submit(x8)))
            print(f"sharded inference {window}x{features}: 2 replicas on "
                  f"{mesh[0]} (own streams) vs 1, {rows} rows bf16: K1 "
                  f"launches {launches} (2 per replica); K1 on two halves "
                  f"bitwise the whole: {rows_k1}; rows differing from one "
                  f"replica {n_diff} (must be 0 at {SHARD_ROWS} rows), max "
                  f"abs err {err:.3e} (tolerance 1e-2), classes changed "
                  f"{int(flipped.sum())}; {two_ms:.3f} ms per batch with 2 "
                  f"replicas, {one_ms:.3f} ms with 1 (host clock around "
                  f"submit and the D2H wait, median of 10)", flush=True)
            check(rows_k1, "K1 on two halves differs from K1 on the whole")
            check(n_diff == 0 or rows != SHARD_ROWS, "the 2-replica "
                  "runner's probabilities differ from one replica's")
            check(err <= 1e-2 and bool(
                (np.diff(top2[flipped], axis=1) <= 2 * err).all()),
                "the 2-replica runner's probabilities differ from one "
                "replica's beyond bf16 rounding")
            del sharded, single
    finally:
        os.environ.pop("PEPPER_TPU_PRECISION", None)

    tree = numpy_polish_params(134)
    x8 = torch.from_numpy(polish_images(rng, 2 * POLISH_BATCH)).to(dev)
    vote_mesh = make_window_vote_fn(tree, dev, torch.bfloat16, mesh=mesh)
    vote_one = make_window_vote_fn(tree, dev, torch.bfloat16)
    fg.launches = 0                           # count the main path only
    labels, phred = vote_mesh(x8)
    torch.cuda.synchronize()
    k2_launches = fg.launches
    check(k2_launches == 2 * 38, f"the sharded vote launched K2 "
          f"{k2_launches} times (expected 38 per 128-row shard)")
    want_labels, want_phred = vote_one(x8)
    params = params_from_jax(tree, dev, torch.bfloat16)
    h0 = torch.from_numpy(0.5 * rng.standard_normal(
        (2 * POLISH_BATCH, 2, PH)).astype(np.float32)).to(dev, torch.bfloat16)
    rows_k2 = _k2_rows_independent(params, x8, h0)
    with torch.inference_mode():
        margin = vote_margins(window_votes(params, x8.to(torch.bfloat16)))
    changed = labels != want_labels
    worst_margin = float(margin[changed].max()) if bool(changed.any()) \
        else 0.0
    two_ms = median_ms(lambda: vote_mesh(x8))
    one_ms = median_ms(lambda: vote_one(x8))
    print(f"sharded vote: {2 * POLISH_BATCH} sequences bf16 over 2 replicas "
          f"vs 1: K2 launches {k2_launches} (38 per shard); K2 on two "
          f"halves bitwise the whole: {rows_k2}; base labels differing "
          f"{int(changed.sum())} of {changed.numel()} (at unsharded top-two "
          f"vote margins up to {worst_margin:.2e}), phred differing at "
          f"{int((phred != want_phred).sum())} (both must be 0); {two_ms:.3f} "
          f"ms per batch with 2 replicas, {one_ms:.3f} ms with 1 (CUDA "
          f"events on the caller's stream, median of 10)", flush=True)
    check(labels.shape == (2 * POLISH_BATCH, 1000)
          and bool(torch.isfinite(phred).all()), "sharded votes malformed")
    check(rows_k2, "K2 on two halves differs from K2 on the whole")
    check(not bool(changed.any()) and torch.equal(phred, want_phred),
          "the sharded vote's labels or phred differ from the unsharded "
          "one's")
    return k1_launches, k2_launches


# -------------------------------------------------------------- phase 14
def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="4")


def _run_all(cmds, log_dir, timeout=600):
    """Run the commands at once from the repo's root, their output in
    files under log_dir; kill any still running at the timeout or on an
    error. Returns each one's (wall s, stderr text); fails on a non-zero
    exit. This process's cached CUDA blocks are released first: the
    commands share the card with it."""
    torch.cuda.empty_cache()
    procs, files = [], []
    try:
        for i, cmd in enumerate(cmds):
            out = open(os.path.join(log_dir, f"proc{i}.out"), "w+")
            err = open(os.path.join(log_dir, f"proc{i}.err"), "w+")
            files += [out, err]
            procs.append((time.time(), subprocess.Popen(
                cmd, cwd=ROOT, env=_env(), stdout=out, stderr=err)))
        walls = [None] * len(procs)
        deadline = time.time() + timeout
        while None in walls and time.time() < deadline:
            for i, (t0, p) in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.time() - t0
            time.sleep(0.05)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = []
    for i, (_, p) in enumerate(procs):
        with open(os.path.join(log_dir, f"proc{i}.err")) as fh:
            errs.append(fh.read())
        check(walls[i] is not None, f"{cmds[i][:4]} ran past {timeout}s")
        check(p.returncode == 0, f"a subprocess failed ({cmds[i][:4]}): "
              + errs[i][-3000:])
    for f in files:
        f.close()
    return list(zip(walls, errs))


def phase_two_hosts(dev, work_dir, variant_run):
    """Two hosts in filesystem mode on the one card: the streamed
    call_variant of phase 6's dataset striped over 2 processes sharing one
    output directory; host 0's VCFs against phase 6's 1-host run."""
    out = os.path.join(work_dir, "two_hosts") + "/"
    logs = os.path.join(work_dir, "two_hosts_logs")
    os.makedirs(logs)
    cmds = [[sys.executable, "-m", "pepper_tpu_torch.cli.pepper_variant_main",
             "call_variant", "-b", variant_run["bam"], "-f",
             variant_run["fasta"], "-m", variant_run["model"], "-o", out,
             "--ont_r9_guppy5_sup", "-t", "4", "--region_size", "25000",
             "--device", dev.type, "--num_hosts", "2", "--host_id",
             str(host)] for host in (0, 1)]
    (wall0, err0), (wall1, _) = _run_all(cmds, logs)
    waits = [ln.rsplit(" ", 1)[-1] for ln in err0.splitlines()
             if "GATHER WAIT" in ln]
    single = {os.path.basename(p): open(p, "rb").read() for p in
              sorted(glob.glob(os.path.join(variant_run["out"], "*.vcf.gz")))}
    double = {os.path.basename(p): open(p, "rb").read() for p in
              sorted(glob.glob(os.path.join(out, "*.vcf.gz")))}
    same = [name for name in single if double.get(name) == single[name]]
    print(f"two hosts (filesystem mode) on one card, streamed call_variant "
          f"of the phase-6 dataset: host 0 wall {wall0:.2f}s, host 1 "
          f"wall {wall1:.2f}s (process start and kernel load included; "
          f"the 1-host run in process: {variant_run['wall']:.2f}s); host 0's "
          f"gather wait {waits[0] if waits else 'not logged'}; VCFs "
          f"byte-identical to the 1-host run: {len(same)} of {len(single)}",
          flush=True)
    check(len(single) == 5 and sorted(double) == sorted(single)
          and len(same) == 5, "the 2-host VCFs differ from the 1-host run")
    check(not glob.glob(os.path.join(out, ".pepper_candidates_host_*")),
          "the gather left a candidate shard behind")


# -------------------------------------------------------------- phase 15
def phase_two_ranks(dev, work_dir):
    """Two ranks of variant training in one gloo group on the one card
    (NCCL refuses two ranks on one card), 4 full-width steps at global
    batch 128 with dropout on, against one process that runs the same two
    blocks as in-process replicas."""
    data = os.path.join(work_dir, "dp")
    os.makedirs(data)
    rng = np.random.default_rng(151)
    np.save(os.path.join(data, "images.npy"), images(rng, 128))
    np.save(os.path.join(data, "labels.npy"), rng.integers(0, 3, 128))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    device = "cuda:0" if dev.type == "cuda" else "cpu"

    def rank_cmd(tag, *extra):
        return [sys.executable, "-m", "pepper_tpu_torch.parallel.dp_rehearsal",
                "variant", "--data", data, "--steps", "4", "--hidden", str(H),
                "--device", device, "--dropout", "--out",
                os.path.join(data, tag + ".npz"), *extra]

    (wall, _), _ = _run_all(
        [rank_cmd(f"rank{r}", "--rank", str(r), "--world", "2", "--backend",
                "gloo", "--coordinator", f"127.0.0.1:{port}")
         for r in range(2)], data)
    _run_all([rank_cmd("single", "--blocks", "2")], data)
    ranks = [np.load(os.path.join(data, f"rank{r}.npz")) for r in range(2)]
    single = np.load(os.path.join(data, "single.npz"))
    keys = [k for k in single.files if not k.startswith("__")]
    worst, identical = 0.0, True
    for k in keys:
        tol = 1e-4 + 5e-3 * np.abs(single[k])
        worst = max(worst, float((np.abs(ranks[0][k] - single[k])
                                  / tol).max()))
        identical &= bool(np.array_equal(ranks[0][k], ranks[1][k]))
    losses = ranks[0]["__losses__"]
    loss_err = float(np.max(np.abs(losses - single["__losses__"])
                            / np.abs(single["__losses__"])))
    step_ms = [float(np.median(r["__step_ms__"][1:])) for r in ranks]
    share = [float(np.median(r["__allreduce_ms__"][1:]
                             / r["__step_ms__"][1:])) for r in ranks]
    launches = [[int(v) for v in r["__launches__"]] for r in ranks]
    print(f"two ranks (gloo, both on {device}) of variant training, 4 "
          f"full-width steps at global batch 128, dropout on: losses "
          f"{[round(float(v), 4) for v in losses]} vs one process "
          f"{[round(float(v), 4) for v in single['__losses__']]} (max rel "
          f"{loss_err:.2e}, tolerance 1e-4); parameters at worst "
          f"{worst:.3f} of the tolerance rtol 5e-3 + atol 1e-4; ranks "
          f"bit-identical: {identical}; K3/K4 launches per rank {launches} "
          f"(2 each per step); ms per step (median of steps 2-4, host clock "
          f"with the card synchronized, upload included) {step_ms}, the "
          f"all-reduce's share {[round(v, 3) for v in share]}; wall "
          f"{wall:.2f}s for rank 0 (process start and kernel load included)",
          flush=True)
    check(len(keys) == 28 and worst <= 1.0 and loss_err <= 1e-4,
          "two ranks disagree with one process")
    check(identical and np.array_equal(ranks[0]["__losses__"],
                                       ranks[1]["__losses__"]),
          "the two ranks hold different parameters")
    check(all(lc == [8, 8] for lc in launches),
          f"each rank must launch K3 and K4 twice per step: {launches}")
    return launches


# -------------------------------------------------------------- phase 16
def phase_dryrun(dev):
    from pepper_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.time()
    out = dryrun_multichip(2, device=str(dev))
    print(f"dryrun_multichip(2) on the card: {json.dumps(out)} "
          f"[{time.time() - t0:.1f}s]", flush=True)
    check(out["shapes"] == {"base": [4, 3], "hp": [4, 3],
                            "polish": [4, 1000]}
          and np.isfinite(out["loss"]), "the dry run's outputs")


# -------------------------------------------------------------- phase 17
def numpy_tree_like(tree, seed: int):
    """Seeded numpy leaves of the shapes of `tree` (a parameter tree from
    one of the port's init functions): weights and biases
    U(+-1/sqrt(fan in)), BatchNorm statistics and 1-D scales near 1, so
    every normalisation is exercised."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            shape = tuple(v.shape)
            if k == "running_var" or (k == "weight" and len(shape) == 1):
                leaf = rng.uniform(0.5, 1.5, shape)
            elif k == "running_mean":
                leaf = rng.normal(0.0, 0.1, shape)
            else:
                b = 1.0 / np.sqrt(int(np.prod(shape[1:])) if len(shape) > 1
                                  else shape[0])
                leaf = rng.uniform(-b, b, shape)
            out[k] = leaf.astype(np.float32)
        return out

    return fill(tree)


def phase_alternates(dev, name):
    """The alternate models at full width on the card (f32, TF32 off)
    against the port on the CPU at f32; no kernel serves them."""
    from pepper_tpu_torch.models import polish_seq2seq as s2s
    from pepper_tpu_torch.models import variant_no_cnn as no_cnn
    from pepper_tpu_torch.models import variant_transformer as tf
    from pepper_tpu_torch.models.checkpoint import params_from_jax
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.ops import fused_lstm as fl

    tol = 1e-4    # probabilities and hidden states, card f32 vs cpu f32
    rows, images_b, layers, hidden = ALT_ROWS, 64, 3, 128
    gen = torch.Generator().manual_seed(171)
    rng = np.random.default_rng(172)
    trees = {
        "transformer": numpy_tree_like(tf.init_transformer_params(gen), 173),
        "no_cnn": numpy_tree_like(no_cnn.init_no_cnn_params(gen), 174),
        "encoder": numpy_tree_like(s2s.init_encoder_params(
            gen, gru_layers=layers, hidden_size=hidden), 175),
        "decoder": numpy_tree_like(s2s.init_decoder_params(
            gen, hidden, layers, 5, 1000), 176),
    }
    x = torch.from_numpy(images(rng, rows)).float()
    state = [torch.from_numpy(rng.standard_normal((rows, 2, hidden)).astype(
        np.float32)) for _ in range(2)]
    image = torch.from_numpy(rng.standard_normal(
        (images_b, 1, 1000, 20)).astype(np.float32))
    h_enc = torch.from_numpy(0.5 * rng.standard_normal(
        (images_b, 2 * layers, hidden)).astype(np.float32))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, 1000, images_b)), 1000).float()

    def runs(device, dtype):
        """Each model's outputs (probabilities, then hidden states) and a
        thunk that runs its forward again, on `device` in `dtype`."""
        p = {k: params_from_jax(t, device, dtype) for k, t in trees.items()}

        def put(t):
            return t.to(device, dtype)

        xs, hs, cs = put(x), put(state[0]), put(state[1])
        img, h0, oh = put(image), put(h_enc), put(onehot)
        fwd = {
            "transformer": lambda: (tf.transformer_forward(
                p["transformer"], xs),),
            "no_cnn": lambda: (no_cnn.no_cnn_forward(p["no_cnn"], xs, hs,
                                                     cs),),
            "encoder": lambda: s2s.encoder_forward(p["encoder"], img, h0,
                                                   layers),
        }
        with torch.inference_mode():
            out = {k: f() for k, f in fwd.items()}
            ctx, h_final = out["encoder"]
            fwd["decoder"] = lambda: s2s.decoder_forward(
                p["decoder"], oh, ctx, h_final, layers)
            logits, h_dec, attn = fwd["decoder"]()
            out["decoder"] = (torch.softmax(logits.float(), dim=-1), h_dec,
                              attn)
        return out, fwd

    launches = (fl.launches, fg.launches)
    want, _ = runs(torch.device("cpu"), torch.float32)
    got, fwd = runs(dev, torch.float32)
    got_bf16, _ = runs(dev, torch.bfloat16)
    check((fl.launches, fg.launches) == launches, "an alternate model "
          "launched a kernel (none serves them)")
    errs, errs_bf16, ms = {}, {}, {}
    for k in trees:
        check(all(g.shape == w.shape and bool(torch.isfinite(g).all())
                  for g, w in zip(got[k], want[k])),
              f"{k}: malformed output on the card")
        errs[k] = max(_max_err(g.cpu(), w) for g, w in zip(got[k], want[k]))
        errs_bf16[k] = max(_max_err(g.cpu(), w)
                           for g, w in zip(got_bf16[k], want[k]))
        with torch.inference_mode():
            ms[k] = median_ms(fwd[k], reps=3 if k == "encoder" else 10)
    print(f"alternates at full width on {name}: transformer (F=26, window "
          f"33, 6 layers, d=104, 8 heads) and no_cnn (hidden 128, random "
          f"[B,2,128] state) on {rows} rows, the seq2seq encoder (hidden "
          f"{hidden}, {layers} biGRU layers) on a [{images_b},1,1000,20] "
          f"image and its decoder (seq_len 1000, 5 classes) on that context; "
          f"max_abs_err card f32 vs cpu f32 (probabilities, hidden states, "
          f"attention; tolerance {tol:g}): "
          + ", ".join(f"{k} {errs[k]:.3e}" for k in trees)
          + "; bf16 vs cpu f32: "
          + ", ".join(f"{k} {errs_bf16[k]:.3e}" for k in trees)
          + "; ms per f32 forward (CUDA events, median of 10, encoder of 3): "
          + ", ".join(f"{k} {ms[k]:.3f}" for k in trees), flush=True)
    for k in trees:
        check(errs[k] <= tol, f"{k}: card f32 disagrees with cpu f32 "
              f"({errs[k]:.3e})")


# -------------------------------------------------------------- phase 18
def _finder_candidates(result):
    """The called candidates of a legacy finder's positional map, as
    (pos, end, ref, alt, type, depth, support, genotype), with their
    (alt_prob_h1, alt_prob_h2, non_ref_prob)."""
    out = {}
    for pos in sorted(result):
        for c in result[pos]:
            out[(c.pos, c.pos_end, c.allele.ref, c.allele.alt,
                 c.allele.alt_type, c.depth, c.read_support, c.genotype)] = \
                (c.alt_prob_h1, c.alt_prob_h2, c.non_ref_prob)
    return out


def record_k2_calls(polish_model):
    """Wraps `polish_model.fused_bigru` (the biGRU layer `polish_forward`
    calls with fused_rnn=True) so that each call's (params, x, h0) and
    (out, h_final) are kept: the inputs and outputs K2 had on the path.
    Returns (calls, restore)."""
    calls, layer = [], polish_model.fused_bigru

    def recorded(params, x, h0):
        result = layer(params, x, h0)
        calls.append((params, x, h0, result))
        return result

    polish_model.fused_bigru = recorded
    return calls, lambda: setattr(polish_model, "fused_bigru", layer)


def k2_calls_against_plain(calls):
    """The max abs error of each recorded K2 call's out and h_final against
    K2's plain version on the same inputs, in the same dtype."""
    from pepper_tpu_torch.ops import fused_gru as fg

    errs = []
    with torch.inference_mode():
        for params, x, h0, (out, h_n) in calls:
            want = fg.bigru_recurrence_plain(
                *fg.input_projections(params, x),
                params["weight_hh_l0"].t(), params["weight_hh_l0_reverse"].t(),
                params["bias_hh_l0"], params["bias_hh_l0_reverse"], h0[:, 0],
                h0[:, 1])
            errs.append(max(_max_err(out, want[0]), _max_err(h_n, want[1])))
    return errs


def phase_hp_legacy(dev, name, data):
    """The legacy chunked-HP chain on phase 11's haplotype-tagged dataset:
    the port's RegionalSummaryHP makes the 48-feature matrix,
    make_chunked_hp_images chunks it, a full-width polish model votes
    through K2, and the legacy HP finder reads the votes."""
    from pepper_tpu_torch.encode.region_encoder_hp import RegionalSummaryHP
    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.models import polish_model
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.pipelines import hp_legacy as hp
    from pepper_tpu_torch.pipelines.candidate_finder_legacy import \
        CandidateFinderCPP

    batch = 64
    per_batch = 19 * 2 * 2      # windows x biGRU layers x haplotypes
    contig, end = data["contig"], data["length"] - 1
    t0 = time.time()
    reads = BamReader(data["bam"]).get_reads(contig, 0, end + 1)
    ref = FastaReader(data["fasta"]).get_reference_sequence(contig, 0,
                                                            end + 1)
    summary = RegionalSummaryHP(contig, 0, end, ref)
    summary.generate_summary(
        reads, min_snp_baseq=1, min_indel_baseq=1, snp_freq_threshold=0.1,
        insert_freq_threshold=0.15, delete_freq_threshold=0.15,
        min_coverage_threshold=2, snp_candidate_freq_threshold=0.1,
        indel_candidate_freq_threshold=0.1, candidate_support_threshold=2,
        skip_indels=False, candidate_region_start=0, candidate_region_end=end)
    chunks = hp.make_chunked_hp_images(summary.matrix, np.arange(end + 1),
                                       np.zeros(end + 1, np.int64))
    summaries = [dict(c, contig=contig, region_start=0, region_end=end)
                 for c in chunks]
    n_batches = -(-len(chunks) // batch)
    tree = polish_model.numpy_polish_params(181, features=48)
    print(f"legacy HP chain input: {len(reads)} reads, matrix "
          f"{summary.matrix.shape}, {len(chunks)} chunks of 1000 in "
          f"{n_batches} batches of {batch} [{time.time() - t0:.1f}s]",
          flush=True)

    prior = os.environ.get("PEPPER_TPU_PRECISION")

    def vote(device, precision, fused_rnn=True):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        fn = hp.load_hp_vote_fn(tree, device=device, fused_rnn=fused_rnn)
        t = time.time()
        records = list(hp.vote_records(summaries, fn, batch))
        return fn, records, time.time() - t

    calls, restore = record_k2_calls(polish_model)
    try:
        fg.launches = 0                       # count the main path only
        mma_before = fg.kernel_launches["mma"]
        fn_bf16, rec_bf16, wall_bf16 = vote(dev, "bf16")
        launches = fg.launches
        launches_mma = fg.kernel_launches["mma"] - mma_before
        restore()
        fg.launches = 0
        _, rec_f32, wall_f32 = vote(dev, "f32")
        launches_f32 = fg.launches
        _, rec_cpu, wall_cpu = vote(torch.device("cpu"), "f32",
                                    fused_rnn=False)
        _, rec_plain_bf16, _ = vote(dev, "bf16", fused_rnn=False)
    finally:
        restore()
        if prior is None:
            os.environ.pop("PEPPER_TPU_PRECISION", None)
        else:
            os.environ["PEPPER_TPU_PRECISION"] = prior
    check(launches == launches_f32 == per_batch * n_batches,
          f"K2 launched {launches} (bf16) and {launches_f32} (f32) times "
          f"for {n_batches} legacy HP batches, expected {per_batch} each")
    # every bf16 launch of the path ran K2's tensor-core kernel; each is
    # held against K2's plain version on the inputs it had, at phase 3's
    # bf16 bound
    k2_tol = 2e-2
    check(launches_mma == launches == len(calls)
          and all(x.dtype == torch.bfloat16 for _, x, _, _ in calls),
          f"the bf16 legacy HP vote launched K2 mma {launches_mma} of "
          f"{launches} times ({len(calls)} recorded)")
    k2_errs = k2_calls_against_plain(calls)
    del calls

    def votes(records):
        return np.stack([np.stack([r["base_predictions_hp1"],
                                   r["base_predictions_hp2"]])
                         for r in records])

    v_cpu, v_f32, v_bf16 = votes(rec_cpu), votes(rec_f32), votes(rec_bf16)
    v_plain_bf16 = votes(rec_plain_bf16)
    check(v_f32.shape == v_cpu.shape == v_bf16.shape == (len(chunks), 2,
                                                        1000, 5)
          and v_f32.dtype == v_bf16.dtype == np.int32,
          "legacy HP votes malformed")
    err_f32 = int(np.abs(v_f32 - v_cpu).max())
    n_bf16 = int((v_bf16.argmax(-1) != v_cpu.argmax(-1)).sum())
    err_bf16_plain = int(np.abs(v_bf16 - v_plain_bf16).max())
    n_bf16_plain = int((v_bf16.argmax(-1) != v_plain_bf16.argmax(-1)).sum())

    x1 = torch.from_numpy(np.stack(
        [np.asarray(c["image_hp1"], np.uint8) for c in chunks[:batch]]))
    x2 = torch.from_numpy(np.stack(
        [np.asarray(c["image_hp2"], np.uint8) for c in chunks[:batch]]))
    x1, x2 = x1.to(dev), x2.to(dev)
    batch_ms = median_ms(lambda: fn_bf16(x1, x2), reps=5)
    per_kernel = device_breakdown(lambda: fn_bf16(x1, x2))

    cf = CandidateFinderCPP(contig, 0, end)
    found, finder_s = {}, {}
    for label, recs in (("cpu", rec_cpu), ("cuda_f32", rec_f32),
                        ("cuda_bf16", rec_bf16)):
        t = time.time()
        inputs = hp.predictions_to_finder_inputs(hp.HPPredictionList(recs))
        check(len(inputs[0]) == end + 1, "the bridge lost positions")
        found[label] = _finder_candidates(cf.find_candidates_hp(
            data["bam"], data["fasta"], contig, 0, end, *inputs, False, 0.0))
        finder_s[label] = time.time() - t
    cpu, f32 = found["cpu"], found["cuda_f32"]
    differ = sorted(set(cpu) ^ set(f32))
    prob_err = max((max(abs(a - b) for a, b in zip(cpu[k], f32[k]))
                    for k in set(cpu) & set(f32)), default=0.0)

    print(f"legacy chunked-HP vote on {name}: polish model F=48 H={PH} 5 "
          f"classes; K2 launches {launches} in {n_batches} batches "
          f"({per_batch} per batch: 19 windows x 2 layers x 2 haplotypes; "
          f"f32 run {launches_f32}); vote wall (host clock, all chunks) cuda "
          f"bf16 {wall_bf16:.2f}s, cuda f32 {wall_f32:.2f}s, cpu f32 step "
          f"loop {wall_cpu:.2f}s; one {batch}-chunk batch {batch_ms:.2f} ms "
          f"bf16 (CUDA events, median of 5); int votes cuda f32 vs cpu "
          f"max_abs_diff {err_f32} (tolerance 2); bf16 argmax differs at "
          f"{n_bf16} of {v_cpu.shape[0] * 2000} (chunk, haplotype, "
          f"position) slots", flush=True)
    print(f"bf16 legacy HP vote, K2 mma on each of its {len(k2_errs)} "
          f"launches vs K2's plain version on that launch's inputs: "
          f"max_abs_err out/h_final {max(k2_errs):.3e} (tolerance "
          f"{k2_tol:g}, phase 3's bf16 bound); bf16 votes through K2 vs "
          f"the plain step loop on the card in bf16: int votes "
          f"max_abs_diff {err_bf16_plain}, argmax differs at "
          f"{n_bf16_plain} slots", flush=True)
    check(max(k2_errs) <= k2_tol, f"K2 mma disagrees with its plain "
          f"version on the bf16 legacy HP vote's inputs: {max(k2_errs)} > "
          f"{k2_tol} at launch {int(np.argmax(k2_errs))}")
    total = sum(per_kernel.values())
    if total:
        k2_ms = sum(ms for k, ms in per_kernel.items() if "bigru" in k)
        print(f"profile of one {batch}-chunk legacy HP batch (torch.profiler,"
              f" mean of 3): device busy {total:.2f} ms of {batch_ms:.2f} ms "
              f"({100 * (1 - total / batch_ms):.0f}% idle); K2 {k2_ms:.2f} "
              f"ms ({100 * k2_ms / total:.0f}% of busy, "
              f"{100 * k2_ms / batch_ms:.0f}% of the batch)", flush=True)
    else:
        print("profile: torch.profiler recorded no device time (device "
              "breakdown not measured)", flush=True)
    print(f"legacy HP finder (CandidateFinderCPP.find_candidates_hp over "
          f"{end + 1} bp): cpu {len(cpu)} candidates [{finder_s['cpu']:.1f}s]"
          f", cuda f32 {len(f32)} ({len(differ)} differ: "
          f"{differ[:5]}; probability max_abs_diff on the shared ones "
          f"{prob_err:.3e}), cuda bf16 {len(found['cuda_bf16'])} "
          f"({len(set(cpu) ^ set(found['cuda_bf16']))} differ from cpu)",
          flush=True)
    positions = np.stack([c["position"] for c in chunks])
    for key in differ[:10]:
        ci, j = np.nonzero(positions == key[0])
        top2 = np.sort(v_cpu[ci, :, j], axis=-1)[..., -2:]
        print(f"  differing candidate {key}: cpu top-two vote margins at "
              f"position {key[0]} (per chunk, per haplotype) "
              f"{(top2[..., 1] - top2[..., 0]).tolist()}", flush=True)
    check(len(cpu) > 0, "the legacy HP finder found no candidate on the CPU")
    check(err_f32 <= 2, f"cuda f32 legacy HP votes differ from the CPU's by "
          f"{err_f32}")
    check(not differ, "the legacy HP finder's candidates from the card's "
          "f32 votes differ from the CPU's")
    return launches


# -------------------------------------------------------------- phase 19
SCALE_MBP, SCALE_CONTIGS = 6, 3   # ~15 batches of 16384: the kill at ~8


def phase_scale_rehearsal(work_dir):
    """The scale rehearsal (pepper_tpu_torch/utils/scale_rehearsal.py) on
    the card at a reduced depth, in bf16 at the 16384-row batch: two
    uninterrupted streamed call_variant runs, a kill -9 after half of the
    batches and a resume whose 5 VCFs must be byte-identical. Returns K1's
    launches in the measured run (read from its child's stderr)."""
    out = os.path.join(work_dir, "scale.json")
    torch.cuda.empty_cache()   # the children share the card with us
    t = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.scale_rehearsal",
         "--mbp", str(SCALE_MBP), "--contigs", str(SCALE_CONTIGS),
         "--device", "cuda", "--out", out, "--cache-dir",
         os.path.join(work_dir, "scale")],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    wall = time.time() - t
    check(p.returncode == 0 and os.path.isfile(out),
          f"the scale rehearsal failed (exit {p.returncode}): "
          + p.stderr[-4000:] + p.stdout[-2000:])
    with open(out) as fh:
        rec = json.load(fh)
    print(json.dumps(rec), flush=True)
    replayed = int(rec["resume_replayed"].split("/")[0])
    batches = -(-rec["candidates"] // rec["batch_floor"])
    print(f"scale rehearsal on the card, {SCALE_MBP} Mbp over "
          f"{SCALE_CONTIGS} contigs: {rec['candidates']} candidates in "
          f"{batches} batches of {rec['batch_floor']} ({rec['precision']}); "
          f"warm run {rec['e2e_wall_s']}s ({rec['mbp_per_s']} Mbp/s), peak "
          f"RSS {rec['peak_rss_mb']} MB (at thirds {rec['rss_mb_thirds']}), "
          f"peak device {rec['peak_device_mb']} MB (at thirds "
          f"{rec['peak_device_mb_thirds']}), device busy "
          f"{rec['device_busy_s']}s of the {rec['stream_s']}s stream (idle "
          f"share {rec['device_idle_share']}), K1 launches "
          f"{rec['k1_launches']}; kill -9 after batch "
          f"{rec['crash_after_batches']} (exit {rec['crash_exit_code']}), "
          f"journal {rec['journal_mb_at_crash']} MB, resume replayed "
          f"{rec['resume_replayed']} intervals in {rec['resume_wall_s']}s, "
          f"VCFs byte-identical: {rec['resume_byte_identical']}; the "
          f"phase took {wall:.1f}s", flush=True)
    check(rec["precision"] == "bf16" and rec["batch_floor"] == SHARD_ROWS,
          "the rehearsal did not run the card's default bf16 16384-row "
          "batch")
    check(rec["crash_exit_code"] == 9 and replayed >= 1,
          "the killed rehearsal run did not exit 9 or its resume replayed "
          "no interval")
    check(rec["resume_byte_identical"], "the resumed VCFs differ from the "
          f"uninterrupted run's: first difference {rec['first_difference']}")
    check(rec["k1_launches"] == 2 * batches, f"the rehearsal's measured run "
          f"launched K1 {rec['k1_launches']} times for {batches} batches "
          f"(expected 2 each)")
    check(0 < rec["device_busy_s"] < rec["stream_s"], "the rehearsal's "
          f"device busy time {rec['device_busy_s']}s is not within its "
          f"{rec['stream_s']}s stream")
    return rec["k1_launches"]


# -------------------------------------------------------------- phase 20
_POLISH_DRIVER = """
import sys
sys.path.insert(0, {root!r})
from pepper_tpu_torch.ops import fused_gru
from pepper_tpu_torch.polish.pipeline import polish
bam, draft, model, out = sys.argv[1:5]
polish(bam, draft, model, out, threads=4, batch_size={batch},
       realignment=True, device="cuda")
sys.stderr.write("K2 LAUNCHES: %d\\n" % fused_gru.launches)
"""


def phase_polish_resume(work_dir, data):
    """The streamed polish of phase 7's dataset on the card (bf16) in a
    subprocess: uninterrupted, then killed (os._exit(9)) after about half
    of its sequences are flushed, then resumed on the same output
    directory; the resumed FASTA must be byte-identical to the
    uninterrupted one. Returns K2's launches [uninterrupted, resumed]."""
    torch.cuda.empty_cache()

    def run(out, crash_after=0):
        env = _env()
        if crash_after:
            env["PEPPER_TPU_TEST_CRASH_AFTER_POLISH_FLUSH"] = str(crash_after)
        t = time.time()
        p = subprocess.run(
            [sys.executable, "-c", _POLISH_DRIVER.format(
                root=ROOT, batch=POLISH_BATCH), data["bam"], data["draft"],
             data["model"], out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        return p, time.time() - t

    def launches(p):
        m = [ln for ln in p.stderr.splitlines() if ln.startswith("K2 LAUN")]
        return int(m[-1].split()[-1]) if m else 0

    ref_out = os.path.join(work_dir, "polish_ref") + "/"
    p, wall = run(ref_out)
    check(p.returncode == 0, "the uninterrupted polish run failed: "
          + p.stderr[-3000:])
    n_seqs = int(p.stderr.split("STREAMED PILEUP+CONSENSUS: ")[1].split()[0])
    ref_launches = launches(p)
    with open(ref_out + "PEPPER_pepper_polished.fa", "rb") as fh:
        ref = fh.read()
    n_batches = -(-n_seqs // POLISH_BATCH)
    check(ref_launches == 38 * n_batches, f"the uninterrupted polish "
          f"launched K2 {ref_launches} times for {n_batches} batches "
          "(expected 38 each)")

    out = os.path.join(work_dir, "polish_crash") + "/"
    crash_after = n_seqs // 2
    p, _ = run(out, crash_after)
    journal = out + "pepper_polish_resume.journal"
    check(p.returncode == 9 and os.path.isfile(journal),
          f"the polish run killed after {crash_after} sequences exited "
          f"{p.returncode} (expected 9) or left no journal: "
          + p.stderr[-3000:])
    journal_mb = os.path.getsize(journal) / 1e6
    p, resume_wall = run(out)
    check(p.returncode == 0, "the resumed polish run failed: "
          + p.stderr[-3000:])
    replayed = p.stderr.split("RESUME: ")[1].split()[0] \
        if "RESUME: " in p.stderr else "0/0"
    resume_launches = launches(p)
    with open(out + "PEPPER_pepper_polished.fa", "rb") as fh:
        got = fh.read()
    print(f"polish kill -9 and resume on the card (bf16): {n_seqs} "
          f"sequences in {n_batches} batches, uninterrupted {wall:.2f}s "
          f"with {ref_launches} K2 launches; killed after {crash_after} "
          f"sequences (exit 9), journal {journal_mb:.3f} MB; the resume "
          f"replayed {replayed} intervals in {resume_wall:.2f}s with "
          f"{resume_launches} K2 launches; FASTA byte-identical: "
          f"{got == ref}", flush=True)
    check(int(replayed.split("/")[0]) >= 1, "the resumed polish replayed "
          "no interval from the journal")
    check(0 < resume_launches <= ref_launches
          and resume_launches % 38 == 0, f"the resumed polish launched K2 "
          f"{resume_launches} times (expected 38 per batch it ran)")
    check(not os.path.isfile(journal), "the resumed polish left its "
          "journal behind")
    check(got == ref, "the resumed polished FASTA differs from the "
          "uninterrupted card run's")
    return [ref_launches, resume_launches]


# -------------------------------------------------------------- phase 21
BENCH_MBP = 1   # the bench at 1 Mbp: ~40,000 candidates, 3 batches of 16384


def _bench_env():
    return dict(os.environ, PYTHONPATH=ROOT)


def phase_bench(work_dir):
    """The port's bench (pepper_tpu_torch/utils/bench.py) on the card at
    1 Mbp with one timed e2e run, in a subprocess, as a user runs it: it
    must exit 0 and print its headline, and its kernel launches per stage
    must be K1 twice per 16384-row batch in every device-only and e2e pass,
    K2 38 times per 128-sequence polish batch, and K3 and K4 twice per
    train step. Returns the launches by kernel."""
    torch.cuda.empty_cache()   # the child shares the card with us
    t = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.bench", "--mbp",
         str(BENCH_MBP), "--runs", "1", "--device", "cuda", "--cache-dir",
         os.path.join(work_dir, "bench")],
        cwd=ROOT, env=_bench_env(), capture_output=True, text=True,
        timeout=600)
    wall = time.time() - t
    check(p.returncode == 0, f"the bench failed (exit {p.returncode}): "
          + p.stderr[-4000:] + p.stdout[-2000:])
    for line in p.stderr.splitlines():
        if line.startswith("[bench] "):
            print(line, flush=True)
    head = json.loads(p.stdout.strip().splitlines()[-1])
    check(set(head) == {"metric", "value", "unit", "vs_baseline"}
          and head["metric"] == "variant_e2e_throughput"
          and head["unit"] == "Mbp/s" and head["value"] > 0,
          f"the bench's headline is malformed: {head}")
    tag = "kernel launches per stage: "
    line = [ln for ln in p.stderr.splitlines() if tag in ln]
    check(len(line) == 1, "the bench printed no kernel launches line")
    launches = json.loads(line[0].split(tag)[1])
    dev_only = launches["device_only"]
    check(dev_only["batch_rows"] == SHARD_ROWS, "the bench's runner did "
          f"not run the card's {SHARD_ROWS}-row batch")
    want = 2 * -(-dev_only["candidates"] // SHARD_ROWS)
    check(dev_only["K1"] and all(k == want for k in dev_only["K1"]),
          f"the device-only passes launched K1 {dev_only['K1']} times "
          f"(expected {want} each)")
    for r in launches["e2e"]:
        check(r["K1"] == 2 * -(-r["candidates"] // r["batch_rows"]),
              f"an e2e pass launched K1 {r['K1']} times for "
              f"{r['candidates']} candidates")
    for r in launches["polish"]:
        check(r["K2"] == 38 * -(-r["sequences"] // r["batch_rows"]),
              f"a polish pass launched K2 {r['K2']} times for "
              f"{r['sequences']} sequences")
    train = launches["train"]
    check(train["K3"] == train["K4"] == 2 * train["steps"],
          f"the train steps launched K3 {train['K3']} and K4 {train['K4']} "
          f"times in {train['steps']} steps (expected 2 each per step)")
    print(f"bench on the card at {BENCH_MBP} Mbp: headline "
          f"{json.dumps(head)}; launches {json.dumps(launches)}; the "
          f"phase took {wall:.1f}s", flush=True)
    return {"K1": {"device_only": dev_only["K1"],
                   "e2e": [r["K1"] for r in launches["e2e"]]},
            "K2": [r["K2"] for r in launches["polish"]],
            "K3": train["K3"], "K4": train["K4"]}


# -------------------------------------------------------------- phase 22
def phase_profile_stream(work_dir):
    """The port's host profiler (pepper_tpu_torch/utils/profile_stream.py)
    on the card's machine at 1 Mbp, one run per variant, on phase 21's
    dataset: it must exit 0, print its three variants and put the
    runner's submit back (it exits through its own checks otherwise)."""
    t = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.profile_stream",
         "--mbp", str(BENCH_MBP), "--reps", "1", "--device", "cuda",
         "--cache-dir", os.path.join(work_dir, "bench")],
        cwd=ROOT, env=_bench_env(), capture_output=True, text=True,
        timeout=300)
    wall = time.time() - t
    check(p.returncode == 0, f"profile_stream failed (exit "
          f"{p.returncode}): " + p.stderr[-4000:] + p.stdout[-2000:])
    out = p.stdout.strip().splitlines()
    for line in out:
        print("profile_stream: " + line, flush=True)
    for name in ("stream only (no stage3)",
                 "stream + collector (gates, no vcf)",
                 "stream + collector + ordered vcf"):
        check(any(line.startswith(name + ": stream=") for line in out),
              f"profile_stream printed no line for {name!r}")
    print(f"profile_stream on the card's machine at {BENCH_MBP} Mbp: the "
          f"phase took {wall:.1f}s", flush=True)


# -------------------------------------------------------------- phase 23
TRAINED_MBP = 1              # the classifier's training set, in Mbp
TRAINED_SEEDS = (41, 42, 43)  # its genome, variants and reads (the
                              # calling set is the bench's, seeds 1/2/3)
TRAINED_ROUND = 100          # train steps between evals
TRAINED_MIN_STEPS = 300
TRAINED_MAX_ROUNDS = 10
TRAINED_PATIENCE = 2         # rounds without a better accuracy that stop it
TRAINED_LR = 3e-4            # tests/test_e2e_model.py's


def planted_snp_recall(records, truth) -> float:
    """tests/test_e2e_model.py's measure: the share of the truth's SNPs at
    whose (contig, pos) a PASS record with a non-reference genotype
    stands."""
    from pepper_tpu_torch.io.vcf import read_vcf

    called = {(r.contig, r.pos) for r in records
              if "PASS" in r.filters and r.genotype() != [0, 0]}
    snps = [(r.contig, r.pos) for r in read_vcf(truth)
            if len(r.ref) == 1 and all(len(a) == 1 for a in r.alts)]
    return sum(site in called for site in snps) / max(1, len(snps))


def site_diff(a: dict, b: dict):
    """(sites in one of two {(contig, pos, ref, alts): GT} maps only,
    shared sites whose GT differs)."""
    only = len(a.keys() ^ b.keys())
    flips = sum(a[k] != b[k] for k in a.keys() & b.keys())
    return only, flips


def phase_trained_variant(dev, work_dir, name, bench_root):
    """The classifier trained by the port's train_loop on the card, then
    served by the port's call_variant CLI with that checkpoint on the card
    (bf16, f32) and the CPU (f32), on the bench's 1 Mbp dataset (phase
    21's, under `bench_root`), scored against its planted truth. Returns
    K1's launches (evals, each call on the card) and K3's and K4's (train
    steps)."""
    from pepper_tpu_torch.cli.pepper_variant_main import main as variant_cli
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.io.vcf import read_vcf
    from pepper_tpu_torch.models.checkpoint import load_checkpoint
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.runtime import streaming
    from pepper_tpu_torch.train import variant_train as vt
    from pepper_tpu_torch.train.dataloader import ShuffleBufferLoader
    from pepper_tpu_torch.utils import bench, streamstats
    from pepper_tpu_torch.utils.acceptance import evaluate

    t0 = time.time()
    train_dir = os.path.join(work_dir, "train_set")
    cache, fasta, bam = bench.get_dataset(train_dir, TRAINED_MBP,
                                          TRAINED_SEEDS)
    x8, y = encode_labeled(train_dir, fasta, bam, cache + "/truth.vcf")
    held = np.random.default_rng(TRAINED_SEEDS[0]).random(len(x8)) < 0.1
    test = {"images": x8[held], "type_label": y[held]}
    loader = ShuffleBufferLoader.from_arrays(x8[~held], y[~held],
                                             TRAIN_BATCH)
    check(loader.n_examples // TRAIN_BATCH >= TRAINED_ROUND,
          f"too few labeled images for {TRAINED_ROUND}-step rounds: "
          f"{loader.n_examples}")
    print(f"trained-model training set: {TRAINED_MBP} Mbp, seeds "
          f"{TRAINED_SEEDS}, the bench's reads ({bench.COVERAGE}x, "
          f"{bench.READ_LEN} bp, error {bench.ERROR}), "
          f"{bench.planted_counts(TRAINED_MBP)} planted; {len(x8)} labeled "
          f"images (labels {np.bincount(y, minlength=3).tolist()}), "
          f"{loader.n_examples} to train, {int(held.sum())} held out "
          f"[{time.time() - t0:.1f}s]", flush=True)

    # the port's train_loop on the card in rounds of TRAINED_ROUND steps,
    # each resuming the last with its optimizer state, until the held-out
    # accuracy has not risen for TRAINED_PATIENCE rounds (and at least
    # TRAINED_MIN_STEPS steps)
    fl.launches = fl.train_fwd_launches = fl.train_bwd_launches = 0
    t = time.time()
    accuracies, models, last = [], [], None
    for r in range(TRAINED_MAX_ROUNDS):
        out = os.path.join(work_dir, f"round_{r}")
        vt.train_loop(loader, test, out, epoch_limit=1,
                      step_size=TRAINED_ROUND, lr=TRAINED_LR, seed=r,
                      device="cuda", retrain_model_path=last)
        last = os.path.join(out, f"PEPPER_VARIANT_STEP_{TRAINED_ROUND}.npz")
        accuracies.append(load_checkpoint(last)[1]["accuracy"])
        models.append(last)
        best = int(np.argmax(accuracies))
        if (len(accuracies) * TRAINED_ROUND >= TRAINED_MIN_STEPS
                and len(accuracies) - 1 - best >= TRAINED_PATIENCE):
            break
    train_wall = time.time() - t
    steps = len(accuracies) * TRAINED_ROUND
    evals = len(accuracies)
    eval_batches = -(-len(test["images"]) // 512)
    k1_evals, k3, k4 = (fl.launches, fl.train_fwd_launches,
                        fl.train_bwd_launches)
    check(k3 == k4 == 2 * steps, f"{steps} train steps launched K3 {k3} "
          f"and K4 {k4} times (expected {2 * steps} each)")
    check(k1_evals == 2 * eval_batches * evals,
          f"{evals} evals of {eval_batches} batches launched K1 {k1_evals} "
          f"times (expected {2 * eval_batches * evals})")
    model = models[int(np.argmax(accuracies))]
    print(f"trained-model training on {name}: {steps} steps at batch "
          f"{TRAIN_BATCH}, lr {TRAINED_LR:g}, in {train_wall:.2f}s wall; "
          f"held-out accuracy by {TRAINED_ROUND} steps "
          f"{[round(a, 3) for a in accuracies]}; the best "
          f"({max(accuracies):.3f}%) serves; K3 {k3}, K4 {k4}, K1 {k1_evals} "
          f"(evals)", flush=True)

    # the calling set: phase 21's bench dataset, its planted truth
    cache, fasta, bam = bench.get_dataset(bench_root, BENCH_MBP)
    truth = cache + "/truth.vcf"
    with FastaReader(fasta) as fa:      # one contig at 1 Mbp
        (contig,) = fa.get_chromosome_names()
        region = f"{contig}:1-{fa.get_chromosome_sequence_length(contig)}"
    stream_totals = []
    real_stream = streaming.stream_inference

    def counted_stream(*args, **kwargs):
        stream_totals.append(real_stream(*args, **kwargs))
        return stream_totals[-1]

    def call(label, model_path, device, precision):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        out = os.path.join(work_dir, label) + "/"
        fl.launches = 0
        t = time.time()
        rc = variant_cli(["call_variant", "-b", bam, "-f", fasta, "-m",
                          model_path, "-o", out, "-t", str(os.cpu_count()),
                          "--ont_r9_guppy5_sup", "--device", device])
        wall = time.time() - t
        check(rc in (0, None), f"call_variant {label} exited {rc}")
        full = out + "PEPPER_VARIANT_FULL.vcf.gz"
        recs = read_vcf(full)
        seconds = streamstats.CURRENT.seconds
        return {"wall": wall, "K1": fl.launches,
                "candidates": stream_totals[-1],
                "sites": {(r.contig, r.pos, r.ref, tuple(r.alts)):
                          tuple(sorted(r.genotype())) for r in recs},
                "ap": {(r.contig, r.pos, r.ref, tuple(r.alts)):
                       dict(zip(r.format, r.samples[0])).get("AP")
                       for r in recs},
                "pass": sum("PASS" in r.filters for r in recs),
                "recall": planted_snp_recall(recs, truth),
                "report": evaluate(full, truth, None, region=region),
                "gates": seconds.get("gates", 0.0),
                "vcf_emit": seconds.get("vcf_emit", 0.0)}

    streaming.stream_inference = counted_stream
    try:
        runs = {"cuda bf16": call("trained_bf16", model, "cuda", "bf16"),
                "cuda f32": call("trained_f32", model, "cuda", "f32"),
                "cpu f32": call("trained_cpu", model, "cpu", "f32"),
                "random cuda bf16": call("random_bf16",
                                         bench.make_model(cache), "cuda",
                                         "bf16")}
    finally:
        streaming.stream_inference = real_stream
        os.environ.pop("PEPPER_TPU_PRECISION", None)
    for label, r in runs.items():
        rep = r["report"]
        print(f"trained-model call_variant {label} on the bench's "
              f"{BENCH_MBP} Mbp: {r['candidates']} candidates, "
              f"{len(r['sites'])} records ({r['pass']} PASS), wall "
              f"{r['wall']:.2f}s, K1 {r['K1']}; stream gates "
              f"{r['gates']:.2f} and vcf_emit {r['vcf_emit']:.2f} core-s; "
              f"planted-SNP recall {r['recall']:.4f}; SNP P/R/F1 "
              f"{rep['SNP']['precision']}/{rep['SNP']['recall']}/"
              f"{rep['SNP']['f1']}, INDEL P/R/F1 "
              f"{rep['INDEL']['precision']}/{rep['INDEL']['recall']}/"
              f"{rep['INDEL']['f1']}", flush=True)
    bf16, f32, cpu = runs["cuda bf16"], runs["cuda f32"], runs["cpu f32"]
    only, flips = site_diff(bf16["sites"], f32["sites"])
    share = (only + flips) / max(1, len(f32["sites"]))
    f1_gap = {k: abs(bf16["report"][k]["f1"] - f32["report"][k]["f1"])
              for k in ("SNP", "INDEL")}
    flipped = sorted(k for k in bf16["sites"].keys() & f32["sites"].keys()
                     if bf16["sites"][k] != f32["sites"][k])
    cpu_only, cpu_flips = site_diff(f32["sites"], cpu["sites"])
    print(f"trained-model records (contig, pos, ref, alt, GT): bf16 against "
          f"f32 on the card: {only} gained or lost, {flips} genotype flips "
          f"of {len(f32['sites'])} ({100 * share:.4f}%; bar 0.5%, none "
          f"gained or lost), F1 gaps SNP {f1_gap['SNP']:.6f} INDEL "
          f"{f1_gap['INDEL']:.6f} (bar 0.01); cuda f32 against cpu f32: "
          f"{cpu_only} gained or lost, {cpu_flips} flips (bar 0); the "
          f"first flips (site, bf16 GT and AP, f32 GT and AP): "
          + str([(k, bf16["sites"][k], bf16["ap"][k], f32["sites"][k],
                  f32["ap"][k]) for k in flipped[:5]]), flush=True)
    for label in ("cuda bf16", "cuda f32"):
        r = runs[label]
        check(r["recall"] >= 0.6, f"{label}: planted-SNP recall "
              f"{r['recall']:.4f} under the JAX contract's 0.6")
    for label in ("cuda bf16", "cuda f32", "random cuda bf16"):
        r = runs[label]
        want = 2 * -(-r["candidates"] // SHARD_ROWS)
        check(r["K1"] == want, f"call_variant {label} launched K1 "
              f"{r['K1']} times for {r['candidates']} candidates (expected "
              f"{want})")
    check(cpu["K1"] == 0, "the CPU run launched K1")
    check(cpu_only == 0 and cpu_flips == 0,
          "cuda f32 and cpu f32 call different records")
    check(only == 0 and share <= 0.005 and max(f1_gap.values()) <= 0.01,
          "bf16 against f32 with trained weights breaks its bar")
    return ({"evals": k1_evals, "call_variant_bf16": bf16["K1"],
             "call_variant_f32": f32["K1"]}, k3, k4)


# -------------------------------------------------------------- phase 24
POLISH_TRAINED_BP = 100_000
POLISH_TRAINED_SEEDS = (131, 132, 133)
POLISH_TRAINED_EDITS = (60, 25, 25)   # tests/test_polish.py's 12/5/5 per 20 kb
POLISH_TRAINED_BATCH = 32
POLISH_TRAINED_EPOCHS = 1
POLISH_TRAINED_LR = 1e-3


def polish_scores(fasta_text, genome, edits) -> dict:
    """tests/test_polish.py's measures of a one-contig polished FASTA
    against the truth (the draft with its planted edits applied): length
    ratio, 21-mer identity, planted corrections recovered (each one's truth
    context present, among those absent from the draft)."""
    from pepper_tpu_torch.utils.synth import _apply_haplotype

    polished = "".join(ln for ln in fasta_text.splitlines()
                       if not ln.startswith(">"))
    draft = genome[0][1]
    true_seq, _ = _apply_haplotype(draft, edits, 0)
    k = 21
    truth_kmers = {true_seq[i:i + k] for i in range(len(true_seq) - k)}
    kmers = {polished[i:i + k] for i in range(len(polished) - k)}
    contexts, shift = [], 0
    for v in edits:
        tpos = v.pos + shift
        contexts.append(true_seq[max(0, tpos - 15):tpos + len(v.alt) + 15])
        shift += len(v.alt) - len(v.ref)
    checked = [c for c in contexts if c not in draft]
    return {"length": len(polished) / len(true_seq),
            "identity": len(truth_kmers & kmers) / len(truth_kmers),
            "recovered": sum(c in polished for c in checked)
            / max(1, len(checked)), "checked": len(checked),
            "bases": len(polished)}


def phase_trained_polish(dev, work_dir, name):
    """The polish model trained by the port's train_polish_loop on the
    card, then the port's polish CLI with that checkpoint on the card
    (bf16, f32) and the CPU (f32), scored against the planted truth.
    Returns K2's launches (evals, each polish on the card)."""
    from pepper_tpu_torch.cli.pepper_main import main as polish_cli
    from pepper_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    params_from_jax)
    from pepper_tpu_torch.ops import fused_gru as fg
    from pepper_tpu_torch.train import polish_train as pt

    t0 = time.time()
    data = polish_draft(work_dir, POLISH_TRAINED_BP, POLISH_TRAINED_SEEDS,
                        POLISH_TRAINED_EDITS)
    x8, y8, n_edits = polish_training_images(work_dir, data)
    n = len(x8)
    print(f"trained-polish draft: {POLISH_TRAINED_BP} bp, seeds "
          f"{POLISH_TRAINED_SEEDS}, {n_edits} planted corrections, 10 kb "
          f"reads at coverage 30, a truth-to-draft BAM; {n} labeled "
          f"sequences [{time.time() - t0:.1f}s]", flush=True)

    fg.launches = 0
    t = time.time()
    model = pt.train_polish_loop(
        (x8, y8), (x8, y8), os.path.join(work_dir, "models"),
        batch_size=POLISH_TRAINED_BATCH, epoch_limit=POLISH_TRAINED_EPOCHS,
        lr=POLISH_TRAINED_LR, seed=7, device="cuda")
    train_wall = time.time() - t
    windows = len(range(0, 1000 - WINDOW + 1, 50))
    steps = POLISH_TRAINED_EPOCHS * (n // POLISH_TRAINED_BATCH) * windows
    k2_evals = fg.launches
    want = POLISH_TRAINED_EPOCHS * 2 * windows * -(-n // TRAIN_BATCH)
    check(k2_evals == want, f"the polish trainer's evals launched K2 "
          f"{k2_evals} times (expected {want})")
    params, meta = load_checkpoint(model)
    print(f"trained-polish training on {name}: {steps} window steps at "
          f"batch {POLISH_TRAINED_BATCH}, lr {POLISH_TRAINED_LR:g}, in "
          f"{train_wall:.2f}s wall; accuracy {meta['accuracy']:.3f}%; K2 "
          f"{k2_evals} (evals)", flush=True)

    def run(label, device, precision):
        os.environ["PEPPER_TPU_PRECISION"] = precision
        out = os.path.join(work_dir, label) + "/"
        fg.launches = 0
        t = time.time()
        rc, n_batches, recs = recorded_polish(lambda: polish_cli([
            "polish", "-b", data["bam"], "-f", data["draft"], "-m", model,
            "-o", out, "-t", str(os.cpu_count()), "--no_realignment",
            "--device", device]), device)
        wall = time.time() - t
        check(rc in (0, None), f"polish {label} exited {rc}")
        fasta = glob.glob(out + "*.fa")
        check(len(fasta) == 1, f"polish {label} wrote {fasta}")
        with open(fasta[0]) as fh:
            text = fh.read()
        return {"wall": wall, "K2": fg.launches, "batches": n_batches,
                "recs": recs, "text": text,
                **polish_scores(text, data["genome"], data["edits"])}

    try:
        runs = {"cuda bf16": run("bf16", "cuda", "bf16"),
                "cuda f32": run("f32", "cuda", "f32"),
                "cpu f32": run("cpu", "cpu", "f32")}
    finally:
        os.environ.pop("PEPPER_TPU_PRECISION", None)
    for label, r in runs.items():
        print(f"trained-polish polish {label}: {len(r['recs'])} sequences "
              f"in {r['batches']} batches, wall {r['wall']:.2f}s, K2 "
              f"{r['K2']}; length ratio {r['length']:.6f}, 21-mer identity "
              f"{r['identity']:.6f}, corrections recovered "
              f"{r['recovered']:.4f} of {r['checked']}", flush=True)
    bf16, f32, cpu = runs["cuda bf16"], runs["cuda f32"], runs["cpu f32"]
    diff_bf16 = polish_label_diffs(bf16["recs"], f32["recs"])
    diff_cpu = polish_label_diffs(f32["recs"], cpu["recs"],
                                  params_from_jax(params))
    low = [d for d in diff_cpu if d[3] < 1e-4]
    share = len(diff_bf16) / max(1, f32["bases"])
    print(f"trained-polish bases: bf16 against f32 on the card differ at "
          f"{len(diff_bf16)} of {f32['bases']} ({100 * share:.4f}%; bar "
          f"0.05%), identity gap {abs(bf16['identity'] - f32['identity']):.6f}"
          f" (bar 0.001); cuda f32 against cpu f32 at {len(diff_cpu)}, all "
          f"at a cpu vote margin under 1e-4: {len(low) == len(diff_cpu)} "
          f"{diff_cpu[:10]}; FASTA identical: {f32['text'] == cpu['text']}",
          flush=True)
    for label in ("cuda bf16", "cuda f32"):
        r = runs[label]
        check(r["length"] > 0.95 and r["identity"] > 0.95
              and r["recovered"] >= 0.7 and r["checked"] >= 10,
              f"{label}: the trained polish misses the JAX contract "
              f"(length > 0.95, identity > 0.95, recovered >= 0.7)")
        check(r["K2"] == 38 * r["batches"], f"polish {label} launched K2 "
              f"{r['K2']} times for {r['batches']} batches (expected 38 "
              f"each)")
    check(cpu["K2"] == 0, "the CPU polish launched K2")
    check(len(low) == len(diff_cpu), "cuda f32 consensus differs from cpu "
          "f32 where the cpu vote margin exceeds 1e-4")
    check(diff_cpu or f32["text"] == cpu["text"], "cuda f32 and cpu f32 "
          "polished FASTAs differ although every base label agrees")
    check(share <= 5e-4 and abs(bf16["identity"] - f32["identity"]) <= 1e-3,
          "bf16 against f32 with trained weights breaks its bar")
    return {"evals": k2_evals, "polish_bf16": bf16["K2"],
            "polish_f32": f32["K2"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pepper_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({exc}); run it from the root of a checkout",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    env = phase_environment()
    k1 = phase_kernel(dev)
    k2 = phase_k2(dev)
    phase_model(dev)
    phase_polish_model(dev)
    k3, k4 = phase_train_kernels(dev)
    phase_train_step(dev)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_",
                                dir=os.path.join(ROOT, "build"))
    for sub in ("variant", "polish", "train", "hp", "polish_train", "trained",
                "trained_polish"):
        os.makedirs(os.path.join(work_dir, sub))
    try:
        k1["launches"], variant_run = phase_end_to_end(
            dev, os.path.join(work_dir, "variant"), env["card"])
        k2["launches"], polish_data = phase_polish_end_to_end(
            dev, os.path.join(work_dir, "polish"), env["card"])
        k1["launches_trainer_evals"], k3["launches"], k4["launches"] = \
            phase_trainer(dev, os.path.join(work_dir, "train"), env["card"])
        k1["launches_hp"], hp_data = phase_hp_end_to_end(
            dev, os.path.join(work_dir, "hp"), env["card"])
        k2["launches_polish_trainer_evals"] = phase_polish_trainer(
            dev, os.path.join(work_dir, "polish_train"), env["card"])
        k1["launches_mesh"], k2["launches_mesh"] = \
            phase_sharded_inference(dev)
        phase_two_hosts(dev, work_dir, variant_run)
        ddp = phase_two_ranks(dev, work_dir)
        k3["launches_ddp"] = [r[0] for r in ddp]
        k4["launches_ddp"] = [r[1] for r in ddp]
        phase_dryrun(dev)
        phase_alternates(dev, env["card"])
        k2["launches_hp_legacy"] = phase_hp_legacy(dev, env["card"], hp_data)
        k1["launches_scale"] = phase_scale_rehearsal(work_dir)
        k2["launches_polish_resume"] = phase_polish_resume(work_dir,
                                                           polish_data)
        bench = phase_bench(work_dir)
        (k1["launches_bench"], k2["launches_bench"], k3["launches_bench"],
         k4["launches_bench"]) = (bench[k] for k in ("K1", "K2", "K3", "K4"))
        phase_profile_stream(work_dir)
        k1["launches_trained"], k3["launches_trained"], \
            k4["launches_trained"] = phase_trained_variant(
                dev, os.path.join(work_dir, "trained"), env["card"],
                os.path.join(work_dir, "bench"))
        k2["launches_trained"] = phase_trained_polish(
            dev, os.path.join(work_dir, "trained_polish"), env["card"])
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
