"""Benchmark of the port: variant calling end to end, polish, the train
step and the realigner.

    python -m pepper_tpu_torch.utils.bench [--mbp 10] [--runs 3]
        [--device cuda] [--cache-dir build/bench] [--polish-kb 300]
        [--train-batch 512] [--train-iters 60]

The counterpart of the JAX package's root `bench.py`, stage by stage.
Primary metric (the headline, the last line of stdout): end-to-end
`call_variant` Mbp/s of the streamed three-stage pipeline on synthetic
ONT-like data (`--mbp` Mbp over max(1, min(5, int(mbp))) contigs, 35x
coverage, 10 kb reads, 8% error; the median of `--runs` runs after a warm
pass) with its resume journal on, the model forward on `--device`,
candidate gates and the native 5-file VCF sink running behind it:

    {"metric": "variant_e2e_throughput", "value", "unit": "Mbp/s",
     "vs_baseline"}

Baseline (vs_baseline): the reference's deployment on this host, N caller
processes each running 1-thread CPU RNN inference over the same
multi-threaded host encode, plus the same stage-3 cost; the 1-thread torch
time is scaled by the host's core count.

Also reported (stderr, each time beside where it ran: the card's name and
power limit as nvidia-smi gives them, or "cpu"): the encode
thread-scaling curve; device-only inference windows/s and its share of
the card's dense peak for the runner's dtype; the stream's breakdown by
component with the card's busy time (summed batch spans, CUDA events) and
idle share; post-hoc stage 3 and a stage breakdown; polish Mbp/s on a
`--polish-kb` kb draft; ms per train step at `--train-batch`; realigner
reads/s; and one line `kernel launches per stage: {json}` with the
launches of K1 (device-only passes, e2e passes), K2 (polish passes), K3
and K4 (train steps), read from ops/fused_lstm.py's and ops/fused_gru.py's
counters, beside the candidates, sequences and steps they served.

Where it differs from the JAX bench:

  - weights: the full-width classifier and polish model drawn from numpy
    seeds (models/variant_model.py::numpy_variant_params(0),
    models/polish_model.py::numpy_polish_params(1)) and saved as .npz
    (`make_model` keeps a file that is already there). The JAX bench's
    init_*_params(PRNGKey) cannot be reproduced in torch.
  - device-only: the streamed runner's forward (runtime/streaming.py::
    DeviceRunner at stream_batch_rows: 16384 rows in bf16 on the card,
    4096 in f32 on the CPU) where the JAX bench jitted a 4096-row forward.
    FLOPs per window are counted from the model's weight shapes (XLA's
    cost_analysis has no counterpart) and set against the H100's dense
    peak for the runner's dtype (989 TFLOP/s bf16, 67 TFLOP/s f32), not a
    v5e's; on the CPU no share is printed.
  - post-hoc stage 3 and the stage breakdown read the median e2e run's
    batches from its own resume journal (runtime/resume.py) before it is
    deleted, and time batch_candidates plus finalize_candidates over them:
    the work process_candidates does over the HDF5 prediction store, which
    the stream does not write where h5py is missing (the card's machine).
    The same route runs on every machine.
  - the train step is train/variant_train.py::make_train_step in f32 with
    dropout from a device generator; it stages its int8 batch from the
    host on every call, as the trainer does, and is timed up to a
    synchronize after the last update of the parameters.
  - the 1-thread torch baselines use stand-ins of the reference
    architecture built from stock torch layers, kept in this module; the
    process's torch thread count is restored after each.
  - the dataset and weights are cached under `--cache-dir` (default
    build/bench/ under the current directory), not /tmp. The environment
    knobs PEPPER_BENCH_MBP and PEPPER_BENCH_RUNS are the flags `--mbp` and
    `--runs`; `--polish-kb`, `--train-batch` and `--train-iters` (defaults:
    the JAX sizes) let a test run it small.
  - planted variants: int(800 * mbp) SNPs and int(100 * mbp) insertions
    and deletions, which is the JAX bench's 800 * int(mbp) at whole Mbp
    (the 10 and 1 Mbp datasets are its own) and keeps the rates at
    fractional Mbp, where the JAX bench plants none.
  - a failing stage ends the run with a non-zero exit; the JAX bench
    logged the failure of the breakdown, polish, train and realigner
    stages and carried on.
  - left out: the HG002 acceptance step (`bench.py:553-577`), which
    downloads the quickstart data; it waits until those data are in the
    repository.

`--device cuda` (the default) with no card raises before anything is
built.
"""
import argparse
import hashlib
import json
import os
import shutil
import sys
import time
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

COVERAGE = 35
READ_LEN = 10_000
ERROR = 0.08
BATCH = 512            # the 1-thread torch baseline's batch
VARIANT_MODEL_SEED = 0
POLISH_MODEL_SEED = 1
# dense peaks of one H100 SXM by the runner's dtype (NVIDIA's data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(msg: str) -> None:
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def one_torch_thread():
    """1-thread torch for a reference-style baseline; the thread count is
    the process's, so it is restored after (the later stages and the host
    side of the card run use the default)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def n_contigs(mbp: float) -> int:
    return max(1, min(5, int(mbp)))


def planted_counts(mbp: float):
    """(SNPs, insertions, deletions) planted in an `mbp` Mbp genome."""
    return int(800 * mbp), int(100 * mbp), int(100 * mbp)


def get_dataset(cache_root: str, mbp: float, seeds=(1, 2, 3)):
    """(cache dir, fasta, bam) of the bench's genome, built once per key.
    `seeds` are the genome's, the planted variants' and the reads'; the
    cache also holds the planted variants as `truth.vcf`."""
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads_fast,
                                              write_dataset, write_truth_vcf)

    contigs = n_contigs(mbp)
    genome_seed, variant_seed, read_seed = seeds
    key = hashlib.md5(f"{mbp}-{contigs}-{COVERAGE}-{READ_LEN}-{ERROR}-"
                      f"{genome_seed}-{variant_seed}-{read_seed}-v3"
                      .encode()).hexdigest()[:10]
    cache = os.path.join(cache_root, f"pepper_bench_{key}")
    fasta, bam = cache + "/ref.fa", cache + "/reads.bam"
    # the .bai and .fai are written last: a build that was cut has neither
    if not (os.path.isfile(bam + ".bai") and os.path.isfile(fasta + ".fai")):
        os.makedirs(cache, exist_ok=True)
        t0 = time.time()
        genome = random_genome(int(mbp * 1e6 / contigs), seed=genome_seed,
                               n_contigs=contigs)
        variants = plant_variants(dict(genome), *planted_counts(mbp),
                                  seed=variant_seed)
        records = simulate_reads_fast(genome, variants, coverage=COVERAGE,
                                      read_length=READ_LEN, error_rate=ERROR,
                                      seed=read_seed)
        write_truth_vcf(cache + "/truth.vcf", genome, variants)
        write_dataset(cache, genome, records)
        log(f"dataset built in {time.time() - t0:.1f}s ({len(records)} "
            f"reads)")
    return cache, fasta, bam


def bench_config(fasta, bam, threads, device="cuda"):
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.presets import set_parameters
    return set_parameters(PipelineConfig(
        bam=bam, fasta=fasta, sub_command="call_variant",
        ont_r9_guppy5_sup=True, threads=threads, device=str(device)))


def encode_all(fasta_path, bam_path, n_threads):
    """Host stage alone: the pipeline's own region encode over every 100 kb
    region; returns the candidate images (int8 [N, 33, 26]). Used for the
    thread-scaling curve, the device-only stage and the torch baseline."""
    from concurrent.futures import ThreadPoolExecutor

    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.pipelines.datastore import stack_images
    from pepper_tpu_torch.pipelines.make_images import create_region_summary

    config = bench_config(fasta_path, bam_path, n_threads)
    with FastaReader(fasta_path) as fa:
        regions = []
        for contig in fa.get_chromosome_names():
            length = fa.get_chromosome_sequence_length(contig)
            regions += [(contig, s, min(s + 100_000, length) - 1)
                        for s in range(0, length, 100_000)]

    def one(region):
        contig, start, end = region
        with BamReader(bam_path) as bam, FastaReader(fasta_path) as fa:
            return create_region_summary(config, bam, fa, contig, start, end)

    with ThreadPoolExecutor(n_threads) as pool:
        results = list(pool.map(one, regions))
    batches = [stack_images(r) for r in results if r]
    return (np.concatenate(batches).astype(np.int8) if batches
            else np.zeros((0, 33, 26), np.int8))


def make_model(cache: str) -> str:
    """The classifier's .npz under `cache` (an existing file is kept)."""
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    path = cache + "/bench_model.npz"
    if not os.path.isfile(path):
        save_checkpoint(path, numpy_variant_params(VARIANT_MODEL_SEED), {})
    return path


def stream_runner(config):
    """The streamed call_variant's (cached) DeviceRunner for `config`."""
    from pepper_tpu_torch.runtime.streaming import (get_device_runner,
                                                    resolve_device,
                                                    stream_batch_rows)
    dev = resolve_device(config.device)
    return get_device_runner(config.model_path,
                             stream_batch_rows(config.batch_size, dev), dev)


class E2ERun(NamedTuple):
    t_stream: float
    t_tail: float
    candidates: int
    stats: object           # utils/streamstats.py::StreamStats of the run
    k1_launches: int
    journal: str            # where its resume journal was kept, or ""
    intervals: list


def bench_e2e(cache, fasta, bam, n_threads, device, keep_journal=""):
    """Full call_variant: streamed encode+inference with stage-3 gates and
    ordered VCF emission running behind the device (the production
    single-host path) and its resume journal on; the tail is the final
    flush and the files' close. The journal is deleted in the tail, or
    moved to `keep_journal` when that is given."""
    from pepper_tpu_torch.ops import fused_lstm
    from pepper_tpu_torch.pipelines.find_candidates import (
        StreamingCandidateCollector, make_ordered_emitter)
    from pepper_tpu_torch.pipelines.make_images import build_intervals
    from pepper_tpu_torch.runtime.streaming import stream_inference
    from pepper_tpu_torch.utils import streamstats

    config = bench_config(fasta, bam, n_threads, device)
    config.model_path = make_model(cache)
    intervals = build_intervals(config)
    intervals.sort(key=lambda iv: (iv[0], iv[1]))

    out = cache + "/e2e_out"
    shutil.rmtree(out, ignore_errors=True)
    pred_dir = out + "/preds/"
    os.makedirs(pred_dir)
    pred_path = pred_dir + "pepper_predictions.hdf"
    fused_lstm.launches = 0
    streamstats.reset()   # one accounting epoch per run
    t0 = time.time()
    emitter = make_ordered_emitter(config, out + "/", intervals)
    collector = StreamingCandidateCollector(config, emitter)
    # the resume journal is on in production call_variant: its cost is in
    # the headline number
    journal = out + "/resume.journal"
    n = stream_inference(config, intervals, pred_path,
                         candidate_collector=collector,
                         resume_journal=journal)
    t_stream = time.time() - t0
    t0 = time.time()
    collector.finish()
    emitter.finish()
    if keep_journal:
        os.replace(journal, keep_journal)
    else:
        os.remove(journal)
    t_tail = time.time() - t0
    return E2ERun(t_stream, t_tail, n, streamstats.CURRENT,
                  fused_lstm.launches, keep_journal, intervals)


def journal_batches(journal: str, config, intervals) -> list:
    """The ("batch", contigs, positions, depths, candidates, frequencies,
    probabilities, runs) records of a streamed run's resume journal, in
    flush order."""
    from pepper_tpu_torch.runtime.resume import load_journal, run_setting

    runner = stream_runner(config)
    loaded = load_journal(journal, intervals, config.model_path,
                          (config.bam, config.fasta),
                          run_setting(runner.dtype, len(runner.mesh)))
    if loaded is None:
        raise RuntimeError(f"the resume journal {journal} does not belong "
                           f"to this run")
    return [rec for rec in loaded[1] if rec[0] == "batch"]


def stage3(config, batches, vcf_dir: str):
    """Post-hoc stage 3 over prediction batches held in memory: the
    candidate gates (batch_candidates) over every batch, then the
    aggregation and the 5-VCF write (finalize_candidates) into `vcf_dir`.
    Returns (gates s, VCF s, margin candidates, DeepVariant candidates)."""
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.pipelines import find_candidates as fc

    t0 = time.time()
    with FastaReader(config.fasta) as fa:
        span = fc._ContigSpanCache(fa)
        margin, dv = [], []
        for _, contigs, positions, depths, cands, freqs, probs, _ in batches:
            fc.batch_candidates(config, span, contigs, positions, depths,
                                cands, fc._batch_freq_lists(freqs,
                                                            len(contigs)),
                                probs, margin, dv)
    t_gates = time.time() - t0
    t0 = time.time()
    shutil.rmtree(vcf_dir, ignore_errors=True)
    os.makedirs(vcf_dir)
    fc.finalize_candidates(config, vcf_dir, margin, dv, t0)
    return t_gates, time.time() - t0, len(margin), len(dv)


def forward_flops_per_window(tree, window: int) -> int:
    """Operations (2 per multiply-add) of the classifier's forward for one
    window, from its weight shapes: each biLSTM weight (W_ih and W_hh of
    both directions) is applied at each of the `window` steps, each Linear
    once. Elementwise work is not counted."""
    flops = 0
    for layer in tree.values():
        for name, w in layer.items():
            if name.startswith("weight"):
                uses = window if name.startswith(("weight_ih", "weight_hh")) \
                    else 1
                flops += 2 * int(np.prod(np.shape(w))) * uses
    return flops


def device_inference_only(images, runner, reps: int = 3):
    """Device-only throughput (the card's ceiling): the runner's forward
    over every window at its fixed batch, each batch copied to the device
    as int8 and its probabilities left there; `reps` passes after a
    one-batch warm-up, timed up to a synchronize. Returns (s per pass, K1
    launches of each pass)."""
    from pepper_tpu_torch.ops import fused_lstm

    rows = runner.batch
    x = images.astype(np.int8)
    pad = (-len(x)) % rows
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.int8)])

    def forward(lo):
        return runner.forward(torch.from_numpy(x[lo:lo + rows])
                              .to(runner.device))

    forward(0)
    sync(runner.device)
    launches = []
    t0 = time.time()
    for _ in range(reps):
        before = fused_lstm.launches
        outs = [forward(lo) for lo in range(0, len(x), rows)]
        sync(runner.device)
        launches.append(fused_lstm.launches - before)
    del outs
    return (time.time() - t0) / reps, launches


class TorchVariantModel(nn.Module):
    """The reference classifier's architecture in stock torch layers (a
    stand-in for a reference checkpoint: the 1-thread CPU baseline)."""

    def __init__(self, F=26, H=256, window=33, n_type=3):
        super().__init__()
        self.encoder = nn.LSTM(F, H, num_layers=1, bidirectional=True,
                               batch_first=True)
        self.decoder = nn.LSTM(2 * H, H, num_layers=1, bidirectional=True,
                               batch_first=True)
        self.linear_1 = nn.Linear(2 * H * window, 512)
        self.linear_2 = nn.Linear(512, 512)
        self.linear_3 = nn.Linear(512, 512)
        self.linear_4 = nn.Linear(512, 512)
        self.linear_5 = nn.Linear(512, 512)
        self.output_layer_type = nn.Linear(512, n_type)

    def forward(self, x):
        act = nn.SELU()
        x, _ = self.encoder(x)
        x, _ = self.decoder(x)
        x = torch.flatten(x, 1, 2)
        for lin in (self.linear_1, self.linear_2, self.linear_3,
                    self.linear_4, self.linear_5):
            x = act(lin(x))
        return torch.softmax(self.output_layer_type(x), dim=1)


class TorchPolishModel(nn.Module):
    """The reference polish model's architecture in stock torch layers
    (the 1-thread CPU polish baseline); hidden [B, 2, H] in and out."""

    def __init__(self, F=10, H=128, C=5):
        super().__init__()
        self.gru_encoder = nn.GRU(F, H, num_layers=1, bidirectional=True,
                                  batch_first=True)
        self.gru_decoder = nn.GRU(2 * H, H, num_layers=1, bidirectional=True,
                                  batch_first=True)
        self.dense1 = nn.Linear(2 * H, C)

    def forward(self, x, hidden):
        hidden = hidden.transpose(0, 1).contiguous()
        out, h = self.gru_encoder(x, hidden)
        out, h = self.gru_decoder(out, h)
        return self.dense1(out), h.transpose(0, 1).contiguous()


def torch_cpu_inference(images, batch: int = BATCH):
    """1-thread torch throughput, timed on a subset and scaled: the
    per-caller setup of the reference's CPU runtime. Returns seconds for
    all of `images`."""
    with one_torch_thread():
        model = TorchVariantModel().eval()
        subset = images[:min(4096, len(images))].astype(np.float32)
        pad = (-len(subset)) % batch
        x = np.concatenate([subset, np.zeros((pad,) + subset.shape[1:],
                                             np.float32)]) if pad else subset
        with torch.no_grad():
            model(torch.from_numpy(x[:batch]))  # warm-up
            dt = float("inf")
            for _ in range(2):   # best of 2: host steal would inflate the
                t0 = time.time()  # baseline (flattering the port) otherwise
                for lo in range(0, len(x), batch):
                    model(torch.from_numpy(x[lo:lo + batch]))
                dt = min(dt, time.time() - t0)
    return dt * len(images) / max(1, len(x))


class PolishRun(NamedTuple):
    mbps: float
    split: tuple            # (stream s, stitch tail s)
    sequences: int
    stats: object
    native: dict            # the native encoder's fetch/realign/pileup s
    k2_launches: int


def bench_polish(cache_root, n_threads, device, kb: int = 300):
    """Polish mode: make_images -> consensus -> stitch, streamed, on a
    `kb` kb draft with 30x reads and the resume journal on; returns Mbp/s
    through all three stages."""
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.polish_model import numpy_polish_params
    from pepper_tpu_torch.native import bamio
    from pepper_tpu_torch.ops import fused_gru
    from pepper_tpu_torch.polish.make_images import build_polish_intervals
    from pepper_tpu_torch.polish.stitch import StreamingStitcher
    from pepper_tpu_torch.polish.streaming import stream_polish
    from pepper_tpu_torch.utils import streamstats
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads_fast,
                                              write_dataset)

    size = kb * 1000
    cache = os.path.join(cache_root, f"pepper_bench_polish_{kb}kb_v2")
    if not os.path.isfile(cache + "/reads.bam.bai"):
        os.makedirs(cache, exist_ok=True)
        genome = random_genome(size, seed=11)    # the draft
        edits = plant_variants(dict(genome), 60, 15, 15, seed=12)
        edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1))
                 for v in edits]                 # draft errors are hom-alt
        records = simulate_reads_fast(genome, edits, coverage=30,
                                      read_length=8000, error_rate=0.06,
                                      seed=13)
        write_dataset(cache, genome, records)
    model = cache + "/polish_model.npz"
    if not os.path.isfile(model):
        save_checkpoint(model, numpy_polish_params(POLISH_MODEL_SEED), {})
    out = cache + "/out"
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    bamio.polish_prof()   # drain
    fused_gru.launches = 0
    t0 = time.time()
    pred_dir = out + "/preds"
    os.makedirs(pred_dir)
    intervals = build_polish_intervals(cache + "/ref.fa",
                                       cache + "/reads.bam", None)
    stitcher = StreamingStitcher(intervals,
                                 out + "/polished_pepper_polished.fa")
    journal = out + "/polish_resume.journal"   # production default is on
    n_seqs = stream_polish(cache + "/reads.bam", cache + "/ref.fa", model,
                           pred_dir + "/pepper_prediction_0.hdf",
                           threads=n_threads, stitcher=stitcher,
                           resume_journal=journal, device=device)
    t_stream = time.time() - t0
    t0 = time.time()
    stitcher.finish()   # the watermark already wrote all but the tail
    os.remove(journal)
    t_stitch = time.time() - t0
    nat = bamio.polish_prof() or {}
    return PolishRun(size / 1e6 / (t_stream + t_stitch), (t_stream, t_stitch),
                     n_seqs, streamstats.CURRENT, nat, fused_gru.launches)


def torch_polish_window_inference(n_seqs):
    """The reference's polish consensus per-caller cost: 1-thread torch,
    19 sliding windows with the hidden carried and a softmax vote per
    1000-long sequence, timed on a subset and scaled to all sequences."""
    with one_torch_thread():
        model = TorchPolishModel().eval()
        sample = max(1, min(n_seqs, 128))
        x = torch.rand(sample, 1000, 10)
        with torch.no_grad():
            model(x[:, :100], torch.zeros(sample, 2, 128))  # warm-up
            dt = float("inf")
            for _ in range(2):   # best of 2 (as the variant baseline)
                t0 = time.time()
                hidden = torch.zeros(sample, 2, 128)
                for s in range(0, 901, 50):
                    out, hidden = model(x[:, s:s + 100], hidden)
                    torch.nn.functional.softmax(out, dim=2)
                dt = min(dt, time.time() - t0)
    return dt * n_seqs / sample


def train_batch(bs: int):
    """The train stages' batch: int8 images [bs, 33, 26] and labels."""
    rng = np.random.RandomState(9)
    images = rng.randint(-125, 126, (bs, 33, 26)).astype(np.int8)
    return images, rng.randint(0, 3, bs)


def bench_train_step(device, bs: int = 512, iters: int = 60):
    """Variant-model training throughput: the port's fwd+bwd+Adam step in
    f32 on `device` (K3 and K4 twice a step on the card). Returns (s per
    step, steps run, K3 launches, K4 launches)."""
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    from pepper_tpu_torch.ops import fused_lstm
    from pepper_tpu_torch.runtime.streaming import resolve_device
    from pepper_tpu_torch.train.variant_train import (make_optimizer,
                                                      make_train_step,
                                                      trainable)

    dev = resolve_device(device)
    images, labels = train_batch(bs)
    params = trainable(numpy_variant_params(VARIANT_MODEL_SEED), dev)
    step = make_train_step(params, make_optimizer(params, lr=1e-4,
                                                  weight_decay=1e-6))
    gen = torch.Generator(device=dev).manual_seed(1)
    fused_lstm.train_fwd_launches = fused_lstm.train_bwd_launches = 0
    step(images, labels, gen)   # warm-up (the JAX bench's compile step)
    sync(dev)
    t0 = time.time()
    for _ in range(iters):
        step(images, labels, gen)
    sync(dev)   # the parameters' last update, not only the loss
    return ((time.time() - t0) / iters, iters + 1,
            fused_lstm.train_fwd_launches, fused_lstm.train_bwd_launches)


def torch_train_step(bs: int = 512):
    """The same step in torch on 1 CPU thread (the per-worker setup of the
    reference's trainer); returns s per step."""
    images, labels = train_batch(bs)
    with one_torch_thread():
        model = TorchVariantModel().train()
        optim = torch.optim.Adam(model.parameters(), lr=1e-4,
                                 weight_decay=1e-6)
        tx = torch.from_numpy(images.astype(np.float32))
        ty = torch.from_numpy(labels.astype(np.int64))
        ce = torch.nn.CrossEntropyLoss(reduction="sum")

        def step():
            # same tensor work as the reference's train loop (its model
            # returns logits in train mode; the softmax head here costs
            # the same)
            optim.zero_grad()
            loss = ce(model(tx), ty)
            loss.backward()
            optim.step()

        step()   # warm-up
        t0 = time.time()
        for _ in range(3):
            step()
        return (time.time() - t0) / 3


def bench_realigner():
    """The polish image-gen realignment hot path at reference-like load:
    1500 reads x 1 kb window."""
    from pepper_tpu_torch.io.bam_reader import TrimmedRead
    from pepper_tpu_torch.polish.realign import align_reads_to_reference
    from pepper_tpu_torch.utils.synth import random_genome

    rng = np.random.RandomState(5)
    ref = random_genome(1000, seed=5)[0][1]
    reads = []
    bases = "ACGT"
    for i in range(1500):
        lo = int(rng.randint(0, 500))
        hi = min(1000, lo + 400 + int(rng.randint(0, 200)))
        seq = list(ref[lo:hi])
        for j in range(len(seq)):  # ~6% errors
            if rng.rand() < 0.06:
                seq[j] = bases[rng.randint(4)]
        seq = "".join(seq)
        reads.append(TrimmedRead(
            query_name=f"r{i}", pos=lo, pos_end=lo + len(seq), sequence=seq,
            base_qualities=[20] * len(seq), cigar_tuples=[(0, len(seq))],
            mapping_quality=60, flags=0, hp_tag=0, bad_indices=[]))
    t0 = time.time()
    aligned = align_reads_to_reference(reads, ref, 0)
    dt = time.time() - t0
    return 1500 / dt, dt, len(aligned)


def main(argv=None) -> int:
    from pepper_tpu_torch.models.checkpoint import load_checkpoint
    from pepper_tpu_torch.runtime.streaming import resolve_device
    from pepper_tpu_torch.utils.scale_rehearsal import card_name

    ap = argparse.ArgumentParser(
        description="Benchmark of the port: streamed call_variant end to "
                    "end, device-only inference, polish, the train step "
                    "and the realigner.")
    ap.add_argument("--mbp", type=float, default=10.0,
                    help="genome size in Mbp (default 10)")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed e2e runs after the warm pass; the median "
                         "is the headline (default 3)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda; cuda "
                         "with no card raises)")
    ap.add_argument("--cache-dir", default=os.path.join("build", "bench"),
                    help="where the datasets, weights and runs are kept "
                         "(default build/bench under the current "
                         "directory)")
    ap.add_argument("--polish-kb", type=int, default=300,
                    help="polish draft length in kb (default 300)")
    ap.add_argument("--train-batch", type=int, default=512)
    ap.add_argument("--train-iters", type=int, default=60)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    where = f"[{card_name() if dev.type == 'cuda' else 'cpu'}]"
    mbp = args.mbp
    cache, fasta, bam = get_dataset(os.path.abspath(args.cache_dir), mbp)
    launches = {}

    # ---- encode thread-scaling curve (and warm the page cache) ----------
    ncpu = os.cpu_count() or 2
    encode_all(fasta, bam, ncpu)   # warm-up
    curve = {}
    for t in sorted({1, 2, ncpu} | ({4} if ncpu >= 4 else set())):
        best = float("inf")
        for _ in range(3):   # best of 3: host steal spikes are 2-5x
            t0 = time.time()
            images = encode_all(fasta, bam, t)
            best = min(best, time.time() - t0)
        curve[t] = best
    t_host = curve[ncpu]
    log("encode scaling: " + ", ".join(
        f"{t}th={curve[t]:.2f}s" for t in sorted(curve)) + f" {where}")
    log(f"host fetch+encode ({ncpu} threads): {t_host:.2f}s, "
        f"{len(images)} candidate windows; per-core encode cost "
        f"{curve[1] / mbp:.3f} core-s/Mbp {where}")

    # ---- device ceiling --------------------------------------------------
    config = bench_config(fasta, bam, ncpu, dev)
    config.model_path = make_model(cache)
    runner = stream_runner(config)
    t_dev, dev_launches = device_inference_only(images, runner)
    windows_s = len(images) / max(t_dev, 1e-9)
    launches["device_only"] = {"candidates": len(images),
                               "batch_rows": runner.batch,
                               "K1": dev_launches}
    log(f"device inference ({runner.device}, {runner.dtype}, "
        f"{runner.batch}-row batches): {t_dev:.3f}s ({windows_s:.0f} "
        f"windows/s) {where}")
    if dev.type == "cuda":
        tree, _ = load_checkpoint(config.model_path)
        flops_w = forward_flops_per_window(tree, images.shape[1])
        peak = PEAK_FLOPS[runner.dtype]
        log(f"card utilization: {flops_w / 1e6:.1f} MFLOP/window x "
            f"{windows_s:.0f}/s = {100 * windows_s * flops_w / peak:.2f}% "
            f"of the H100's dense {runner.dtype} peak "
            f"({peak / 1e12:.0f} TFLOP/s) {where}")

    # ---- full pipeline, streamed (warm pass then median of --runs) ------
    warm = bench_e2e(cache, fasta, bam, ncpu, dev)
    passes = [warm]
    runs = []
    for i in range(args.runs):
        passes.append(bench_e2e(cache, fasta, bam, ncpu, dev,
                                keep_journal=f"{cache}/e2e_journal_{i}"))
        runs.append(passes[-1])
    launches["e2e"] = [{"candidates": r.candidates, "batch_rows":
                        runner.batch, "K1": r.k1_launches} for r in passes]
    by_total = sorted(runs, key=lambda r: r.t_stream + r.t_tail)
    median = by_total[len(runs) // 2]
    t_stream, t_tail, stats = median.t_stream, median.t_tail, median.stats
    t_e2e = t_stream + t_tail
    ours = mbp / t_e2e
    spread = ((by_total[-1].t_stream + by_total[-1].t_tail)
              - (by_total[0].t_stream + by_total[0].t_tail))
    log(f"e2e call_variant (streamed 3-stage, median of {args.runs}, "
        f"spread {spread:.2f}s): {t_e2e:.2f}s = stream+gates+vcf "
        f"{t_stream:.2f}s + tail {t_tail:.2f}s ({median.candidates} "
        f"candidates) -> {ours:.3f} Mbp/s {where}")
    log(f"full-pipeline cost over pure encode: "
        f"{100 * (t_stream / t_host - 1):.0f}% - the stream carries "
        f"stages 2+3 (inference, gates, VCF write, resume journal) behind "
        f"the encode; device work hidden: {t_dev:.3f}s {where}")
    log(f"stream breakdown (core-seconds, median run; wall ~= "
        f"total/{ncpu}): {stats.summary()} | TOTAL {stats.total():.2f}s "
        f"(vs e2e wall {t_e2e:.2f}s x {ncpu} cores = "
        f"{t_e2e * ncpu:.2f} core-s) {where}")
    busy = stats.seconds.get("(device)")
    if busy is None:
        log("card busy in the stream: not measured (no card)")
    else:
        log(f"card busy in the stream (summed batch spans, CUDA events): "
            f"{busy:.3f}s of {t_stream:.2f}s, idle share "
            f"{1 - busy / t_stream:.4f} {where}")

    # ---- reference-style baseline on this host ---------------------------
    # the reference runs stage 3 post hoc over the predictions: time that
    # serial pass over the median run's batches, read from its journal
    batches = journal_batches(median.journal, config, median.intervals)
    for r in runs:
        os.remove(r.journal)
    t_gates, t_vcf, _, _ = stage3(config, batches,
                                  cache + "/e2e_out/posthoc/")
    del batches
    t_stage3_posthoc = t_gates + t_vcf
    log(f"post-hoc stage 3 (reference staging): {t_stage3_posthoc:.2f}s "
        f"{where}")
    log(f"stage breakdown (components timed standalone at {mbp:g} Mbp; "
        f"encode is the {ncpu}-thread wall time, gates+vcf the Python "
        f"tuple engine's serial wall - the streamed e2e uses the columnar "
        f"native sink instead, measured in the stream breakdown above): "
        f"encode {t_host:.2f}s | device {t_dev:.2f}s | gates "
        f"{t_gates:.2f}s | vcf write {t_vcf:.2f}s | e2e wall "
        f"{t_e2e:.2f}s {where}")

    t_torch1 = torch_cpu_inference(images)
    t_torch_n = t_torch1 / ncpu   # N share-nothing 1-thread callers
    baseline_e2e = t_host + t_torch_n + t_stage3_posthoc
    baseline = mbp / baseline_e2e
    log(f"torch-cpu 1-thread inference: {t_torch1:.1f}s; emulated "
        f"{ncpu}-caller deployment: {t_torch_n:.1f}s -> reference-style "
        f"e2e {baseline:.3f} Mbp/s {where}")

    # ---- polish workload -------------------------------------------------
    cold = bench_polish(cache, ncpu, dev, args.polish_kb)   # builds, loads
    polish_runs = [bench_polish(cache, ncpu, dev, args.polish_kb)
                   for _ in range(3)]
    launches["polish"] = [{"sequences": r.sequences, "batch_rows": 128,
                           "K2": r.k2_launches}
                          for r in [cold] + polish_runs]
    pm = sorted(polish_runs, key=lambda r: sum(r.split))[1]   # median of 3
    p_stream, p_stitch = pm.split
    polish_dt, cold_dt = sum(pm.split), sum(cold.split)
    log(f"polish e2e ({args.polish_kb}kb draft): {polish_dt:.1f}s warm "
        f"(streamed pileup+consensus {p_stream:.1f}s + stitch "
        f"{p_stitch:.1f}s) / {cold_dt:.1f}s cold (first-call costs "
        f"{cold_dt - polish_dt:.1f}s) -> {pm.mbps:.3f} Mbp/s "
        f"({pm.sequences} sequences) {where}")
    log(f"polish stream breakdown (core-seconds, median run): "
        f"{pm.stats.summary()} | native encode split: fetch "
        f"{pm.native.get('fetch', 0):.2f}s | realign "
        f"{pm.native.get('realign', 0):.2f}s | pileup "
        f"{pm.native.get('pileup', 0):.2f}s {where}")
    # reference-style polish deployment on this host: the staged image gen
    # (about the stream's host side) + stitch, consensus = N 1-thread
    # torch window loops on top
    t_torch_polish = torch_polish_window_inference(pm.sequences)
    t_ref_polish = p_stream + p_stitch + t_torch_polish / ncpu
    log(f"torch-cpu polish window loop: {t_torch_polish:.1f}s 1-thread; "
        f"emulated {ncpu}-caller consensus {t_torch_polish / ncpu:.1f}s -> "
        f"polish vs_baseline {t_ref_polish / polish_dt:.2f}x (ref-style "
        f"e2e {args.polish_kb / 1e3 / t_ref_polish:.3f} Mbp/s) {where}")

    # ---- training step throughput ----------------------------------------
    bs = args.train_batch
    t_step, steps, k3, k4 = bench_train_step(dev, bs, args.train_iters)
    launches["train"] = {"steps": steps, "K3": k3, "K4": k4}
    t_torch_step = torch_train_step(bs)
    log(f"train step (batch {bs}): {1e3 * t_step:.2f} ms/step device "
        f"({bs / t_step:.0f} ex/s) vs torch-cpu 1-thread "
        f"{1e3 * t_torch_step:.1f} ms/step -> "
        f"{t_torch_step / t_step:.1f}x {where}")

    # ---- realigner -------------------------------------------------------
    rps, rdt, n_aligned = bench_realigner()
    log(f"realigner (1500 reads x 1kb): {rdt:.2f}s ({rps:.0f} reads/s, "
        f"{n_aligned} aligned) {where}")

    log("kernel launches per stage: " + json.dumps(launches))
    print(json.dumps({
        "metric": "variant_e2e_throughput",
        "value": round(ours, 4),
        "unit": "Mbp/s",
        "vs_baseline": round(ours / baseline, 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
