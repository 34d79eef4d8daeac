"""Fused stage-1+2: encode regions on host threads WHILE the device infers.

The reference (and our staged path) fully materializes stage 1's HDF5
images before stage 2 starts (CallVariant.py:84-104) — on a TPU that means
the chip idles for the entire host encode (~98% of hot-path wall clock at
1 Mbp scale). Here the stages stream:

  producer threads ──(bounded queue)──> device batcher ──> prediction store
  (native BAM fetch + region encode;     (int8 transfer,    (HDF5 artifact,
   the C++ encoder releases the GIL,      bf16 forward       written behind
   so threads give real host              enqueued on one    the device)
   parallelism with zero pickling)        CUDA stream)

The queue is bounded, so whole-genome runs hold only ~2×threads regions of
images in RAM instead of every image (replaces the eager
load_all_summaries for the fused path). Stage boundaries survive: the
prediction HDF5 is still written (stage 3 stays independently re-runnable)
and image HDF5s can be kept with --keep_image_artifacts — as artifacts,
not barriers. Without h5py the prediction artifact is skipped (loudly):
the VCFs do not depend on it, since the collector gets the predictions
directly.
"""
import os
import queue
import sys
import threading
import time
import weakref
from collections import deque
from datetime import datetime
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.datastore import (ImageStore, PredictionStore,
                                                  h5py_available, stack_images)
from pepper_tpu_torch.utils import streamstats


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def resolve_device(device) -> torch.device:
    """The torch device for `device`; "cuda" with no CUDA device raises
    (the port never carries on on the CPU when the card was asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available (pass device='cpu' / --device cpu "
                           f"to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# the flusher's queue of submitted batches, and the runner's pinned slots:
# one for each batch that queue holds, the one the flusher is reading and
# the one the dispatching thread has just submitted
FLUSH_DEPTH = 6
RING_SLOTS = FLUSH_DEPTH + 2


class _Slot:
    """One pinned input batch (the runner's int8 images) and its output
    (their f32 probabilities), as tensors (`host_in`, `host_out`) and their
    numpy views (`images`, `probs`); `events` mark when the card last
    finished with them."""

    def __init__(self, host_in: torch.Tensor, host_out: torch.Tensor):
        self.host_in, self.host_out = host_in, host_out
        self.images, self.probs = host_in.numpy(), host_out.numpy()
        self.events: Sequence = ()


class _PinnedRing:
    """Pinned slots of one input shape, allocated once and handed out batch
    after batch. A slot comes back (`release`) when its batch's output has
    been copied out, or when the batch is dropped unread; it is handed out
    again (`acquire`, oldest release first) only once the events of its last
    batch have completed, so the card never reads an input being rewritten
    nor writes an output being read. A caller that holds every slot gets a
    new one: the ring never blocks a thread that holds its own batches."""

    def __init__(self, make_slot: Callable[[], _Slot], slots: int):
        self._make = make_slot
        self._free = deque(make_slot() for _ in range(slots))
        self._lock = threading.Lock()

    def acquire(self) -> _Slot:
        with self._lock:
            slot = self._free.popleft() if self._free else None
        if slot is None:
            return self._make()
        for event in slot.events:
            event.synchronize()
        slot.events = ()
        return slot

    def release(self, slot: _Slot, events: Sequence) -> None:
        slot.events = events
        with self._lock:
            self._free.append(slot)


class _PendingBatch:
    """One in-flight batch in a pinned slot, whose output asynchronous D2H
    copies fill; the events in `done` mark them complete (one per replica
    that wrote a slice of it). np.asarray() waits for them (on the flusher
    thread), adds the replicas' device spans (each from its timing event in
    `started`, recorded before the H2D copy, to its event in `done`) to the
    stream's "(device)" seconds, copies the output out and gives the slot
    back to its `ring`, if it came from one. A batch dropped unread gives
    its slot back too."""

    def __init__(self, slot: _Slot, done, started=(),
                 ring: Optional[_PinnedRing] = None):
        self._ring, self._slot = ring, slot
        self._done = done
        self._started = started
        self._probs = None
        self._dropped = None if ring is None else \
            weakref.finalize(self, ring.release, slot, done)

    def __array__(self, dtype=None, copy=None):
        if self._probs is None:
            for event in self._done:
                event.synchronize()
            if self._started:
                streamstats.CURRENT.add("(device)", sum(
                    a.elapsed_time(b)
                    for a, b in zip(self._started, self._done)) / 1e3)
            self._probs = self._slot.probs.copy()
            if self._ring is not None:
                # its events are complete: the ring need not wait on them
                self._dropped.detach()
                self._ring.release(self._slot, ())
        return self._probs if dtype is None else self._probs.astype(dtype)


class _ForwardGraph(NamedTuple):
    """One replica's classifier forward at one input shape, captured as a
    CUDA graph: the int8 -> working dtype cast, `variant_forward` (K1
    twice, the linear layers) and the cast of the probabilities to f32,
    between a fixed device input and output. `made` holds the K1 launches
    each replay makes; `packs` keeps the packed layers it reads alive,
    whatever the pack cache evicts."""
    graph: "torch.cuda.CUDAGraph"
    images: torch.Tensor
    probs: torch.Tensor
    made: Dict[str, int]
    packs: list


class DeviceRunner:
    """Batched classifier forward with fixed-shape batches over a mesh of
    devices (parallel/mesh.py).

    The tail is padded to the fixed batch, a multiple of the mesh's size.
    `device` is "cuda" (every visible card, as the JAX runner shards over
    every local device), "cuda:N" (one card), "cpu", or a list of devices
    (a mesh; repeats allowed). Each mesh entry holds its own parameter
    replica and, on a card, its own stream and event: a batch is split into
    one contiguous block per entry, and each block crosses to its card as
    int8 from a slot of the runner's pinned ring, is cast there, runs
    `variant_forward` (kernel K1 twice) and comes back by an asynchronous
    copy into the slot's output, so `submit` never waits for a device. On
    a card the forward is one CUDA graph per replica and input shape,
    captured after the shape's first batch. bf16 on CUDA, f32 on the CPU or
    with PEPPER_TPU_PRECISION=f32. Shared by the staged
    (runtime/inference.py) and streaming paths."""

    def __init__(self, params, batch_size: int = 2048, device="cuda"):
        from pepper_tpu_torch.models.checkpoint import params_from_jax
        from pepper_tpu_torch.ops import pack_cache
        from pepper_tpu_torch.parallel.mesh import (mesh_for,
                                                    pad_to_multiple,
                                                    replica_streams)

        self.mesh = mesh_for(device)
        self.device = self.mesh[0]
        floor = min(2048, int(os.environ.get("PEPPER_TPU_MIN_DEVICE_BATCH",
                                             "2048")))
        self.batch = pad_to_multiple(max(batch_size, floor), len(self.mesh))
        use_bf16 = (os.environ.get("PEPPER_TPU_PRECISION", "bf16") != "f32"
                    and self.device.type == "cuda")
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        self._replicas = [params_from_jax(params, dev, self.dtype)
                          for dev in self.mesh]
        # K1 packs each replica's two biLSTM layers once
        # (ops/pack_cache.py): room for all of them between batches
        pack_cache.reserve(self, 2 * len(self.mesh))
        self._streams = replica_streams(self.mesh)
        self._rings: Dict[tuple, _PinnedRing] = {}
        self._graphs: Dict[tuple, _ForwardGraph] = {}

    def _forward(self, r: int, images8: torch.Tensor) -> torch.Tensor:
        from pepper_tpu_torch.models.variant_model import variant_forward
        with torch.inference_mode():
            return variant_forward(self._replicas[r],
                                   images8.to(self.dtype)).float()

    def forward(self, images8: torch.Tensor) -> torch.Tensor:
        """int8 images [B, T, F] on the runner's first device (33x26, or
        21x48 in the HP pass: the widths come from the images and the
        checkpoint) -> f32 probs there. Over a mesh of n entries, B splits
        into n blocks, each run by its replica on its device and stream."""
        if len(self.mesh) == 1:
            return self._forward(0, images8)
        from pepper_tpu_torch.parallel.mesh import map_replicas
        return map_replicas(self.mesh, self._streams, self._forward,
                            images8)

    def _ring(self, window: tuple) -> _PinnedRing:
        """The pinned slots for images of `window` ([T, F])."""
        ring = self._rings.get(window)
        if ring is None:
            def make_slot():
                return _Slot(torch.empty((self.batch,) + window,
                                         dtype=torch.int8, pin_memory=True),
                             torch.empty((self.batch, 3),
                                         dtype=torch.float32,
                                         pin_memory=True))
            ring = self._rings[window] = _PinnedRing(make_slot, RING_SLOTS)
        return ring

    def _capture(self, r: int, window: tuple) -> _ForwardGraph:
        """Capture replica r's forward at `window` on its stream. Runs after
        an eager batch of that shape, so K1's packs are built and cached
        (ops/pack_cache.py) and the libraries loaded: the graph reads the
        packs, it does not build them."""
        from pepper_tpu_torch.ops import fused_lstm as fl
        dev, stream = self.mesh[r], self._streams[r]
        rows = self.batch // len(self.mesh)
        before = fl.launch_counts()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            images = torch.zeros((rows,) + window, dtype=torch.int8,
                                 device=dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                probs = self._forward(r, images)
        made = fl.captured_launches(before)
        rep = self._replicas[r]
        packs = [fl.packed_layer(rep[name], fl.select_kernel(
            rows, window[0], rep[name]["weight_hh_l0"].shape[1],
            self.dtype)) for name in ("encoder", "decoder")]
        return _ForwardGraph(graph, images, probs, made, packs)

    def submit(self, images8):
        """Enqueue one batch of int8 images, an array [n, T, F] or a list of
        such blocks; returns an array-like (np.asarray) whose first n rows
        are the probabilities.

        On a card the rows are copied once, into a slot of the runner's
        pinned ring, the padding after them zeroed. Each replica then
        copies its block to its card, runs its forward and copies the
        probabilities back into the slot, on its stream: the first batch of
        a shape eagerly, after which the replica's forward at that shape is
        captured as a CUDA graph; every later batch replays the graph."""
        blocks = [images8] if isinstance(images8, np.ndarray) else images8
        window = tuple(blocks[0].shape[1:])
        stats = streamstats.CURRENT
        if self.device.type == "cpu":
            padded = np.zeros((self.batch,) + window, np.int8)
            _stage(padded, blocks)
            return self.forward(torch.from_numpy(padded)).numpy()
        from pepper_tpu_torch.ops import fused_lstm as fl
        ring = self._ring(window)
        with stats.span("(ring_wait)"):
            slot = ring.acquire()
        with stats.span("(submit_stage)", cpu=True):
            _stage(slot.images, blocks)
        rows = self.batch // len(self.mesh)
        with stats.span("(submit_enqueue)"):
            started = []
            for stream in self._streams:
                event = torch.cuda.Event(enable_timing=True)
                event.record(stream)
                started.append(event)
            done, eager = [], []
            for r, (dev, stream) in enumerate(zip(self.mesh,
                                                  self._streams)):
                block_in = slot.host_in[r * rows:(r + 1) * rows]
                block_out = slot.host_out[r * rows:(r + 1) * rows]
                graph = self._graphs.get((r, window))
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    if graph is None:
                        eager.append(r)
                        block_out.copy_(self._forward(
                            r, block_in.to(dev, non_blocking=True)),
                            non_blocking=True)
                    else:
                        graph.images.copy_(block_in, non_blocking=True)
                        graph.graph.replay()
                        block_out.copy_(graph.probs, non_blocking=True)
                        fl.count_replay(graph.made)
                    event = torch.cuda.Event(enable_timing=True)
                    event.record(stream)
                    done.append(event)
        for r in eager:
            self._graphs[(r, window)] = self._capture(r, window)
        return _PendingBatch(slot, done, started, ring)


def _stage(out: np.ndarray, blocks: Sequence[np.ndarray]) -> None:
    """Copy the rows of `blocks` one after another into `out` and zero the
    rows after them, so a padded batch reads defined input."""
    n = 0
    for block in blocks:
        out[n:n + len(block)] = block
        n += len(block)
    out[n:] = 0


_runner_cache: dict = {}


def get_device_runner(model_path: str, batch_size: int,
                      device="cuda") -> DeviceRunner:
    """Process-wide DeviceRunner cache: the checkpoint load + device
    placement of params is identical for every stage-2 invocation of the
    same model on the same mesh."""
    from pepper_tpu_torch.parallel.mesh import mesh_for
    key = (os.path.abspath(model_path), max(batch_size, 2048),
           os.environ.get("PEPPER_TPU_PRECISION", "bf16"),
           tuple(str(d) for d in mesh_for(device)))
    if key not in _runner_cache:
        from pepper_tpu_torch.runtime.inference import _load_model_params
        _runner_cache[key] = DeviceRunner(_load_model_params(model_path),
                                          batch_size, device)
    return _runner_cache[key]


def stream_batch_rows(batch_size: int, device: torch.device) -> int:
    """Rows of the streamed runner's fixed batch: `batch_size` or the floor,
    whichever is larger. Big fixed batches mean fewer launches, transfers
    and syncs per candidate: 16384 on CUDA; on the CPU the f32 forward's
    workspace scales with the batch (xp alone is 0.5 GB per direction at
    4096), so 4096 there. PEPPER_TPU_MIN_DEVICE_BATCH overrides the floor
    (tests that need several flushes on tiny data)."""
    default_floor = "4096" if device.type == "cpu" else "16384"
    return max(batch_size, int(os.environ.get("PEPPER_TPU_MIN_DEVICE_BATCH",
                                              default_floor)))


class _MetaBuffer:
    """Accumulates per-candidate metadata + int8 images until a device
    batch is full."""

    def __init__(self):
        self.contigs: List[str] = []
        self.positions: List[np.ndarray] = []
        self.depths: List[np.ndarray] = []
        self.candidates: List[Tuple[str, ...]] = []
        self.freqs: List[np.ndarray] = []
        self.images: List[np.ndarray] = []
        self.runs: List[List[int]] = []   # FIFO of [interval_idx, n_rows]
        self.rows = 0

    def add(self, contig, positions, depths, candidates, freqs, images8,
            interval_idx: int = -1):
        self.contigs.extend([contig] * len(positions))
        self.positions.append(positions)
        self.depths.append(depths)
        self.candidates.extend(candidates)
        self.freqs.append(freqs)
        self.images.append(images8)
        self.runs.append([interval_idx, len(positions)])
        self.rows += len(positions)

    def take(self, n: int):
        """Split off the first n rows as flat arrays, the images as the list
        of their chunks (`DeviceRunner.submit` copies each chunk once, into
        its pinned slot), plus their interval-run accounting, for the
        ordered stage-3 watermark.

        O(n) per take, not O(buffer): whole chunks are moved into the batch
        and only the boundary chunk is split; the remainder keeps its chunk
        list without being re-concatenated (the old implementation
        flattened the entire buffer on every take)."""
        pos_out, dep_out, frq_out, img_out = [], [], [], []
        got = 0
        while got < n:
            k = len(self.positions[0])
            if got + k <= n:
                pos_out.append(self.positions.pop(0))
                dep_out.append(self.depths.pop(0))
                frq_out.append(self.freqs.pop(0))
                img_out.append(self.images.pop(0))
                got += k
            else:
                need = n - got
                pos_out.append(self.positions[0][:need])
                dep_out.append(self.depths[0][:need])
                frq_out.append(self.freqs[0][:need])
                img_out.append(self.images[0][:need])
                self.positions[0] = self.positions[0][need:]
                self.depths[0] = self.depths[0][need:]
                self.freqs[0] = self.freqs[0][need:]
                self.images[0] = self.images[0][need:]
                got = n
        batch_runs, rest_runs, left = [], [], n
        for idx, k in self.runs:
            if left >= k:
                batch_runs.append((idx, k))
                left -= k
            elif left > 0:
                batch_runs.append((idx, left))
                rest_runs.append([idx, k - left])
                left = 0
            else:
                rest_runs.append([idx, k])
        out = (self.contigs[:n], np.concatenate(pos_out),
               np.concatenate(dep_out), self.candidates[:n],
               np.concatenate(frq_out), img_out, batch_runs)
        rest = _MetaBuffer()
        if n < self.rows:
            rest.contigs = self.contigs[n:]
            rest.positions = self.positions
            rest.depths = self.depths
            rest.candidates = self.candidates[n:]
            rest.freqs = self.freqs
            rest.images = self.images
            rest.runs = rest_runs
            rest.rows = self.rows - n
        return out, rest


def _batch_fields(result):
    """(contig, positions, depths, per-row candidate tuples, freqs,
    images8) from either a CandidateBatch or a list of CandidateImage."""
    from pepper_tpu_torch.encode.region_encoder import CandidateBatch
    images8 = stack_images(result).astype(np.int8, copy=False)
    if isinstance(result, CandidateBatch):
        freqs = np.asarray(result.candidate_frequency).reshape(-1)
        # the rows of one allele share its one-allele tuple: a region's
        # ~3,000 rows hold ~100 distinct alleles, and a new container a row
        # kept the garbage collector busy, under the interpreter lock, for
        # a few ms a region
        rows = {c: (c,) for c in set(result.candidates)}
        return (result.contig, np.asarray(result.positions),
                np.asarray(result.depths),
                list(map(rows.__getitem__, result.candidates)), freqs,
                images8)
    return (result[0].contig,
            np.array([c.position for c in result], np.int64),
            np.array([c.depth for c in result], np.int32),
            [tuple(c.candidates) for c in result],
            np.array([int(np.atleast_1d(c.candidate_frequency)[0])
                      for c in result], np.int32),
            images8)


def stream_inference(config: PipelineConfig, intervals,
                     prediction_path: str,
                     image_store_path: Optional[str] = None,
                     candidate_collector=None,
                     resume_journal: Optional[str] = None) -> int:
    """Encode `intervals` and run model inference concurrently; writes
    prediction batches to `prediction_path`. Returns candidate count.

    candidate_collector: optional StreamingCandidateCollector — each
    flushed prediction batch is also pushed there, so stage 3's gates run
    behind the device instead of after the whole stream (the last stage
    barrier removed).

    resume_journal: optional path to the per-region resume journal
    (runtime/resume.py). Every flushed batch + per-interval row totals
    are appended; when the file already holds a compatible journal (same
    intervals + model), completed intervals are REPLAYED from it instead
    of re-encoded — a killed run resumes with byte-identical outputs.
    The caller deletes the file after the downstream consumers finish.
    (The optional image artifact does not cover replayed intervals.)"""
    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    from pepper_tpu_torch.pipelines.make_images import create_region_summary

    device = resolve_device(config.device)
    runner = get_device_runner(config.model_path,
                               stream_batch_rows(config.batch_size, device),
                               device)
    journal = None
    replayed: list = []
    skip: dict = {}
    if resume_journal is not None:
        from pepper_tpu_torch.runtime.resume import (ResumeJournal, compact_journal,
                                               completed_intervals,
                                               load_journal, replay_slices,
                                               run_setting)
        inputs = (config.bam, config.fasta)
        # a journal written on another dtype or mesh is not replayed
        setting = run_setting(runner.dtype, len(runner.mesh))
        loaded = load_journal(resume_journal, intervals, config.model_path,
                              inputs, setting)
        if loaded is not None:
            totals, batches = loaded
            skip = completed_intervals(totals, batches)
            replayed = list(replay_slices(batches, skip))
            # drop the incomplete intervals' stale partial rows BEFORE any
            # new appends: old + new partials for one interval would
            # double-count toward its total on the next resume
            compact_journal(resume_journal, intervals, config.model_path,
                            inputs, skip,
                            [("batch",) + tuple(r) for r in replayed],
                            setting)
            if skip:
                _log(f"RESUME: {len(skip)}/{len(intervals)} INTERVALS "
                     f"REPLAYED FROM JOURNAL")
        elif os.path.isfile(resume_journal):
            os.remove(resume_journal)   # stale/incompatible journal
        journal = ResumeJournal(resume_journal, intervals,
                                config.model_path, inputs, setting)

    # the caller's accounting epoch (call_variant's job, or a run of its
    # own); run alone, the stream leaves the states it enters on return
    stats = streamstats.CURRENT
    alone = stats.state_key is None
    n_threads = max(1, config.threads)
    work: "queue.Queue" = queue.Queue()
    for item in enumerate(intervals):
        if item[0] not in skip:
            work.put(item)
    results: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
    errors: List[BaseException] = []
    stop = threading.Event()   # set on any failure: unblocks every thread

    def _put_result(item) -> None:
        while not stop.is_set():
            try:
                results.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        # share-nothing per thread: own BAM/FASTA handles (the native
        # encode releases the GIL, so threads run the C++ walk in parallel)
        try:
            with BamReader(config.bam) as bam, \
                    FastaReader(config.fasta) as fasta:
                while not stop.is_set():
                    try:
                        idx, (chr_name, start, end) = work.get_nowait()
                    except queue.Empty:
                        return
                    with stats.span("encode", cpu=True):
                        cands = create_region_summary(config, bam, fasta,
                                                      chr_name, start, end)
                    # the native encoder's sections, nested in `encode`
                    for key, seconds in (getattr(cands, "sections", None)
                                         or {}).items():
                        stats.add(key, seconds)
                    with stats.span("batch_fields", cpu=True):
                        fields = _batch_fields(cands) if cands else None
                    # empty intervals are reported too: the ordered
                    # stage-3 watermark accounts for every interval
                    _put_result((idx, fields))
        except BaseException as exc:  # fail loudly, never silently drop
            errors.append(exc)
            raise
        finally:
            _put_result(None)  # one sentinel per producer

    threads = [threading.Thread(target=producer, daemon=True)
               for _ in range(n_threads)]
    from pepper_tpu_torch.ops import fused_lstm
    counts0 = (fused_lstm.launches, fused_lstm.graph_replays)
    t0 = time.time()
    for t in threads:
        t.start()
    stats.state("main.dispatch")

    image_store = ImageStore(image_store_path, "w") if image_store_path \
        else None
    buf = _MetaBuffer()
    done_sentinels = 0
    total = 0
    store = None
    if h5py_available():
        store = PredictionStore(prediction_path, "w")
    else:
        _log("WARNING: h5py IS NOT INSTALLED — THE STREAMED RUN SKIPS THE "
             f"PREDICTION ARTIFACT {prediction_path} (THE VCFS DO NOT "
             "DEPEND ON IT)")
    batch_no = 0

    crash_after = int(os.environ.get("PEPPER_TPU_TEST_CRASH_AFTER_FLUSH",
                                     "0"))

    def flush(meta, probs, journal_batch: bool = True):
        nonlocal batch_no
        contigs, positions, depths, cand_lists, freqs, _, runs = meta
        n = len(contigs)
        with stats.span("d2h_wait"):
            probs_np = np.asarray(probs)[:n].astype(np.float64)
        if store is not None:
            with stats.span("store_write", cpu=True):
                store.write_prediction(batch_no, contigs, positions, depths,
                                       cand_lists, freqs, probs_np)
        if candidate_collector is not None:
            # freqs pass as a flat array; the gates materialize per-row
            # lists only on the (rare) scalar path
            with stats.span("collector_put"):
                candidate_collector.add(
                    contigs, positions, depths, cand_lists,
                    np.ravel(np.asarray(freqs)), probs_np, runs)
        batch_no += 1
        if journal is not None and journal_batch:
            with stats.span("journal", cpu=True):
                journal.append(
                    ("batch", list(contigs), np.asarray(positions),
                     np.asarray(depths), list(cand_lists),
                     np.asarray(freqs), probs_np, list(runs)))
            if crash_after and batch_no >= crash_after:
                os._exit(9)   # test hook: simulate kill -9 mid-stream

    # a dedicated flusher thread owns the device->host sync: the main
    # thread NEVER waits on a result (on high-latency links one D2H sync
    # can stall the whole encode pipeline), yet the gates + ordered VCF
    # emission keep pace with the stream instead of piling into the tail.
    # The bounded queue caps in-flight batches (host+device memory).
    flush_q: "queue.Queue" = queue.Queue(maxsize=FLUSH_DEPTH)

    def flusher():
        try:
            while True:
                item = flush_q.get()
                if item is None:
                    return
                flush(*item)
        except BaseException as exc:
            errors.append(exc)
            raise

    flush_thread = threading.Thread(target=flusher, daemon=True)

    # Resume replay — BEFORE the flusher starts (flush() and the store are
    # single-threaded until then): completed intervals' predictions feed
    # stage 3 and the fresh prediction store without touching the encoder
    # or the device. Original flush order is preserved, so the final VCFs
    # are byte-identical to an uninterrupted run.
    if skip and candidate_collector is not None:
        for idx, n_rows in skip.items():
            candidate_collector.note_interval(idx, n_rows)
    for rec in replayed:
        (contigs_r, positions_r, depths_r, cands_r, freqs_r, probs_r,
         runs_r) = rec
        flush((contigs_r, positions_r, depths_r, cands_r, freqs_r, None,
               runs_r), probs_r, journal_batch=False)
        total += len(contigs_r)

    flush_thread.start()

    def _put_flush(item) -> None:
        # never block forever on a dead flusher: surface its error instead
        while True:
            if errors:
                raise RuntimeError(
                    f"streaming shard failed: {errors[0]}") from errors[0]
            try:
                flush_q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    try:
        while done_sentinels < n_threads:
            stats.state("main.wait_encode")
            item = results.get()
            stats.state("main.dispatch")
            if item is None:
                done_sentinels += 1
                continue
            interval_idx, fields = item
            if candidate_collector is not None:
                candidate_collector.note_interval(
                    interval_idx, len(fields[1]) if fields else 0)
            if journal is not None:
                journal.append(("total", interval_idx,
                                len(fields[1]) if fields else 0))
            if fields is None:
                continue
            contig, positions, depths, cand_lists, freqs, images8 = fields
            if image_store is not None and len(positions):
                # `total` is unique and monotonic on this thread (batch_no
                # belongs to the flusher thread — do not read it here)
                name = (f"{contig}_{int(positions[0])}"
                        f"_{int(positions[-1])}_{total}")
                from pepper_tpu_torch.encode.region_encoder import CandidateBatch
                # the kept-image artifact stores one allele per row;
                # lossless because the encoder emits exactly one allele per
                # candidate row (region_encoder.py:73,391) — fail loudly if
                # that changes
                assert all(len(c) == 1 for c in cand_lists), \
                    "streamed image artifact assumes one allele per row"
                image_store.write_summary(name, CandidateBatch(
                    contig, positions, depths,
                    [c[0] for c in cand_lists], freqs, images8,
                    np.zeros(len(positions), np.int32),
                    np.zeros(len(positions), np.int32)))
            buf.add(contig, positions, depths, cand_lists, freqs, images8,
                    interval_idx)
            total += len(positions)
            while buf.rows >= runner.batch:
                stats.state("main.submit")
                with stats.span("batch_submit", cpu=True):
                    meta, buf = buf.take(runner.batch)
                    out = runner.submit(meta[5])
                stats.state("main.wait_flush")
                _put_flush((meta, out))
                stats.state("main.dispatch")
        stats.state("main.wait_producers")
        for t in threads:
            t.join()
        if buf.rows and not errors:
            stats.state("main.submit")
            with stats.span("batch_submit", cpu=True):
                meta, _ = buf.take(buf.rows)
                out = runner.submit(meta[5])
            stats.state("main.wait_flush")
            _put_flush((meta, out))
    finally:
        stop.set()   # unblock any producer still waiting on the queues
        stats.state("main.stage3_drain")
        # ALWAYS stop + join the flusher before returning OR raising: an
        # abandoned flusher would keep feeding the collector and native
        # VCF sink while the caller's error path aborts them (freeing the
        # C++ FILE handles under an in-flight write — use-after-free).
        # Checked sentinel delivery: a dead flusher (its error already in
        # `errors`) may leave flush_q full — never block forever on it.
        while flush_thread.is_alive():
            try:
                flush_q.put(None, timeout=0.2)
                break
            except queue.Full:
                continue
        flush_thread.join()
        if journal is not None:
            journal.close()  # caller deletes the file after stage 3 ends
        if alone:
            stats.state(None)
    if errors:
        raise RuntimeError(f"streaming shard failed: {errors[0]}") \
            from errors[0]
    if store is not None:
        store.close()
    if image_store is not None:
        image_store.close()
    _log(f"STREAMED ENCODE+INFERENCE: {total} CANDIDATES "
         f"[{time.time() - t0:.1f}s]; K1 LAUNCHES "
         f"{fused_lstm.launches - counts0[0]}, GRAPH REPLAYS "
         f"{fused_lstm.graph_replays - counts0[1]}")
    _log("STREAM BREAKDOWN (core-seconds): " + stats.summary())
    return total
