"""Polish stage 2 — consensus inference (sliding-window biGRU with vote
accumulation).

Parity: pepper/modules/python/models/predict_distributed_cpu.py:19-105 and
the JAX package's polish/consensus.py. A 100-wide window slides with stride
50 across each 1000-long image (19 windows), the biGRU hidden is carried
from window to window, overlapping softmax votes are added in scan order,
and phred comes from the vote fraction. The JAX package traces the window
loop into one jitted scan; here it is a Python loop over the 19 windows
whose two biGRU layers each launch kernel K2 on the card
(ops/fused_gru.py). The vote function also runs over a mesh of devices
(batch split, parameters replicated), as the JAX one does; the runner and
the streamed polish use one device, as the JAX ones do.
"""
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from pepper_tpu_torch.models.checkpoint import params_from_jax
from pepper_tpu_torch.models.polish_model import (hidden_size, init_hidden,
                                                  polish_forward)
from pepper_tpu_torch.options import PolishImageOptions, PolishTrainOptions
from pepper_tpu_torch.polish.datastore import (PolishImageStore,
                                               PolishPredictionStore,
                                               polish_image_files)
from pepper_tpu_torch.runtime.streaming import (_PendingBatch, _Slot,
                                                resolve_device)


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def window_votes(cparams, x: torch.Tensor) -> torch.Tensor:
    """Summed softmax votes f32 [B,1000,5] of the 19 windows over images
    x [B,1000,10] (already in the model's dtype), with the biGRU hidden
    carried from window to window and the adds in scan order. The hidden
    width is the checkpoint's, as in the trainer: the JAX package fixes it
    at PolishTrainOptions.HIDDEN_SIZE (pepper_tpu/polish/consensus.py:56)
    and serves only width-128 models."""
    window = PolishTrainOptions.TRAIN_WINDOW
    B, seq_len = x.shape[:2]
    votes = torch.zeros((B, seq_len, PolishImageOptions.TOTAL_LABELS),
                        dtype=torch.float32, device=x.device)
    hidden = init_hidden(B, hidden_size(cparams), dtype=x.dtype,
                         device=x.device)
    for start in range(0, seq_len - window + 1,
                       PolishTrainOptions.WINDOW_JUMP):
        logits, hidden = polish_forward(cparams, x[:, start:start + window],
                                        hidden, fused_rnn=True)
        votes[:, start:start + window] += torch.softmax(logits.float(), dim=2)
    return votes


def make_window_vote_fn(params, device, dtype: torch.dtype, mesh=None):
    """(uint8 images [B,1000,10] on `device`) -> (base_labels int32
    [B,1000], phred f32 [B,1000]) with the reference's window/vote/phred
    semantics. `params` is the numpy parameter tree (checkpoint loaders);
    the model runs in `dtype`, the votes, softmax and phred in f32.

    mesh: optional list of devices (parallel/mesh.py): the parameters are
    replicated over it, and the batch splits into one contiguous block per
    entry, voted by that entry's replica on its device and stream (K2 38
    times per block on a card); the labels and phred come back on
    `device`. B must be a multiple of the mesh's size."""
    seq_len = PolishImageOptions.SEQ_LENGTH
    overlap = PolishImageOptions.SEQ_OVERLAP
    devices = [torch.device(device)] if mesh is None else list(mesh)
    replicas = [params_from_jax(params, dev, dtype) for dev in devices]
    # positions covered by two windows count two votes, the edges one
    counts = []
    for dev in devices:
        c = torch.full((seq_len,), 2.0, device=dev)
        c[:overlap] = 1.0
        c[seq_len - overlap:] = 1.0
        counts.append(c)

    def vote(r: int, images: torch.Tensor):
        with torch.inference_mode():
            votes = window_votes(replicas[r], images.to(dtype))
            base_values = votes.amax(dim=2)
            base_labels = torch.argmax(votes, dim=2).to(torch.int32)
            phred = -10.0 * torch.log10(
                torch.clamp(1.0 - base_values / counts[r], min=1e-10))
            return base_labels, torch.clamp(phred, max=100.0)

    if mesh is None:
        return lambda images: vote(0, images)
    from pepper_tpu_torch.ops import pack_cache
    from pepper_tpu_torch.parallel.mesh import map_replicas, replica_streams
    streams = replica_streams(devices)

    def fn(images: torch.Tensor):
        return map_replicas(devices, streams, vote, images)

    pack_cache.reserve(fn, 2 * len(devices))   # K2's two layers a replica
    return fn


class ConsensusRunner:
    """Window/vote consensus on one device.

    Images cross to the card as uint8 (their values are 0..254) from
    pinned memory and are cast on the device; bf16 on CUDA, f32 on the CPU
    or with PEPPER_TPU_PRECISION=f32. All device work is issued on one
    stream held by the runner, and each batch's base labels come back by an
    asynchronous copy completed by a CUDA event, so `submit` never waits
    for the device. Shared by the staged (call_consensus) and streaming
    (polish/streaming.py) paths."""

    def __init__(self, params, device="cuda"):
        self.device = resolve_device(device)
        use_bf16 = (os.environ.get("PEPPER_TPU_PRECISION", "bf16") != "f32"
                    and self.device.type == "cuda")
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32
        self._vote = make_window_vote_fn(params, self.device, self.dtype)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the parameter uploads were issued on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def forward(self, images: torch.Tensor):
        """uint8 images [B,1000,10] on the runner's device -> (base_labels
        int32 [B,1000], phred f32 [B,1000])."""
        return self._vote(images)

    def submit(self, images: np.ndarray):
        """Enqueue one padded batch (pad_consensus_batch) of uint8 images;
        returns an array-like (np.asarray) of its base labels [B,1000]."""
        if images.dtype != np.uint8:
            raise TypeError(f"polish images are uint8 counts, got "
                            f"{images.dtype}")
        if self.device.type == "cpu":
            labels, _ = self.forward(torch.from_numpy(images))
            return labels.numpy()
        host_in = torch.empty(images.shape, dtype=torch.uint8,
                              pin_memory=True)
        host_in.numpy()[:] = images
        host_out = torch.empty(images.shape[:2], dtype=torch.int32,
                               pin_memory=True)
        with torch.cuda.stream(self._stream):
            labels, _ = self.forward(host_in.to(self.device,
                                                non_blocking=True))
            host_out.copy_(labels, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return _PendingBatch(_Slot(host_in, host_out), [done])


def pad_consensus_batch(images: list, batch_size: int) -> np.ndarray:
    """Stack a (possibly short) list of sequence images and zero-pad to the
    fixed device batch. Shared by the staged reader below and the fused
    stream (polish/streaming.py)."""
    x = np.stack(images)
    if len(images) < batch_size:
        x = np.concatenate(
            [x, np.zeros((batch_size - len(images),) + x.shape[1:],
                         x.dtype)])
    return x


def call_consensus(image_dir: str, model_path: str, output_dir: str,
                   batch_size: int = 128, device="cuda") -> str:
    """Run consensus inference over all polish images; one prediction file.
    Needs h5py (the image and prediction stores)."""
    from pepper_tpu_torch.runtime.inference import _load_model_params

    runner = ConsensusRunner(_load_model_params(model_path), device)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "pepper_prediction_0.hdf")

    # cheap metadata pass for the parity log line (no image data read)
    files = polish_image_files(image_dir)
    n_seqs = 0
    for path in files:
        with PolishImageStore(path, "r") as store:
            n_seqs += len(store.summary_names())
    _log(f"TOTAL SEQUENCES: {n_seqs}")
    t0 = time.time()

    with PolishPredictionStore(out_path, "w") as out:

        def submit(metas, images):
            return metas, runner.submit(pad_consensus_batch(images,
                                                            batch_size))

        def drain(pending):
            metas, labels = pending
            labels = np.asarray(labels)[:len(metas)]
            for meta, base_labels in zip(metas, labels):
                out.write_prediction(
                    meta["contig"], meta["region_start"], meta["region_end"],
                    meta["chunk_id"], meta["position"], meta["index"],
                    base_labels)

        # each image file is opened ONCE and one device batch stays in
        # flight: submit returns before the device finishes, so the next
        # batch's HDF5 reads overlap the card's compute
        pending = None
        metas, images = [], []
        for path in files:
            with PolishImageStore(path, "r") as store:
                for name in store.summary_names():
                    s = store.read_summary(name)
                    metas.append(s)
                    images.append(s["image"])
                    if len(metas) == batch_size:
                        nxt = submit(metas, images)
                        metas, images = [], []
                        if pending is not None:
                            drain(pending)
                        pending = nxt
        if metas:
            nxt = submit(metas, images)
            if pending is not None:
                drain(pending)
            pending = nxt
        if pending is not None:
            drain(pending)
    _log(f"CONSENSUS INFERENCE COMPLETE [{time.time() - t0:.1f}s]")
    return out_path
