"""Stage 2 — batched device inference over candidate images.

Replaces the reference's ONNX-export + per-process onnxruntime scheme
(pepper_variant/modules/python/models/predict_distributed_cpu.py): the
classifier forward runs on one CUDA device (runtime/streaming.py
DeviceRunner) in fixed-shape batches (the tail is padded), with the biLSTM
recurrence in the port's own kernel (ops/fused_lstm.py).

The '--dry' oracle backend reproduces predict_distributed_cpu_fake.py:
labeled images' type labels are emitted as one-hot predictions, exercising
the image->prediction->candidate->VCF plumbing without a model.
"""
import glob
import os
import sys
import time
from datetime import datetime
from typing import List

import numpy as np

from pepper_tpu_torch.options import ImageOptions, PipelineConfig
from pepper_tpu_torch.pipelines.datastore import ImageStore, PredictionStore


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def image_files(image_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(image_dir, "*.hdf5"))
                  + glob.glob(os.path.join(image_dir, "*.h5")))


def load_all_summaries(image_dir, train_mode: bool = False):
    """Eager load of every summary group (reference dataloader_predict.py).

    `image_dir` may also be an explicit list of files (multi-host shards)."""
    contigs, positions, depths, candidates, freqs, images = [], [], [], [], [], []
    labels = []
    files = image_dir if isinstance(image_dir, (list, tuple)) \
        else image_files(image_dir)
    for path in files:
        with ImageStore(path, "r") as store:
            for name in store.summary_names():
                s = store.read_summary(name, train_mode=train_mode)
                contigs.extend(s["contigs"])
                positions.append(s["positions"])
                depths.append(s["depths"])
                candidates.extend(s["candidates"])
                freqs.append(s["candidate_frequency"])
                images.append(s["images"])
                if train_mode and "type_label" in s:
                    labels.append(s["type_label"])
    if not images:
        return None
    out = dict(
        contigs=contigs,
        positions=np.concatenate(positions),
        depths=np.concatenate(depths),
        candidates=candidates,
        candidate_frequency=np.concatenate(freqs),
        images=np.concatenate(images),
    )
    if labels:
        out["type_label"] = np.concatenate(labels)
    return out


def _load_model_params(model_path: str):
    from pepper_tpu_torch.models import checkpoint as ckpt
    if model_path.endswith(".npz"):
        params, _ = ckpt.load_checkpoint(model_path)
    else:
        params, _ = ckpt.load_torch_checkpoint(model_path)
    return params


def _iter_summary_groups(files, train_mode: bool = False):
    for path in files:
        with ImageStore(path, "r") as store:
            for name in store.summary_names():
                yield store.read_summary(name, train_mode=train_mode)


def run_inference(config: PipelineConfig, image_dir: str,
                  output_dir: str, shard_files_by_host: bool = False) -> str:
    """Run stage 2; writes pepper_predictions.hdf into output_dir.

    Model inference is batched bf16 on device (DeviceRunner): int8
    transfers (the stores' native dtype — 4x less host->device traffic),
    fixed-shape padded batches, and asynchronous launches and copies so
    transfers run ahead of compute. Summary groups
    stream file-by-file, so WGS-scale runs hold ~one device batch of
    images in RAM rather than every image (replaces the reference's
    eager dataloader_predict.py full-RAM load).

    shard_files_by_host: stripe the image-file list across hosts — for
    standalone multi-host runs on a shared image directory. Inside
    call_variant each host already has its own per-run image dir."""
    from pepper_tpu_torch.parallel import multihost
    from pepper_tpu_torch.runtime.streaming import _MetaBuffer, get_device_runner

    multihost.initialize_from_config(config)
    os.makedirs(output_dir, exist_ok=True)
    files = image_files(image_dir)
    if shard_files_by_host and multihost.host_count() > 1:
        files = multihost.host_shard(files)
        _log(f"HOST {multihost.host_index()}/{multihost.host_count()}: "
             f"{len(files)} IMAGE FILES IN SHARD")
    out_path = os.path.join(
        output_dir, f"pepper_predictions_{multihost.host_tag()}0.hdf"
        if multihost.host_count() > 1 else "pepper_predictions.hdf")
    t0 = time.time()

    runner = None
    if not config.dry:
        runner = get_device_runner(config.model_path, config.batch_size,
                                   config.device)
    flush_rows = config.batch_size if config.dry else runner.batch

    n_total = 0
    batch_no = 0
    buf = _MetaBuffer()
    dry_preds: List[np.ndarray] = []
    pending = []

    with PredictionStore(out_path, "w") as store:

        def flush(meta, probs):
            nonlocal batch_no
            contigs, positions, depths, cand_lists, freqs = meta[:5]
            store.write_prediction(batch_no, contigs, positions, depths,
                                   cand_lists, freqs,
                                   np.asarray(probs)[:len(contigs)]
                                   .astype(np.float64))
            batch_no += 1

        def drain(final: bool):
            nonlocal buf, dry_preds
            while buf.rows >= flush_rows or (final and buf.rows):
                meta, buf = buf.take(min(flush_rows, buf.rows))
                if config.dry:
                    n = len(meta[0])
                    flush(meta, np.concatenate(dry_preds)[:n])
                    dry_preds = [np.concatenate(dry_preds)[n:]]
                else:
                    pending.append((meta, runner.submit(meta[5])))
                    while len(pending) > 4 or (final and pending):
                        flush(*pending.pop(0))

        for s in _iter_summary_groups(files, train_mode=config.dry):
            n = len(s["contigs"])
            if not n:
                continue
            if config.dry:
                if "type_label" not in s:
                    raise ValueError(
                        "--dry requires labeled images (train_mode)")
                preds = np.zeros((n, ImageOptions.TOTAL_TYPE_LABELS))
                preds[np.arange(n), s["type_label"]] = 1.0
                dry_preds.append(preds)
            # contigs repeat per group; candidates are per-row lists
            buf.add(s["contigs"][0], s["positions"], s["depths"],
                    s["candidates"], s["candidate_frequency"],
                    s["images"].astype(np.int8, copy=False))
            n_total += n
            drain(final=False)
        drain(final=True)

    if n_total == 0:
        _log("NO CANDIDATE IMAGES FOUND; EMPTY PREDICTIONS.")
    _log(f"INFERENCE COMPLETE: {n_total} CANDIDATES [{time.time() - t0:.1f}s]")
    return out_path
