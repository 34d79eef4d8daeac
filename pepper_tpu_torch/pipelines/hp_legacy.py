"""Legacy chunked-HP prediction chain (dormant in the reference r0.8),
PyTorch.

Port of the reference's caller-less HP machinery and of the JAX package's
pipelines/hp_legacy.py:
- chunked per-haplotype image store — `DataStore.write_summary_hp`
  (pepper_variant/modules/python/DataStore.py:83-99), read back the way
  `SequenceDatasetHP` does (models/dataloader_predict.py:114-158);
- per-chunk HP prediction store — `DataStorePredict.write_prediction_hp`
  (DataStorePredict.py:69-99);
- the dual-haplotype sliding-window GRU predictor with hidden carry and
  int-truncated softmax vote accumulation
  (models/predict_hp_distributed_cpu.py:19-117): a Python loop over the 19
  windows of a 1000-long chunk whose two biGRU layers each launch kernel K2
  on the card (`polish_forward(..., fused_rnn=True)`, ops/fused_gru.py), as
  the consensus vote does (polish/consensus.py): 76 launches per batch
  (19 windows x 2 layers x 2 haplotypes);
- a bridge into the legacy HP candidate finder
  (pipelines/candidate_finder_legacy.LegacyCandidateFinderHP).

The stores, `hp_image_files`, `make_chunked_hp_images` and
`predictions_to_finder_inputs` are copies of the JAX package's, with h5py
imported only when a store is opened (pipelines/datastore.py).
`vote_records` is the array-level core of `predict_hp`: it votes chunks
held in memory, and `HPPredictionList` hands its records to
`predictions_to_finder_inputs` in the store's order, so the chain runs
without h5py.

Reference incoherences, documented rather than hidden:
- r0.8 ships NO producer for image_hp1/image_hp2 (write_summary_hp has no
  callers); `make_chunked_hp_images` here completes the chain by chunking
  the HP encoder's full-region 48-feature matrix per haplotype (the other
  haplotype's count blocks zeroed), 1000-length chunks with 50 overlap.
- the r0.8 predictor constants say 28 classes (ImageSizeOptionsHP), but
  CandidateFinderHP's math indexes 5 base classes ('*',A,C,G,T) — relics
  of different releases. num_classes is a parameter here; the end-to-end
  legacy chain uses the 5-class head the finder expects.
"""
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pepper_tpu_torch.models.checkpoint import params_from_jax
from pepper_tpu_torch.models.polish_model import polish_forward
from pepper_tpu_torch.options import ImageOptionsHP, TrainOptions
from pepper_tpu_torch.pipelines.datastore import _h5py
from pepper_tpu_torch.runtime.streaming import resolve_device


# ------------------------------------------------------------------- stores
class HPChunkedImageStore:
    """summaries/<name>/{image_hp1,image_hp2,label_hp1,label_hp2,position,
    index,contig,region_start,region_end,chunk_id} — DataStore.py:83-99."""

    def __init__(self, filename: str, mode: str = "r"):
        self.fh = _h5py().File(filename, mode)
        self._names = set()

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_summary_hp(self, region, image_hp1, image_hp2, label_hp1,
                         label_hp2, position, index, chunk_id,
                         summary_name) -> None:
        contig_name, region_start, region_end = region
        if summary_name in self._names:
            return
        self._names.add(summary_name)
        g = self.fh.create_group(f"summaries/{summary_name}")
        g["image_hp1"] = np.asarray(image_hp1, dtype=np.uint8)
        g["image_hp2"] = np.asarray(image_hp2, dtype=np.uint8)
        g["label_hp1"] = np.asarray(label_hp1, dtype=np.uint8)
        g["label_hp2"] = np.asarray(label_hp2, dtype=np.uint8)
        g["position"] = np.asarray(position, dtype=np.int32)
        g["index"] = np.asarray(index, dtype=np.int32)
        g["contig"] = contig_name
        g["region_start"] = region_start
        g["region_end"] = region_end
        g["chunk_id"] = chunk_id

    def summary_names(self) -> List[str]:
        return (sorted(self.fh["summaries"].keys())
                if "summaries" in self.fh else [])

    def read_summary(self, name: str) -> Dict:
        g = self.fh["summaries"][name]
        contig = g["contig"][()]
        if isinstance(contig, bytes):
            contig = contig.decode()
        return {
            "contig": contig,
            "region_start": int(g["region_start"][()]),
            "region_end": int(g["region_end"][()]),
            "chunk_id": int(g["chunk_id"][()]),
            "image_hp1": g["image_hp1"][()],
            "image_hp2": g["image_hp2"][()],
            "position": g["position"][()],
            "index": g["index"][()],
        }


class HPPredictionStore:
    """predictions/<contig>/<contig-start-end>/<chunk>/{position,index,
    base_predictions_hp1,base_predictions_hp2} + per-prefix contig_start /
    contig_end — DataStorePredict.py:69-99 (int16 vote counts)."""

    def __init__(self, filename: str, mode: str = "r"):
        self.fh = _h5py().File(filename, mode)
        self._prefixes = set()
        self._names = set()

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_prediction_hp(self, contig, contig_start, contig_end, chunk_id,
                            position, index, base_predictions_hp1,
                            base_predictions_hp2) -> None:
        prefix = f"{contig}-{contig_start}-{contig_end}"
        name = f"{prefix}-{chunk_id}"
        base = f"predictions/{contig}/{prefix}"
        if prefix not in self._prefixes:
            self._prefixes.add(prefix)
            self.fh[f"{base}/contig_start"] = contig_start
            self.fh[f"{base}/contig_end"] = contig_end
        if name in self._names:
            return
        self._names.add(name)
        g = self.fh.create_group(f"{base}/{chunk_id}")
        g["position"] = np.asarray(position, dtype=np.int32)
        g["index"] = np.asarray(index, dtype=np.int32)
        g["base_predictions_hp1"] = np.asarray(
            base_predictions_hp1).astype(np.int16)
        g["base_predictions_hp2"] = np.asarray(
            base_predictions_hp2).astype(np.int16)

    def iter_predictions(self) -> Iterator[Dict]:
        if "predictions" not in self.fh:
            return
        for contig in sorted(self.fh["predictions"].keys()):
            for prefix in sorted(self.fh[f"predictions/{contig}"].keys()):
                g = self.fh[f"predictions/{contig}/{prefix}"]
                for chunk in sorted(k for k in g.keys()
                                    if k not in ("contig_start",
                                                 "contig_end")):
                    c = g[chunk]
                    yield {
                        "contig": contig,
                        "contig_start": int(g["contig_start"][()]),
                        "contig_end": int(g["contig_end"][()]),
                        "chunk_id": chunk,
                        "position": c["position"][()],
                        "index": c["index"][()],
                        "base_predictions_hp1":
                            c["base_predictions_hp1"][()],
                        "base_predictions_hp2":
                            c["base_predictions_hp2"][()],
                    }


def hp_image_files(image_dir: str) -> List[str]:
    return sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                  if f.endswith((".hdf", ".hdf5", ".h5")))


# ----------------------------------------------------------------- producer
def make_chunked_hp_images(matrix: np.ndarray, positions: np.ndarray,
                           indices: np.ndarray,
                           seq_length: int = ImageOptionsHP.SEQ_LENGTH,
                           overlap: int = ImageOptionsHP.SEQ_OVERLAP
                           ) -> List[Dict]:
    """Chunk a full-region 48-feature HP matrix into fixed 1000-length
    per-haplotype images (jump = seq_length - overlap, zero-padded tail).

    The 48 features are HP1/HP2 twin blocks (region_summary_hp.h:23-70):
    rows [0,24) carry HP1-routed counts, rows [24,48) HP2-routed. Each
    haplotype image keeps the shared reference row block and zeroes the
    other haplotype's counts. r0.8 has no producer for these images; this
    is our completion of the chain.
    """
    L, F = matrix.shape
    half = F // 2
    chunks = []
    jump = seq_length - overlap
    chunk_id = 0
    for start in range(0, max(1, L), jump):
        end = min(L, start + seq_length)
        img = np.zeros((seq_length, F), matrix.dtype)
        img[: end - start] = matrix[start:end]
        pos = np.full(seq_length, -1, np.int32)
        idx = np.zeros(seq_length, np.int32)
        pos[: end - start] = positions[start:end]
        idx[: end - start] = indices[start:end]
        hp1 = img.copy()
        hp1[:, half:] = 0
        hp2 = img.copy()
        hp2[:, :half] = 0
        chunks.append({"chunk_id": chunk_id, "image_hp1": hp1,
                       "image_hp2": hp2, "position": pos, "index": idx})
        chunk_id += 1
        if end == L:
            break
    return chunks


# ---------------------------------------------------------------- predictor
def make_hp_window_vote_fn(params, num_classes: int,
                           seq_len: int = ImageOptionsHP.SEQ_LENGTH,
                           window: int = TrainOptions.TRAIN_WINDOW,
                           jump: int = TrainOptions.WINDOW_JUMP,
                           hidden_size: int = TrainOptions.HIDDEN_SIZE,
                           device="cuda", fused_rnn: bool = True):
    """(images_hp1, images_hp2) [B,seq,F] -> int32 vote tensors
    [B,seq,num_classes] per haplotype, on `device`.

    `params` is the numpy parameter tree (checkpoint loaders). Reference
    semantics (predict_hp_distributed_cpu.py:44-99), as in the JAX
    package: windows of 100 with jump 50, per-haplotype hidden carried
    across windows, int(softmax * 10000) votes (truncated toward zero)
    summed in int32. The final window is skipped when it would overrun
    seq_len (the `break` at :55-56). The model runs in bf16 on the card
    (f32 with PEPPER_TPU_PRECISION=f32) and in f32 on the CPU; the softmax
    is taken in f32.

    fused_rnn=True runs both biGRU layers through `fused_bigru`: kernel K2
    on the card (it takes hidden sizes up to 128 and raises for more), its
    plain version on the CPU. False runs the step loop (`rnn.gru`), the
    JAX package's scan; it is the tests' reference route.
    """
    dev = resolve_device(device)
    use_bf16 = (os.environ.get("PEPPER_TPU_PRECISION", "bf16") != "f32"
                and dev.type != "cpu")
    cdtype = torch.bfloat16 if use_bf16 else torch.float32
    cparams = params_from_jax(params, dev, cdtype)

    def one_hap(x):
        B = x.shape[0]
        hidden = torch.zeros((B, 2, hidden_size), dtype=cdtype, device=dev)
        votes = torch.zeros((B, seq_len, num_classes), dtype=torch.int32,
                            device=dev)
        for i in range(0, seq_len, jump):
            if i + window > seq_len:
                break
            logits, hidden = polish_forward(cparams, x[:, i:i + window],
                                            hidden, fused_rnn=fused_rnn)
            probs = torch.softmax(logits.float(), dim=2)
            votes[:, i:i + window] += (probs * 10000.0).to(torch.int32)
        return votes

    def fn(images_hp1: torch.Tensor, images_hp2: torch.Tensor):
        with torch.inference_mode():
            return (one_hap(images_hp1.to(dev, cdtype)),
                    one_hap(images_hp2.to(dev, cdtype)))

    return fn


def load_hp_vote_fn(params, num_classes: Optional[int] = None,
                    device="cuda", fused_rnn: bool = True):
    """`make_hp_window_vote_fn` for a polish parameter tree, with
    num_classes from dense1's rows (unless given) and the hidden size from
    the encoder's W_hh, as `predict_hp` reads them."""
    if num_classes is None:
        num_classes = int(np.shape(params["dense1"]["weight"])[0])
    hidden_size = int(np.shape(params["gru_encoder"]["weight_hh_l0"])[1])
    return make_hp_window_vote_fn(params, num_classes,
                                  hidden_size=hidden_size, device=device,
                                  fused_rnn=fused_rnn)


def vote_records(summaries: Iterable[Dict], vote_fn,
                 batch_size: int = 64) -> Iterator[Dict]:
    """The per-chunk vote records of `summaries` (dicts with the keys of
    `HPChunkedImageStore.read_summary`), in batches of `batch_size` padded
    with zero images, as `predict_hp` votes them. The images are taken as
    uint8, the type the image store keeps (a count of -1 from the HP
    encoder's decrements is 255 there, as in the JAX package), so chunks
    fresh from `make_chunked_hp_images` vote as they would from the file.
    Each record has the keys of `HPPredictionStore.iter_predictions`, with
    int32 votes [seq,C]."""
    batch: List[Dict] = []

    def flush():
        x1 = np.stack([np.asarray(m["image_hp1"], np.uint8) for m in batch])
        x2 = np.stack([np.asarray(m["image_hp2"], np.uint8) for m in batch])
        pad = batch_size - len(batch)
        if pad:
            x1 = np.concatenate(
                [x1, np.zeros((pad,) + x1.shape[1:], x1.dtype)])
            x2 = np.concatenate(
                [x2, np.zeros((pad,) + x2.shape[1:], x2.dtype)])
        v1, v2 = vote_fn(torch.from_numpy(x1), torch.from_numpy(x2))
        v1 = v1[:len(batch)].cpu().numpy()
        v2 = v2[:len(batch)].cpu().numpy()
        for meta, p1, p2 in zip(batch, v1, v2):
            yield {"contig": meta["contig"],
                   "contig_start": meta["region_start"],
                   "contig_end": meta["region_end"],
                   "chunk_id": meta["chunk_id"],
                   "position": meta["position"], "index": meta["index"],
                   "base_predictions_hp1": p1, "base_predictions_hp2": p2}

    for meta in summaries:
        batch.append(meta)
        if len(batch) == batch_size:
            yield from flush()
            batch = []
    if batch:
        yield from flush()


class HPPredictionList:
    """Vote records held in memory, read like an `HPPredictionStore`:
    `iter_predictions` yields them in the store's order (contig, then
    region prefix, then chunk id as a string) with the chunk id as a
    string, so `predictions_to_finder_inputs` keeps the same record of
    each overlapping position as it does from the file."""

    def __init__(self, records: Iterable[Dict]):
        self.records = list(records)

    def iter_predictions(self) -> Iterator[Dict]:
        def key(r):
            c = r["contig"]
            return (c, f"{c}-{r['contig_start']}-{r['contig_end']}",
                    str(r["chunk_id"]))

        for rec in sorted(self.records, key=key):
            yield dict(rec, chunk_id=str(rec["chunk_id"]))


def predict_hp(image_dir: str, model_path: str, output_path: str,
               batch_size: int = 64, num_classes: Optional[int] = None,
               device="cuda") -> str:
    """Run the legacy chunked-HP predictor over every HP image chunk (on
    the card unless `device` says otherwise); needs h5py."""
    from pepper_tpu_torch.runtime.inference import _load_model_params

    vote_fn = load_hp_vote_fn(_load_model_params(model_path), num_classes,
                              device)
    pairs = []
    for path in hp_image_files(image_dir):
        with HPChunkedImageStore(path, "r") as store:
            pairs.extend((path, n) for n in store.summary_names())

    def summaries():
        for path, name in pairs:
            with HPChunkedImageStore(path, "r") as store:
                yield store.read_summary(name)

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with HPPredictionStore(output_path, "w") as out:
        for rec in vote_records(summaries(), vote_fn, batch_size):
            out.write_prediction_hp(
                rec["contig"], rec["contig_start"], rec["contig_end"],
                rec["chunk_id"], rec["position"], rec["index"],
                rec["base_predictions_hp1"], rec["base_predictions_hp2"])
    return output_path


# ------------------------------------------------------------------- bridge
def predictions_to_finder_inputs(store
                                 ) -> Tuple[List[int], List[int],
                                            List[List[int]],
                                            List[List[int]]]:
    """Flatten per-chunk HP vote tensors into the (positions, indices,
    base_predictions_h1, base_predictions_h2) lists that
    LegacyCandidateFinderHP.find_candidates consumes; padded (-1) slots
    are dropped, duplicate (position, index) keys keep the first record
    (chunk overlap rule, cf. Stitch.py:64-74). `store` is an
    HPPredictionStore or an HPPredictionList."""
    seen = set()
    positions: List[int] = []
    indices: List[int] = []
    h1: List[List[int]] = []
    h2: List[List[int]] = []
    for rec in store.iter_predictions():
        pos = rec["position"]
        idx = rec["index"]
        p1 = rec["base_predictions_hp1"]
        p2 = rec["base_predictions_hp2"]
        for j in range(len(pos)):
            if pos[j] < 0:
                continue
            key = (int(pos[j]), int(idx[j]))
            if key in seen:
                continue
            seen.add(key)
            positions.append(int(pos[j]))
            indices.append(int(idx[j]))
            h1.append([int(v) for v in p1[j]])
            h2.append([int(v) for v in p2[j]])
    return positions, indices, h1, h2
