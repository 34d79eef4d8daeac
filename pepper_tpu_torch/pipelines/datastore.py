"""Stage-boundary stores (HDF5), schema-compatible with the reference.

Image store:   summaries/<name>/{contigs,positions,depths,candidates,
               candidate_frequency,images[,base_labels,type_label]}
               (reference pepper_variant/modules/python/DataStore.py:54-71)
Prediction:    predictions/batch_<n>/{contigs,positions,depths,candidates,
               candidate_frequency,base_prediction}
               (reference DataStorePredict.py:49-67)

Every stage is files-in -> files-out, so each subcommand stays independently
runnable and re-runnable (the de-facto checkpoint system, SURVEY.md §5.4).

h5py is imported only when a store is opened: the streamed call_variant path
runs without it (it then skips the prediction artifact, see
runtime/streaming.py), while the staged path and kept image artifacts need
it and raise `ModuleNotFoundError` with the reason.
"""
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.region_encoder import CandidateBatch, CandidateImage


def h5py_available() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ModuleNotFoundError(
            "h5py is not installed: the HDF5 image/prediction stores (the "
            "staged call_variant path, run_inference, find_candidates and "
            "--keep_image_artifacts) need it") from exc
    return h5py


def _vlen_str():
    return _h5py().special_dtype(vlen=str)


def _decode_strs(row) -> List[str]:
    return [s.decode() if isinstance(s, bytes) else str(s) for s in row]


def stack_images(candidates: Sequence[CandidateImage]) -> np.ndarray:
    """np.stack of per-candidate images, with a zero-copy fast path.

    The native encoder hands out views into one contiguous [n, W, F]
    buffer; stacking tens of thousands of small views through np.stack
    dominates the host stage. When every image is the i-th consecutive
    row of the same base array, return a slice of that base instead."""
    if isinstance(candidates, CandidateBatch):
        return candidates.images
    imgs = [c.image for c in candidates]
    base = imgs[0].base
    if (base is not None and base.ndim == 3
            and base.shape[1:] == imgs[0].shape and base.flags.c_contiguous):
        addr0 = base.__array_interface__["data"][0]
        row_bytes = base.strides[0]
        start = (imgs[0].__array_interface__["data"][0] - addr0)
        if start % row_bytes == 0:
            start //= row_bytes
            expect = addr0 + start * row_bytes
            for im in imgs:
                if (im.base is not base or im.shape != base.shape[1:]
                        or im.__array_interface__["data"][0] != expect):
                    break
                expect += row_bytes
            else:
                if start + len(imgs) <= base.shape[0]:
                    return base[start:start + len(imgs)]
    return np.stack(imgs)


class ImageStore:
    """Writer/reader for candidate-image summary files (*.h5)."""

    def __init__(self, filename: str, mode: str = "r"):
        self.filename = filename
        self.fh = _h5py().File(filename, mode)

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_summary(self, summary_name: str,
                      candidates: Sequence[CandidateImage],
                      train_mode: bool = False) -> None:
        if not candidates:
            return
        g = self.fh.create_group(f"summaries/{summary_name}")
        if isinstance(candidates, CandidateBatch):
            b = candidates
            n = len(b)
            contig_b = b.contig.encode()
            contigs = np.full(n, contig_b, dtype=f"S{max(1, len(contig_b))}")
            positions = b.positions.astype(np.int32, copy=False)
            depths = b.depths.astype(np.uint8)
            cand_lists = np.empty((n, 1), dtype=object)
            cand_lists[:, 0] = b.candidates
            freqs = b.candidate_frequency.astype(np.uint8).reshape(n, 1)
            if train_mode:
                base_labels = b.base_labels.astype(np.uint8)
                type_labels = b.type_labels.astype(np.uint8)
        else:
            contigs = np.array([c.contig for c in candidates], dtype="S")
            positions = np.array([c.position for c in candidates],
                                 dtype=np.int32)
            depths = np.array([c.depth for c in candidates], dtype=np.uint8)
            cand_lists = np.array([c.candidates for c in candidates],
                                  dtype=object)
            freqs = np.array([c.candidate_frequency for c in candidates],
                             dtype=np.uint8)
            if train_mode:
                base_labels = np.array([c.base_label for c in candidates],
                                       dtype=np.uint8)
                type_labels = np.array([c.type_label for c in candidates],
                                       dtype=np.uint8)
        g.create_dataset("contigs", data=contigs)
        g.create_dataset("positions", data=positions)
        g.create_dataset("depths", data=depths)
        g.create_dataset("candidates", data=cand_lists, dtype=_vlen_str())
        g.create_dataset("candidate_frequency", data=freqs)
        g.create_dataset("images",
                         data=stack_images(candidates).astype(np.int8,
                                                              copy=False))
        if train_mode:
            g.create_dataset("base_labels", data=base_labels)
            g.create_dataset("type_label", data=type_labels)

    def summary_names(self) -> List[str]:
        return list(self.fh["summaries"].keys()) if "summaries" in self.fh else []

    def read_summary(self, summary_name: str, train_mode: bool = False):
        g = self.fh[f"summaries/{summary_name}"]
        out = dict(
            contigs=[c.decode() for c in g["contigs"][()]],
            positions=g["positions"][()],
            depths=g["depths"][()],
            candidates=[_decode_strs(row) for row in g["candidates"][()]],
            candidate_frequency=g["candidate_frequency"][()],
            images=g["images"][()],
        )
        if train_mode and "base_labels" in g:
            out["base_labels"] = g["base_labels"][()]
            out["type_label"] = g["type_label"][()]
        return out


@dataclass
class PredictionBatch:
    contigs: List[str]
    positions: np.ndarray
    depths: np.ndarray
    candidates: List[List[str]]
    candidate_frequency: np.ndarray
    base_prediction: np.ndarray    # [N, 3] float


class PredictionStore:
    """Writer/reader for per-batch prediction files (*.h5)."""

    def __init__(self, filename: str, mode: str = "r"):
        self.filename = filename
        self.fh = _h5py().File(filename, mode)

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write_prediction(self, batch_no: int, contigs, positions, depths,
                         candidates, candidate_frequency,
                         base_predictions) -> None:
        g = self.fh.create_group(f"predictions/batch_{batch_no}")
        g.create_dataset("contigs", data=np.array(contigs, dtype="S"))
        g.create_dataset("positions", data=np.asarray(positions, np.int32))
        g.create_dataset("depths", data=np.asarray(depths, np.uint8))
        g.create_dataset("candidates", data=np.array(candidates, dtype=object),
                         dtype=_vlen_str())
        g.create_dataset("candidate_frequency",
                         data=np.asarray(candidate_frequency, np.uint8))
        g.create_dataset("base_prediction",
                         data=np.asarray(base_predictions, np.float64))

    def batch_names(self) -> List[str]:
        return (list(self.fh["predictions"].keys())
                if "predictions" in self.fh else [])

    def read_batch(self, name: str) -> PredictionBatch:
        g = self.fh[f"predictions/{name}"]
        return PredictionBatch(
            contigs=[c.decode() for c in g["contigs"][()]],
            positions=g["positions"][()],
            depths=g["depths"][()],
            candidates=[_decode_strs(row) for row in g["candidates"][()]],
            candidate_frequency=g["candidate_frequency"][()],
            base_prediction=g["base_prediction"][()])


def iter_prediction_batches(files: Sequence[str]) -> Iterator[Tuple[str, str]]:
    """(file, batch) pairs across prediction files (FindCandidates.py:156-166)."""
    for path in files:
        with PredictionStore(path, "r") as store:
            for name in store.batch_names():
                yield path, name
