"""Bounded-RAM training data loader (windowed shuffle buffer over HDF5).

The reference's dataloader eagerly loads every image into RAM
(pepper_variant/modules/python/models/dataloader.py:29-74) — a WGS-scale
training set cannot fit. This loader scans the image stores once for a
(file, summary, n_rows) index, then streams summaries through a fixed-size
shuffle buffer:

- dataset fits the buffer  -> degrades EXACTLY to the eager path: all
  examples in load order + the same per-epoch `rng.permutation(n)`
  batching, so small-data loss trajectories are bit-identical to the old
  `load_all_summaries` flow (CI-enforced, tests/test_train.py);
- dataset exceeds the buffer -> per-epoch shuffled summary order feeding
  a windowed shuffle buffer; RSS stays within `buffer_bytes` regardless
  of dataset size.

Copy of pepper_tpu/train/dataloader.py with the imports rewritten and one
addition: `ShuffleBufferLoader.from_arrays` builds the eager path from
arrays already in memory (no HDF5 store, so no h5py is needed).
"""
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.pipelines.datastore import ImageStore
from pepper_tpu_torch.runtime.inference import image_files


class ShuffleBufferLoader:
    def __init__(self, image_dir, batch_size: int,
                 buffer_bytes: int = 512 << 20, train_mode: bool = True):
        self.batch_size = batch_size
        self.train_mode = train_mode
        self.files: List[str] = (
            list(image_dir) if isinstance(image_dir, (list, tuple))
            else image_files(image_dir))
        # metadata-only index pass: group names + row counts (no image data)
        self.index: List[Tuple[str, str, int]] = []
        bytes_per_example = None
        self.example_shape: Optional[Tuple[int, ...]] = None
        for path in self.files:
            with ImageStore(path, "r") as store:
                for name in store.summary_names():
                    g = store.fh[f"summaries/{name}"]
                    n = g["positions"].shape[0]
                    if bytes_per_example is None and n:
                        img = g["images"]
                        self.example_shape = tuple(img.shape[1:])
                        bytes_per_example = (
                            int(np.prod(img.shape[1:])) * img.dtype.itemsize
                            + 8)
                    self.index.append((path, name, int(n)))
        self.n_examples = sum(n for _, _, n in self.index)
        bpe = bytes_per_example or 1
        # cap//2 must hold >= one batch or the drain loop could stall
        self.buffer_examples = max(2 * batch_size, buffer_bytes // bpe)
        self._eager: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if self.n_examples and self.n_examples <= self.buffer_examples:
            self._eager = self._load_all()

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray,
                    batch_size: int) -> "ShuffleBufferLoader":
        """A loader on the eager path over (images [N,T,F], labels [N])
        held in memory: the same per-epoch `rng.permutation(n)` batching,
        remainder dropped."""
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self = cls.__new__(cls)
        self.batch_size = batch_size
        self.train_mode = True
        self.files = []
        self.index = []
        self.example_shape = tuple(images.shape[1:])
        self.n_examples = len(images)
        self.buffer_examples = max(2 * batch_size, len(images))
        self._eager = ((images, np.asarray(labels).astype(np.int32))
                       if len(images) else None)
        return self

    # ---- eager small-data path (identical to load_all_summaries order) ----
    def _load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        images, labels = [], []
        for path in self.files:
            with ImageStore(path, "r") as store:
                for name in store.summary_names():
                    s = store.read_summary(name, train_mode=self.train_mode)
                    images.append(s["images"])
                    if self.train_mode:
                        if "type_label" not in s:
                            raise ValueError(
                                f"unlabeled summary {name} in training data")
                        labels.append(s["type_label"])
        x = np.concatenate(images)
        y = (np.concatenate(labels).astype(np.int32) if labels
             else np.zeros(len(x), np.int32))
        return x, y

    def eager_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(images, labels) when the dataset fits the buffer, else None
        (used by eval, which needs the full set)."""
        return self._eager

    def _read_summary(self, path: str, name: str):
        with ImageStore(path, "r") as store:
            s = store.read_summary(name, train_mode=self.train_mode)
        y = (s["type_label"].astype(np.int32) if "type_label" in s
             else np.zeros(len(s["images"]), np.int32))
        return s["images"], y

    def epoch_batches(self, rng: np.random.RandomState
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images_int, labels) batches for one epoch (remainder
        dropped, matching the eager `_batches` contract)."""
        if self._eager is not None:
            x, y = self._eager
            order = rng.permutation(len(x))
            for lo in range(0, len(x) - self.batch_size + 1,
                            self.batch_size):
                idx = order[lo:lo + self.batch_size]
                yield x[idx], y[idx]
            return

        # Windowed block-shuffle buffer: shuffled summary order feeds a
        # preallocated buffer; when full, a permutation is drawn and the
        # first half leaves as batches (mixing spans window boundaries),
        # the rest compacts to the front. O(1) amortized per example,
        # RSS bounded by the buffer. Every example is emitted exactly
        # once per epoch (the final sub-batch-size tail is dropped,
        # matching the eager path's drop-remainder contract).
        summary_order = rng.permutation(len(self.index))
        cap = self.buffer_examples
        B = self.batch_size
        buf_x = buf_y = None
        fill = 0

        def drain(final: bool):
            nonlocal fill
            perm = rng.permutation(fill)
            n_out = fill if final else cap // 2
            n_out = (n_out // B) * B
            for lo in range(0, n_out, B):
                idx = perm[lo:lo + B]
                yield buf_x[idx], buf_y[idx]
            keep = perm[n_out:]
            buf_x[:len(keep)] = buf_x[keep]
            buf_y[:len(keep)] = buf_y[keep]
            fill = len(keep)

        for si in summary_order:
            path, name, n = self.index[si]
            if not n:
                continue
            x, y = self._read_summary(path, name)
            if buf_x is None:
                buf_x = np.empty((cap,) + x.shape[1:], x.dtype)
                buf_y = np.empty(cap, np.int32)
            while len(x):
                put = min(cap - fill, len(x))
                buf_x[fill:fill + put] = x[:put]
                buf_y[fill:fill + put] = y[:put]
                fill += put
                x, y = x[put:], y[put:]
                if fill == cap:
                    yield from drain(final=False)
        if buf_x is not None and fill:
            yield from drain(final=True)
