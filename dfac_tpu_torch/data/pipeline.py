"""Dense dataset container + static-shape batch iterator.

Counterpart of :mod:`dfac_tpu.data.pipeline`. A corpus is one dense
``[N, F, T]`` numpy array, read from a ``features.pkl`` or memory-mapped
from a ``.npy`` store directory (:mod:`dfac_tpu_torch.io.npy_store`);
batching is index arithmetic. Evaluation keeps every batch at one shape:
the tail is zero-padded and its pad rows carry weight 0, so the scorer
drops them. Training asks for ``shuffle`` and ``pad_tail=False``: the
order is ``np.random.default_rng(seed).shuffle`` of the row ids, as in the
JAX package (so both packages see the same batches), and the final partial
batch comes out at its true size, so its BatchNorm statistics cover real
rows only (the reference's smaller final batch, ``src/train.py:31-91``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from dfac_tpu_torch.io.pickle_io import align_labels, load_features, load_labels


@dataclasses.dataclass
class ArrayDataset:
    """A corpus: uttids + dense stored-orientation features [N, F, T]."""

    uttids: list[str]
    features: np.ndarray  # (N, F, T) float32, stored orientation
    labels: np.ndarray | None = None  # (N,) int32
    lengths: np.ndarray | None = None  # (N,) int32 valid time frames

    def __len__(self) -> int:
        return len(self.uttids)

    def filter_label(self, label: int) -> "ArrayDataset":
        """The rows of one label (reference ``BonafideDataset``,
        ``src/dataset_cae.py:57-86``); the fancy index materializes them,
        also from a memory-mapped store."""
        if self.labels is None:
            raise ValueError("dataset has no labels")
        keep = np.nonzero(self.labels == label)[0]
        return ArrayDataset(
            uttids=[self.uttids[i] for i in keep],
            features=self.features[keep],
            labels=self.labels[keep],
            lengths=None if self.lengths is None else self.lengths[keep],
        )


def load_dataset(
    features_path: str, labels_path: str | None = None, strict: bool = True
) -> ArrayDataset:
    """Load features (+ optionally labels inner-merged on uttid, strict).

    ``features_path`` may be a ``features.pkl`` or a ``.npy`` store
    directory, whose features stay memory-mapped."""
    from dfac_tpu_torch.io.npy_store import is_npy_store, load_npy_dataset

    if is_npy_store(features_path):
        return load_npy_dataset(features_path, labels_path, strict=strict)
    uttids, feats, lengths = load_features(features_path, return_lengths=True)
    labels = None
    if labels_path is not None:
        luttids, raw = load_labels(labels_path)
        labels = align_labels(uttids, luttids, raw, strict=strict)
    return ArrayDataset(uttids=uttids, features=feats, labels=labels, lengths=lengths)


@dataclasses.dataclass
class Batch:
    """One static-shape step input (host numpy)."""

    features: np.ndarray  # (B, F, T) stored orientation
    labels: np.ndarray  # (B,) float32 (zeros if unlabeled)
    weights: np.ndarray  # (B,) float32; 0 marks padding rows
    index: np.ndarray  # (B,) int32 row ids into the dataset (-1 padding)


def pad_to_batch(arr: np.ndarray, batch_size: int, pad_value=0) -> np.ndarray:
    n = arr.shape[0]
    if n == batch_size:
        return arr
    pad = np.full((batch_size - n, *arr.shape[1:]), pad_value, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def batch_iterator(
    ds: ArrayDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int | None = None,
    drop_last: bool = False,
    pad_tail: bool = True,
) -> Iterator[Batch]:
    """Fixed-size batches. With ``pad_tail`` (evaluation) the final partial
    batch is zero-padded with weight 0; with ``pad_tail=False`` (training)
    it comes out at its true size, and ``drop_last`` drops it. A shuffled
    batch is a numpy gather of its rows; an unshuffled one a basic slice (a
    view: a memory-mapped store stays on disk until the batch is read)."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    labels = ds.labels if ds.labels is not None else np.zeros(n, np.int32)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        feats = ds.features[idx] if shuffle else ds.features[start : start + len(idx)]
        labs = labels[idx].astype(np.float32)
        w = np.ones(len(idx), np.float32)
        if not pad_tail:
            yield Batch(features=feats, labels=labs, weights=w, index=idx.astype(np.int32))
            continue
        yield Batch(
            features=pad_to_batch(feats, batch_size),
            labels=pad_to_batch(labs, batch_size),
            weights=pad_to_batch(w, batch_size),
            index=pad_to_batch(idx.astype(np.int32), batch_size, pad_value=-1),
        )


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def create_datasets(
    train_features: str,
    train_labels: str,
    dev_features: str,
    dev_labels: str,
    test_features: str | None = None,
    test_labels: str | None = None,
) -> tuple[ArrayDataset, ArrayDataset, ArrayDataset | None]:
    """Train/dev/test trio loader (reference ``create_dataloaders``,
    ``src/dataloaders.py:8-53``; the test split loads label-free when no
    labels path is given)."""
    train = load_dataset(train_features, train_labels)
    dev = load_dataset(dev_features, dev_labels)
    test = load_dataset(test_features, test_labels) if test_features else None
    return train, dev, test
