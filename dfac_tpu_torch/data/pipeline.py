"""Dense dataset container + static-shape batch iterator.

Counterpart of :mod:`dfac_tpu.data.pipeline` (the serving half: no
shuffle, pickled corpora only). A corpus is one dense ``[N, F, T]`` numpy
array; batching is index arithmetic. Evaluation keeps every batch at one
shape: the tail is zero-padded and its pad rows carry weight 0, so the
scorer drops them.
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


def load_dataset(
    features_path: str, labels_path: str | None = None, strict: bool = True
) -> ArrayDataset:
    """Load a ``features.pkl`` (+ optionally labels inner-merged on uttid)."""
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


def batch_iterator(ds: ArrayDataset, batch_size: int) -> Iterator[Batch]:
    """Fixed-size batches in dataset order; the final partial batch is
    zero-padded with weight 0, so every batch has one shape."""
    n = len(ds)
    labels = ds.labels if ds.labels is not None else np.zeros(n, np.int32)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        feats = ds.features[start : start + len(idx)]  # basic slice: a view
        labs = labels[idx].astype(np.float32)
        w = np.ones(len(idx), np.float32)
        yield Batch(
            features=pad_to_batch(feats, batch_size),
            labels=pad_to_batch(labs, batch_size),
            weights=pad_to_batch(w, batch_size),
            index=pad_to_batch(idx.astype(np.int32), batch_size, pad_value=-1),
        )
