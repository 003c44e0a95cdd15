"""Memory-mapped corpus store: a directory of plain ``.npy`` arrays.

Counterpart of :mod:`dfac_tpu.io.npy_store`, with the same file names and
dtypes, so a store written by either package opens in the other. A pickled
``features.pkl`` cannot be memory-mapped; a store's feature tensor opens
with ``np.load(..., mmap_mode="r")``, and batches stream from the page
cache with O(batch) resident memory.

Layout of ``<dir>/``:

* ``features.npy`` — (N, F, T) float32
* ``uttids.npy``   — (N,) unicode
* ``labels.npy``   — (N,) int32 (absent for unlabeled corpora)
* ``lengths.npy``  — (N,) int32 true frame counts (absent if fixed-length)

:func:`dfac_tpu_torch.data.pipeline.load_dataset` routes a store directory
here, so ``predict`` takes either a ``features.pkl`` or a store.
"""

from __future__ import annotations

import os

import numpy as np

FEATURES = "features.npy"
UTTIDS = "uttids.npy"
LABELS = "labels.npy"
LENGTHS = "lengths.npy"


def save_npy_dataset(ds, out_dir: str) -> None:
    """Write an :class:`~dfac_tpu_torch.data.pipeline.ArrayDataset` as a store."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, FEATURES), np.ascontiguousarray(ds.features))
    np.save(os.path.join(out_dir, UTTIDS), np.asarray(ds.uttids))
    if ds.labels is not None:
        np.save(os.path.join(out_dir, LABELS), np.asarray(ds.labels, np.int32))
    if ds.lengths is not None:
        np.save(os.path.join(out_dir, LENGTHS), np.asarray(ds.lengths, np.int32))


def is_npy_store(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, FEATURES))


def load_npy_dataset(path: str, labels_path: str | None = None, strict: bool = True):
    """Open a store; its features stay memory-mapped (read-only).

    ``labels_path`` may name a second store directory or a ``labels.pkl``
    to inner-merge on uttid (strict, like the pickle path); without it the
    store's own ``labels.npy`` is used when present."""
    from dfac_tpu_torch.data.pipeline import ArrayDataset
    from dfac_tpu_torch.io.pickle_io import align_labels, load_labels

    feats = np.load(os.path.join(path, FEATURES), mmap_mode="r")
    uttids = [str(u) for u in np.load(os.path.join(path, UTTIDS))]
    lengths = None
    if os.path.exists(os.path.join(path, LENGTHS)):
        lengths = np.load(os.path.join(path, LENGTHS))
    labels = None
    if labels_path is not None:
        if is_npy_store(labels_path):
            luttids = [str(u) for u in np.load(os.path.join(labels_path, UTTIDS))]
            raw = np.load(os.path.join(labels_path, LABELS))
        else:
            luttids, raw = load_labels(labels_path)
        labels = align_labels(uttids, luttids, raw, strict=strict)
    elif os.path.exists(os.path.join(path, LABELS)):
        labels = np.load(os.path.join(path, LABELS))
    return ArrayDataset(uttids=uttids, features=feats, labels=labels, lengths=lengths)
