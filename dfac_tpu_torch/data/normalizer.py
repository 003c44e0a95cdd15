"""Per-feature-dim z-score corpus normalizer.

Counterpart of :mod:`dfac_tpu.data.normalizer`; parity target reference
``src/dataset_cae.py:20-52``: statistics over the concatenated time frames
of **bonafide-only** training utterances in (T, F) orientation, ``mean``
and ``std`` of shape (F,), ``std`` the *unbiased* (N - 1) estimator
clamped to >= 1e-8; ``transform`` broadcasts over (T, F) or (B, T, F).

numpy throughout, as in the JAX package: the statistics are host state,
fitted once; the chains move them to the device. Persistence is ``.npz``;
the reference's ``normalizer.pt`` sidecar loads through
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import numpy as np
import torch


class FeatureNormalizer:
    """mean/std over (F,), fit on (N, T, F) or a list of (T, F) arrays."""

    def __init__(self, mean: np.ndarray | None = None, std: np.ndarray | None = None):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def fit(self, features, lengths: np.ndarray | None = None) -> "FeatureNormalizer":
        """``features``: (N, T, F) array or list of (T, F) arrays (the frames
        of all utterances pooled along time, as ``torch.cat`` pools them).

        ``lengths`` (optional, array input only): the true frame counts of a
        padded variable-length corpus; pad frames are left out, as the
        reference concatenates true-length tensors
        (``src/dataset_cae.py:120-141``).

        The two moments accumulate in float64 over bounded row slabs, so a
        memory-mapped corpus streams through and no float64 copy of it is
        made."""
        if isinstance(features, (list, tuple)):
            slabs = (np.asarray(f).reshape(-1, np.asarray(f).shape[-1]) for f in features)
        else:
            arr = features
            t_dim = arr.shape[1]

            def gen():
                slab_rows = max(1, (1 << 24) // max(arr.shape[1] * arr.shape[2], 1))
                for i in range(0, arr.shape[0], slab_rows):
                    slab = np.asarray(arr[i : i + slab_rows])
                    if lengths is not None:
                        mask = np.arange(t_dim)[None, :] < np.asarray(lengths)[i : i + slab_rows, None]
                        yield slab.reshape(-1, slab.shape[-1])[mask.reshape(-1)]
                    else:
                        yield slab.reshape(-1, slab.shape[-1])

            slabs = gen()
        s1 = s2 = None
        n = 0
        for slab in slabs:
            if s1 is None:
                s1 = np.zeros(slab.shape[-1], np.float64)
                s2 = np.zeros(slab.shape[-1], np.float64)
            slab64 = slab.astype(np.float64)  # one slab at a time
            s1 += slab64.sum(axis=0)
            s2 += np.square(slab64).sum(axis=0)
            n += slab.shape[0]
        if not n:
            raise ValueError("cannot fit a normalizer on zero frames")
        mean = s1 / n
        # unbiased variance (torch's .std default), clamped as the reference
        var = np.maximum(s2 - n * np.square(mean), 0.0) / max(n - 1, 1)
        self.mean = mean.astype(np.float32)
        self.std = np.maximum(np.sqrt(var), 1e-8).astype(np.float32)
        return self

    def transform(self, x):
        if self.mean is None:
            raise RuntimeError("Call .fit() first")
        return (x - self.mean) / self.std

    def inverse_transform(self, x):
        if self.mean is None:
            raise RuntimeError("Call .fit() first")
        return x * self.std + self.mean

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz", mean=self.mean, std=self.std)

    @classmethod
    def load(cls, path: str) -> "FeatureNormalizer":
        if path.endswith(".pt"):
            return cls.load_torch(path)
        with np.load(path if path.endswith(".npz") else path + ".npz") as data:
            return cls(mean=data["mean"], std=data["std"])

    @classmethod
    def load_torch(cls, path: str) -> "FeatureNormalizer":
        """Read the reference's ``normalizer.pt`` ``{mean, std}`` sidecar
        (``src/dataset_cae.py:43-52``)."""
        data = torch.load(path, map_location="cpu", weights_only=True)
        return cls(mean=np.asarray(data["mean"]), std=np.asarray(data["std"]))


def apply_utterance_norm(features: np.ndarray, scheme: str) -> np.ndarray:
    """Per-utterance normalization of the normalization study (reference
    ``src/compare_normalization.py:38-65``) on the stored (N, F, T)
    orientation, over time:

    * ``raw``: identity;
    * ``cmn``: x - mean_t(x) per feature row;
    * ``cvmn``: (x - mean_t) / clamp(std_t, 1e-8), torch's unbiased std
      (ddof=1), clamped rather than added to (``:59-62``).
    """
    if scheme == "raw":
        return features
    mean = features.mean(axis=-1, keepdims=True)
    if scheme == "cmn":
        return features - mean
    if scheme == "cvmn":
        std = features.std(axis=-1, keepdims=True, ddof=1)
        return (features - mean) / np.maximum(std, 1e-8)
    raise ValueError(f"unknown normalization scheme '{scheme}' (raw|cmn|cvmn)")


def build_normalizer(
    features: np.ndarray,
    labels: np.ndarray | None,
    swap_tf: bool = True,
    lengths: np.ndarray | None = None,
) -> FeatureNormalizer:
    """Fit on the bonafide rows of a stored-orientation (N, F, T) corpus
    (reference ``src/dataset_cae.py:120-141``); with ``swap_tf`` the
    statistics are per feature dim. ``labels=None`` means the corpus is
    bonafide-only already, and every row is used."""
    if labels is None:
        bona, blen = features, lengths
    else:
        keep = np.asarray(labels) == 1
        bona = features[keep]
        blen = None if lengths is None else np.asarray(lengths)[keep]
    if swap_tf:
        bona = np.transpose(bona, (0, 2, 1))  # (N, T, F)
    return FeatureNormalizer().fit(bona, lengths=blen)
