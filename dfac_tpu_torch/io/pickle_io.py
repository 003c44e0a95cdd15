"""Pickled-DataFrame I/O contract.

Counterpart of :mod:`dfac_tpu.io.pickle_io`. The public data surface is the
reference project's (``README.md:28-103``):

* ``features.pkl`` — DataFrame, columns ``uttid`` (str) and ``features``
  (per-row tensor ``[180, 321]`` = [feature, time]);
* ``labels.pkl`` — ``uttid`` and ``label`` in {0, 1} (1 = bonafide);
* ``prediction.pkl`` — ``uttid`` and ``predictions`` (float).

The features extractor writes ``features.pkl`` through :func:`write_features`.

The reference stores ``torch.Tensor`` cells; with torch installed,
``pd.read_pickle`` reads them natively. Loaders return dense numpy arrays
(uttids + one ``[N, F, T]`` float32 array); moving them to a device is the
caller's explicit step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pandas as pd
import torch


def _cell_to_numpy(cell: Any) -> np.ndarray:
    if isinstance(cell, torch.Tensor):
        return cell.detach().cpu().numpy()
    return np.asarray(cell)


def load_features(
    path: str, dtype=np.float32, return_lengths: bool = False
) -> tuple[list[str], np.ndarray] | tuple[list[str], np.ndarray, np.ndarray | None]:
    """Load ``features.pkl`` into ``(uttids, array[N, F, T])`` (stored
    orientation, no transpose). With ``return_lengths``, also the true time
    length of each row of a variable-length corpus (None when all rows
    share one shape; shorter rows are right-padded with zeros)."""
    df = pd.read_pickle(path)
    if "uttid" not in df.columns or "features" not in df.columns:
        raise ValueError(f"{path}: features.pkl must have 'uttid' and 'features' columns")
    uttids = [str(u) for u in df["uttid"].tolist()]
    mats = [_cell_to_numpy(c).astype(dtype, copy=False) for c in df["features"]]
    if not mats:  # the reference refuses it too (IndexError on mats[0])
        raise ValueError(f"{path}: features.pkl has no rows")
    lengths = None
    if len({m.shape for m in mats}) == 1:
        feats = np.stack(mats).astype(dtype, copy=False)
    else:
        f_dim = mats[0].shape[0]
        t_max = max(m.shape[1] for m in mats)
        feats = np.zeros((len(mats), f_dim, t_max), dtype=dtype)
        lengths = np.zeros(len(mats), np.int32)
        for i, m in enumerate(mats):
            feats[i, :, : m.shape[1]] = m
            lengths[i] = m.shape[1]
    if return_lengths:
        return uttids, feats, lengths
    return uttids, feats


def load_feature_lengths(path: str) -> np.ndarray:
    """Per-utterance time lengths (for variable-length corpora)."""
    df = pd.read_pickle(path)
    return np.asarray([_cell_to_numpy(c).shape[1] for c in df["features"]], dtype=np.int32)


def load_labels(path: str) -> tuple[list[str], np.ndarray]:
    df = pd.read_pickle(path)
    if "uttid" not in df.columns or "label" not in df.columns:
        raise ValueError(f"{path}: labels.pkl must have 'uttid' and 'label' columns")
    return [str(u) for u in df["uttid"].tolist()], df["label"].to_numpy().astype(np.int32)


def load_predictions(path: str) -> tuple[list[str], np.ndarray]:
    df = pd.read_pickle(path)
    if "uttid" not in df.columns or "predictions" not in df.columns:
        raise ValueError(f"{path}: prediction.pkl must have 'uttid' and 'predictions' columns")
    return [str(u) for u in df["uttid"].tolist()], df["predictions"].to_numpy().astype(np.float64)


def align_labels(
    feat_uttids: list[str], label_uttids: list[str], labels: np.ndarray, strict: bool = True
) -> np.ndarray:
    """Labels reordered to ``feat_uttids`` (inner-merge semantics of the
    reference datasets, ``src/dataset.py:24-30``). Duplicated label uttids
    and features without a label always raise; ``strict`` also rejects
    extra labels (reference ``src/evaluation.py:107-124``)."""
    if len(set(label_uttids)) != len(label_uttids):
        from collections import Counter

        dup, cnt = Counter(label_uttids).most_common(1)[0]
        raise ValueError(
            f"labels file has duplicated uttids (e.g. {dup!r} x{cnt}) — "
            "each uttid must carry exactly one label"
        )
    lab_map = dict(zip(label_uttids, labels.tolist()))
    missing = [u for u in feat_uttids if u not in lab_map]
    if strict and (missing or len(lab_map) != len(feat_uttids)):
        raise ValueError(
            f"uttid mismatch between features and labels: {len(missing)} features missing labels, "
            f"{len(lab_map)} labels for {len(feat_uttids)} features"
        )
    if missing:
        raise ValueError(
            f"{len(missing)} feature uttids have no label (e.g. {missing[0]!r})"
        )
    return np.asarray([lab_map[u] for u in feat_uttids], dtype=np.int32)


def verify_uttid_alignment(features_path: str, labels_path: str) -> None:
    """Strict features/labels uttid agreement check; raises on any mismatch
    (reference ``src/evaluation.py:107-124``). Reads only the uttid columns."""
    fdf = pd.read_pickle(features_path)
    ldf = pd.read_pickle(labels_path)
    for df, name in ((fdf, "features.pkl"), (ldf, "labels.pkl")):
        if "uttid" not in df.columns:
            raise ValueError(f"{name} must contain 'uttid'")
    if set(fdf["uttid"]) != set(ldf["uttid"]) or len(fdf) != len(ldf):
        raise ValueError("uttid mismatch between features and labels")


def write_predictions(path: str, uttids: list[str], scores) -> pd.DataFrame:
    """Write ``prediction.pkl`` as the reference consumers read it
    (``scripts/evaluation.py`` / ``scripts/generate_submission.py``)."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    if len(scores) != len(uttids):
        raise ValueError(f"{len(scores)} predictions for {len(uttids)} uttids")
    df = pd.DataFrame({"uttid": uttids, "predictions": scores})
    df.to_pickle(path)
    return df


def write_features(path: str, uttids: list[str], features: np.ndarray, tensor_format: str = "auto") -> None:
    """Write a ``features.pkl`` (the feature-extraction CLI's output).

    ``tensor_format='torch'`` stores ``torch.Tensor`` cells (bit-compatible
    with the reference corpus); ``'numpy'`` stores numpy arrays; ``'auto'``
    is torch, which this package always has."""
    if tensor_format in ("auto", "torch"):
        cells = [torch.from_numpy(np.ascontiguousarray(m)) for m in features]
    else:
        cells = [np.ascontiguousarray(m) for m in features]
    pd.DataFrame({"uttid": uttids, "features": cells}).to_pickle(path)
