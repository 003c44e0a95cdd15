"""Checkpoint score ensembling.

Counterpart of :mod:`dfac_tpu.ensemble.mean`; parity target reference
``src/ensemble.py``: N ``arch:path`` checkpoints score one unshuffled split
with sigmoid probabilities, the ensemble is their plain mean. The port
scores a checkpoint of any registry classifier with its f32 eval model,
built at the widths of the checkpoint's weights.
"""

from __future__ import annotations

import numpy as np
import torch

from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.models import check_model_name, model_from_state_dict
from dfac_tpu_torch.train.checkpoint import load_model_variables
from dfac_tpu_torch.train.evaluate import predict_scores


def score_checkpoints(
    specs: list[tuple[str, str]],
    ds: ArrayDataset,
    batch_size: int = 128,
    swap_tf: bool = True,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """``specs``: (arch, checkpoint path) pairs. Returns sigmoid scores per
    spec keyed ``"{arch}:{path}"``; a spec listed k times gets ``#2``, ...
    suffixes, so the mean weights it k times as the reference's list does
    (``src/ensemble.py:106-121``). ``device`` as
    :func:`~dfac_tpu_torch.device.resolve_device` (default ``cuda``).
    Each model is built at its checkpoint's widths (the JAX function's
    ``in_features`` is the data's, which flax reads itself)."""
    for arch, _ in specs:  # every name before any checkpoint is read
        check_model_name(arch)
    dev = device if isinstance(device, torch.device) else resolve_device(device)
    out = {}
    for arch, path in specs:
        model = model_from_state_dict(arch, load_model_variables(path, model_name=arch))
        key = base = f"{arch}:{path}"
        k = 2
        while key in out:
            key = f"{base}#{k}"
            k += 1
        out[key] = predict_scores(model.to(dev), ds, batch_size=batch_size, swap_tf=swap_tf, apply_sigmoid=True)
    return out


def ensemble_scores(per_model_scores: dict[str, np.ndarray] | list[np.ndarray]) -> np.ndarray:
    """Simple mean across models (reference ``src/ensemble.py:121``)."""
    arrs = list(per_model_scores.values()) if isinstance(per_model_scores, dict) else list(per_model_scores)
    if not arrs:
        raise ValueError("no scores to ensemble")
    return np.mean(np.stack(arrs, axis=0), axis=0)
