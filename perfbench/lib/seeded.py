"""Weights, BatchNorm statistics and corpora made from the run's seed, on the device.

Frozen copies of the program's helpers, drawn here in a few large calls
with a ``torch.Generator`` on the card instead of leaf by leaf on the host:

* :func:`state_dict` follows ``dfac_tpu_torch/chain_rates.py:random_cnn2d``
  (torch's default init: every weight and bias uniform in ``±1/sqrt(fan_in)``)
  and ``seed_batchnorm`` (running mean in ±0.2, running variance in
  [0.5, 2], scale in [0.5, 1.5], shift in ±0.1);
* :func:`labeled_corpus` follows ``dfac_tpu_torch/train/rates.py:synthetic_dataset``
  (N(0, 1) features whose first ``min(60, F)`` rows carry a per-utterance
  offset ``0.2 * label + 0.1 * N(0, 1)``: the classes overlap, so a trained
  model's EER is not 0; labels alternate 0, 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SHIFT, SPREAD = 0.2, 0.1  # the classes' offset and its spread (train/rates.py)
OFFSET_ROWS = 60  # the LFCC block of the 180 features
BN_RANGES = {"running_mean": (-0.2, 0.2), "running_var": (0.5, 2.0), "weight": (0.5, 1.5), "bias": (-0.1, 0.1)}


def state_dict(leaves: dict, gen: torch.Generator, device) -> dict:
    """f32 tensors on ``device`` for ``leaves`` (name -> ``(shape, rule)``;
    rule ``("fan_in", n)`` for torch's default init, uniform in
    ``±1/sqrt(n)``; ``("he", n)`` for He's uniform init, ``±sqrt(6/n)``;
    ``("bn", field)`` for BatchNorm; ``("count",)`` for
    ``num_batches_tracked``), all drawn from one uniform vector."""
    drawn = [(k, s, r) for k, (s, r) in leaves.items() if r[0] != "count"]
    sizes = [math.prod(s) for _, s, _ in drawn]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, rule), n in zip(drawn, sizes):
        if rule[0] == "bn":
            lo, hi = BN_RANGES[rule[1]]
        else:
            hi = math.sqrt((6.0 if rule[0] == "he" else 1.0) / rule[1])
            lo = -hi
        out[name] = (lo + (hi - lo) * u[at : at + n]).reshape(shape)
        at += n
    for name, (shape, rule) in leaves.items():
        if rule[0] == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {name: out[name] for name in leaves}


def labeled_corpus(n: int, in_features: int, frames: int, gen: torch.Generator, device) -> tuple:
    """``(features, labels)``: (n, F, T) f32 stored-orientation features on
    ``device`` and (n,) int32 labels on the host."""
    feats = torch.randn((n, in_features, frames), generator=gen, device=device)
    labels = np.arange(n) % 2
    offset = SHIFT * torch.as_tensor(labels, dtype=torch.float32, device=device)
    offset = offset + SPREAD * torch.randn(n, generator=gen, device=device)
    feats[:, : min(OFFSET_ROWS, in_features), :] += offset[:, None, None]
    return feats, labels.astype(np.int32)


def host_dataset(feats: torch.Tensor, labels: np.ndarray, tag: str):
    """The program's in-memory corpus (``ArrayDataset``) over a host copy of ``feats``."""
    from dfac_tpu_torch.data.pipeline import ArrayDataset

    host = feats.cpu().numpy()
    return ArrayDataset(uttids=[f"{tag}{i:06d}" for i in range(len(labels))], features=host, labels=labels)


def bonafide_normalizer(feats: torch.Tensor, labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(mean, std)`` over F of the bonafide rows' frames, the unbiased std
    clamped at 1e-8, sums in float64 (the reference CAE recipe's
    normalizer, ``src/dataset_cae.py:20-52``); the benchmark makes it as it
    makes the weights, and hands the same to the program and the reference."""
    keep = torch.as_tensor(np.nonzero(labels == 1)[0], device=feats.device)
    s1 = torch.zeros(feats.shape[1], dtype=torch.float64, device=feats.device)
    s2 = torch.zeros_like(s1)
    for part in keep.split(256):
        rows = feats.index_select(0, part).double()
        s1 += rows.sum(dim=(0, 2))
        s2 += rows.square().sum(dim=(0, 2))
    n = len(keep) * feats.shape[2]
    mean = s1 / n
    var = (s2 - n * mean.square()).clamp_min(0.0) / max(n - 1, 1)
    return mean.float().cpu().numpy(), var.sqrt().clamp_min(1e-8).float().cpu().numpy()
