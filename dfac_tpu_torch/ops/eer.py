"""Equal Error Rate — the numeric contract of the framework.

Counterpart of :mod:`dfac_tpu.ops.eer`. Reproduces
the reference algorithm (``scripts/evaluation.py:7-56``): scores sorted
ascending; FAR/FRR curves with sentinel endpoints ``FAR[0]=1.0`` /
``FRR[0]=0.0``; EER is the *midpoint* of FAR and FRR at the argmin of
``|FAR - FRR|``; the operating threshold is the score one position below
the crossing (with a +-1e-6 epsilon at the edges). Not the sklearn
ROC-interpolation EER.

Two implementations:

* :func:`calculate_eer` — host-side numpy, byte-exact vs the reference.
* :func:`eer_device` / :func:`eer_torch` — the sort, cumulative counts and
  crossing search on the scores' device (:func:`eer_counts_torch`): a
  stable sort (ties in the scores keep their input order, as
  ``np.argsort(kind="stable")``), exact int64 counts, and the argmin over
  the reference's own float64 values ``|(ns - cs) / ns - cb / nb|``, first
  position on ties, as ``np.argmin``. Both equal :func:`calculate_eer`
  bit for bit. Not the JAX package's exact-integer argmin: where two
  positions tie exactly, float64 rounding decides which the reference
  takes (``tests/test_torch_port_train.py``).
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLD_EPSILON = 1e-6


def calculate_eer(scores, labels) -> tuple[float, float]:
    """EER and threshold per the reference discrete rule (numpy, host-side).

    Args:
        scores: array-like of detection scores (higher = more bonafide).
        labels: array-like of {0,1} labels (1 = bonafide, 0 = spoof).

    Returns:
        ``(eer, threshold)`` floats. Degenerate single-class input returns
        ``(0.0, 0.0)`` (reference ``scripts/evaluation.py:18-19``).
    """
    scores_np = np.asarray(scores)
    labels_np = np.asarray(labels)

    order = np.argsort(scores_np, kind="stable")
    sorted_scores = scores_np[order]
    sorted_labels = labels_np[order]

    n_bonafide = int(np.sum(labels_np))
    n_spoof = len(labels_np) - n_bonafide
    if n_bonafide == 0 or n_spoof == 0:
        return 0.0, 0.0

    far = np.concatenate(
        [[1.0], (n_spoof - np.cumsum(sorted_labels == 0)) / n_spoof]
    )
    frr = np.concatenate([[0.0], np.cumsum(sorted_labels == 1) / n_bonafide])

    eer_idx = int(np.argmin(np.abs(far - frr)))
    eer = (far[eer_idx] + frr[eer_idx]) / 2.0

    if eer_idx == 0:
        threshold = sorted_scores[0] - THRESHOLD_EPSILON
    elif eer_idx == len(sorted_scores):
        threshold = sorted_scores[-1] + THRESHOLD_EPSILON
    else:
        threshold = sorted_scores[eer_idx - 1]

    return float(eer), float(threshold)


def confusion_at_threshold(scores, labels, threshold):
    """TP/FP/TN/FN + FAR/FRR at a fixed threshold (``pred = score > thr``).

    Mirrors reference ``scripts/evaluation.py:42-56``.
    """
    scores_np = np.asarray(scores)
    labels_np = np.asarray(labels).astype(int)

    pred = (scores_np > threshold).astype(int)
    tp = int(np.sum((pred == 1) & (labels_np == 1)))
    fn = int(np.sum((pred == 0) & (labels_np == 1)))
    fp = int(np.sum((pred == 1) & (labels_np == 0)))
    tn = int(np.sum((pred == 0) & (labels_np == 0)))

    far = fp / (fp + tn) if (fp + tn) > 0 else 0.0
    frr = fn / (tp + fn) if (tp + fn) > 0 else 0.0
    return tp, fp, tn, fn, float(far), float(frr)


def eer_counts_torch(scores: torch.Tensor, labels: torch.Tensor):
    """Crossing search on the scores' device: one stable sort, two
    cumulative counts (int64) and the reference's FAR/FRR curves in
    float64, ``far = (ns - cs) / ns`` and ``frr = cb / nb`` with the
    sentinels ``far[0] = 1``, ``frr[0] = 0``; the crossing is the first
    argmin of ``|far - frr|``. Every operation is the one numpy runs in
    :func:`calculate_eer` (int64 -> float64 conversion, IEEE division and
    subtraction), so the index is the reference's, even where the exact
    values tie and rounding decides. Needs ``ns > 0`` and ``nb > 0`` for a
    meaningful result (the callers test for them).

    Returns device tensors ``(eer, n_spoof, n_bonafide, eer_idx,
    sorted_scores)`` with ``eer = (far + frr) / 2`` at the crossing in
    float64; the threshold is read from ``sorted_scores`` around
    ``eer_idx`` (reference ``scripts/evaluation.py:30-36``)."""
    scores = scores.reshape(-1)
    labels_i = labels.reshape(-1).to(device=scores.device, dtype=torch.int64)
    sorted_scores, order = torch.sort(scores, stable=True)
    sorted_labels = labels_i[order]
    n_bonafide = labels_i.sum()
    n_spoof = scores.numel() - n_bonafide
    pad = torch.zeros(1, dtype=torch.int64, device=scores.device)
    cum_spoof = torch.cat([pad, torch.cumsum(sorted_labels == 0, 0)])
    cum_bona = torch.cat([pad, torch.cumsum(sorted_labels == 1, 0)])
    far = (n_spoof - cum_spoof).double() / n_spoof.clamp_min(1).double()
    frr = cum_bona.double() / n_bonafide.clamp_min(1).double()
    dist = (far - frr).abs()
    # the first position of the minimum (np.argmin's tie rule), without a
    # host sync
    pos = torch.arange(dist.numel(), device=scores.device)
    eer_idx = torch.where(dist == dist.min(), pos, dist.numel()).min()
    eer = (far[eer_idx] + frr[eer_idx]) / 2.0
    return eer, n_spoof, n_bonafide, eer_idx, sorted_scores


def eer_torch(scores: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """EER and threshold as 0-d tensors on the scores' device (float64 EER,
    threshold in the scores' dtype), with no host sync. Degenerate
    single-class or empty input returns ``(0.0, 0.0)``. Equal to
    :func:`calculate_eer` bit for bit (under numpy 2's scalar promotion
    for the edge thresholds, which it computes in the scores' dtype)."""
    scores = scores.reshape(-1)
    zero = torch.zeros((), dtype=torch.float64, device=scores.device)
    if scores.numel() == 0:
        return zero, zero.to(scores.dtype)
    eer, ns, nb, eer_idx, s = eer_counts_torch(scores, labels)
    degenerate = (ns == 0) | (nb == 0)
    n = s.numel()
    edge = torch.where(eer_idx == 0, s[0] - THRESHOLD_EPSILON, s[-1] + THRESHOLD_EPSILON)
    inner = s[(eer_idx - 1).clamp(0, n - 1)]
    threshold = torch.where((eer_idx == 0) | (eer_idx == n), edge, inner)
    return torch.where(degenerate, zero, eer), torch.where(degenerate, zero.to(s.dtype), threshold)


def eer_device(scores, labels) -> tuple[float, float]:
    """EER computed on the device; ``(eer, threshold)`` as floats.

    ``scores``/``labels`` may be tensors on any device or array-likes (which
    stay on the CPU). The search runs where the scores are; one fetch
    brings back the EER, the counts and the index, a second the one sorted
    score the threshold is read from, as a numpy scalar of the scores'
    dtype, so the edge rule runs in numpy exactly as :func:`calculate_eer`
    runs it. Bit-exact against :func:`calculate_eer`."""
    scores_t = scores if isinstance(scores, torch.Tensor) else torch.as_tensor(np.asarray(scores))
    labels_t = labels if isinstance(labels, torch.Tensor) else torch.as_tensor(np.asarray(labels))
    if scores_t.numel() == 0:
        return 0.0, 0.0
    eer, ns, nb, eer_idx, s = eer_counts_torch(scores_t, labels_t)
    eer, ns, nb, eer_idx = torch.stack([eer, ns.double(), nb.double(), eer_idx.double()]).tolist()
    if ns == 0 or nb == 0:
        return 0.0, 0.0
    eer_idx = int(eer_idx)
    at = s[max(eer_idx - 1, 0)].reshape(1).cpu().numpy()[0]  # a numpy scalar of the scores' dtype
    if eer_idx == 0:
        threshold = at - THRESHOLD_EPSILON
    elif eer_idx == s.numel():
        threshold = at + THRESHOLD_EPSILON
    else:
        threshold = at
    return eer, float(threshold)


def confusion_at_threshold_torch(scores: torch.Tensor, labels: torch.Tensor, threshold):
    """Device-side confusion counts at a fixed threshold (``pred = score >
    thr``): ``(tp, fp, tn, fn, far, frr)`` as 0-d tensors."""
    labels = labels.reshape(-1).to(device=scores.device, dtype=torch.int64)
    pred = scores.reshape(-1) > threshold
    bona = labels == 1
    tp, fn = (pred & bona).sum(), (~pred & bona).sum()
    fp, tn = (pred & ~bona).sum(), (~pred & ~bona).sum()
    far = torch.where(fp + tn > 0, fp / (fp + tn).clamp_min(1), 0.0)
    frr = torch.where(tp + fn > 0, fn / (tp + fn).clamp_min(1), 0.0)
    return tp, fp, tn, fn, far, frr
