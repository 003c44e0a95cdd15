"""Equal Error Rate on the host — the numeric contract of the framework.

Counterpart of :mod:`dfac_tpu.ops.eer` (host half, byte-exact). Reproduces
the reference algorithm (``scripts/evaluation.py:7-56``): scores sorted
ascending; FAR/FRR curves with sentinel endpoints ``FAR[0]=1.0`` /
``FRR[0]=0.0``; EER is the *midpoint* of FAR and FRR at the argmin of
``|FAR - FRR|``; the operating threshold is the score one position below
the crossing (with a +-1e-6 epsilon at the edges). Not the sklearn
ROC-interpolation EER. The device EER is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
