"""Hybrid CNN + CAE score fusion.

Counterpart of :mod:`dfac_tpu.ensemble.hybrid`; parity targets reference
``src/hybrid_ensemble.py`` (the dev-set alpha sweep) and
``src/predict_hybrid.py`` (the fixed-alpha submission path, alpha = 0.80).
numpy, as in the JAX package: the scores are host arrays by then.

The CAE score fed in is the *raw* +MSE: on this corpus fakes reconstruct
better than bonafide (spoof/bonafide MSE ratio ~0.52), so a higher MSE
means more bonafide (``src/hybrid_ensemble.py:59-61``).
"""

from __future__ import annotations

import numpy as np

from dfac_tpu_torch.ops.eer import calculate_eer


def min_max_normalize(scores: np.ndarray) -> np.ndarray:
    """Map to [0, 1] (reference ``src/hybrid_ensemble.py:64-69``)."""
    scores = np.asarray(scores, np.float64)
    lo, hi = scores.min(), scores.max()
    if hi - lo < 1e-12:
        return np.zeros_like(scores)
    return (scores - lo) / (hi - lo)


def fuse_scores(sup_scores: np.ndarray, cae_scores: np.ndarray, alpha: float = 0.80) -> np.ndarray:
    """``alpha * sup + (1 - alpha) * cae`` on min-max-normalized inputs."""
    return alpha * min_max_normalize(sup_scores) + (1.0 - alpha) * min_max_normalize(cae_scores)


def sweep_alpha(sup_scores: np.ndarray, cae_scores: np.ndarray, labels: np.ndarray, num: int = 21) -> dict:
    """Grid-search alpha over ``linspace(0, 1, num)`` by dev EER
    (reference ``src/hybrid_ensemble.py:138-151``)."""
    sup_n = min_max_normalize(sup_scores)
    cae_n = min_max_normalize(cae_scores)
    rows = []
    for alpha in np.linspace(0.0, 1.0, num):
        eer, thr = calculate_eer(alpha * sup_n + (1 - alpha) * cae_n, labels)
        rows.append({"alpha": float(alpha), "eer": eer, "threshold": thr})
    best = min(rows, key=lambda r: r["eer"])
    return {"best_alpha": best["alpha"], "best_eer": best["eer"], "sweep": rows}


def score_distribution_report(scores: np.ndarray) -> dict:
    """Distribution summary (reference ``src/predict_hybrid.py:161-186``)."""
    s = np.asarray(scores, np.float64)
    qs = np.quantile(s, [0.01, 0.25, 0.5, 0.75, 0.99])
    return {
        "n": int(s.size),
        "min": float(s.min()),
        "p01": float(qs[0]),
        "p25": float(qs[1]),
        "median": float(qs[2]),
        "p75": float(qs[3]),
        "p99": float(qs[4]),
        "max": float(s.max()),
        "n_class1_at_0.5": int((s > 0.5).sum()),
        "n_class0_at_0.5": int((s <= 0.5).sum()),
    }


def compare_with_submission(
    uttids: list[str], scores: np.ndarray, other_uttids: list[str], other_scores: np.ndarray
) -> dict:
    """Per-sample difference and class agreement against another prediction
    set (reference ``src/predict_hybrid.py:187-207``)."""
    mine = dict(zip(uttids, np.asarray(scores, np.float64)))
    other = dict(zip(other_uttids, np.asarray(other_scores, np.float64)))
    common = [u for u in uttids if u in other]
    ours = np.asarray([mine[u] for u in common])
    theirs = np.asarray([other[u] for u in common])
    diff = ours - theirs
    agree = (ours > 0.5) == (theirs > 0.5)
    return {
        "n_common": len(common),
        "mean_abs_diff": float(np.abs(diff).mean()) if len(common) else None,
        "max_abs_diff": float(np.abs(diff).max()) if len(common) else None,
        "class_agreement": float(agree.mean()) if len(common) else None,
        "n_flipped": int((~agree).sum()),
    }
