"""CAE scoring and evaluation.

Counterpart of the scoring half of :mod:`dfac_tpu.train.cae_loop`; parity
target reference ``src/evaluation_cae.py``: per-sample reconstruction MSE
over (T, F) of normalized, swapped spectrograms, and the **dual scoring
convention** (the EER of -MSE and of +MSE, the better kept; on this corpus
fakes reconstruct better, so +MSE is the bonafide score), with per-class
mean MSE and the spoof/bonafide ratio.

``CAETrainer`` and the ``train_cae`` CLI are not ported yet (ROADMAP.md):
a CAE checkpoint for the port comes from the JAX package (a pickle
``.ckpt``) or from the reference (a ``.pt``), which
:func:`~dfac_tpu_torch.train.checkpoint.load_model_variables` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from dfac_tpu_torch.data.normalizer import FeatureNormalizer
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.models.cae import reconstruction_mse
from dfac_tpu_torch.models.common import f32_convs
from dfac_tpu_torch.ops.eer import eer_device


def cae_mse_scores(
    model: torch.nn.Module,
    ds: ArrayDataset,
    normalizer: FeatureNormalizer,
    batch_size: int = 128,
) -> np.ndarray:
    """Per-utterance reconstruction MSE of the eval model on its device
    (convs in full f32), dataset order; batches and uploads as
    :func:`~dfac_tpu_torch.train.evaluate.predict_scores`."""
    from dfac_tpu_torch.models.fast_infer import ingest
    from dfac_tpu_torch.train.evaluate import collect_masked_scores, model_device

    device = model_device(model)
    mean = torch.as_tensor(normalizer.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(normalizer.std, dtype=torch.float32, device=device)

    def score(feats):
        x = (feats.transpose(1, 2) - mean) / std
        recon, _ = model(x)
        return reconstruction_mse(recon, x)

    was_training = model.training
    model.eval()
    with torch.inference_mode(), f32_convs():
        mse = collect_masked_scores(score, ds, batch_size,
                                    prepare_batch=lambda b: ingest(b.features, torch.float32, device))
    model.train(was_training)
    return mse


def evaluate_cae(
    model: torch.nn.Module, ds: ArrayDataset, normalizer: FeatureNormalizer, batch_size: int = 128
) -> dict:
    """Dual-convention CAE evaluation (reference ``src/evaluation_cae.py:50-87``)."""
    if ds.labels is None:
        raise ValueError("evaluate_cae needs labels")
    mse = cae_mse_scores(model, ds, normalizer, batch_size)
    labels = np.asarray(ds.labels)
    eer_neg, thr_neg = eer_device(-mse, labels)
    eer_pos, thr_pos = eer_device(mse, labels)
    if eer_pos <= eer_neg:
        convention, eer, thr = "+mse", eer_pos, thr_pos
    else:
        convention, eer, thr = "-mse", eer_neg, thr_neg
    bona = mse[labels == 1]
    spoof = mse[labels == 0]
    return {
        "eer": eer,
        "threshold": thr,
        "convention": convention,
        "eer_pos_mse": eer_pos,
        "eer_neg_mse": eer_neg,
        "bonafide_mean_mse": float(bona.mean()) if len(bona) else None,
        "spoof_mean_mse": float(spoof.mean()) if len(spoof) else None,
        "spoof_bonafide_ratio": float(spoof.mean() / bona.mean()) if len(bona) and len(spoof) else None,
        "scores": mse,
    }
