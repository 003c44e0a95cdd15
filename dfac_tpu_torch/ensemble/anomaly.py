"""Embedding-space anomaly detection.

Counterpart of :mod:`dfac_tpu.ensemble.anomaly`; parity target reference
``src/embedding_anomaly.py``. A trained CNN2D is a frozen feature
extractor (its mean-over-time embedding, 128 * F wide, via
``return_embedding``), and utterances are scored as anomalies by classical
one-class models fitted on bonafide-train embeddings only:

* StandardScaler -> OneClassSVM(nu=0.05, rbf), ``decision_function``
  (reference ``:134-142``);
* StandardScaler -> PCA(256) -> 8-component full-covariance
  GaussianMixture, ``score_samples`` (reference ``:144-163``).

Embeddings come from the model in eval mode on its own device (f32
convolutions, TF32 off, as the eval model scores); the
classical models run on the host through scikit-learn, an optional import
inside the two fitting functions.
"""

from __future__ import annotations

import numpy as np
import torch

from dfac_tpu_torch.data.pipeline import ArrayDataset, batch_iterator
from dfac_tpu_torch.models.common import f32_convs
from dfac_tpu_torch.ops.eer import calculate_eer
from dfac_tpu_torch.train.evaluate import model_device


def extract_embeddings(
    model: torch.nn.Module, ds: ArrayDataset, batch_size: int = 128, swap_tf: bool = True
) -> np.ndarray:
    """(N, 128 * F) f32 embeddings of ``ds`` in dataset order, from the
    model in eval mode (its mode restored after) with f32 convs (TF32 off)."""
    device = model_device(model)
    was_training = model.training
    model.eval()
    out = []
    with torch.inference_mode(), f32_convs():
        for batch in batch_iterator(ds, batch_size):
            x = torch.from_numpy(np.ascontiguousarray(batch.features, np.float32)).to(device)
            _, emb = model(x.transpose(1, 2) if swap_tf else x, return_embedding=True)
            out.append(emb.cpu().numpy()[batch.weights > 0])
    model.train(was_training)
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def ocsvm_anomaly_scores(train_embeddings: np.ndarray, eval_embeddings: np.ndarray, nu: float = 0.05) -> np.ndarray:
    """OneClassSVM decision_function (higher = more bonafide)."""
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import OneClassSVM

    scaler = StandardScaler().fit(train_embeddings)
    svm = OneClassSVM(nu=nu, kernel="rbf").fit(scaler.transform(train_embeddings))
    return svm.decision_function(scaler.transform(eval_embeddings))


def gmm_anomaly_scores(
    train_embeddings: np.ndarray,
    eval_embeddings: np.ndarray,
    n_components: int = 8,
    pca_dims: int = 256,
    seed: int = 42,  # reference src/embedding_anomaly.py:149-157
    reg_covar: float = 1e-4,
) -> np.ndarray:
    """PCA -> full-covariance GMM log-likelihood (higher = more bonafide)."""
    from sklearn.decomposition import PCA
    from sklearn.mixture import GaussianMixture
    from sklearn.preprocessing import StandardScaler

    scaler = StandardScaler().fit(train_embeddings)
    tr = scaler.transform(train_embeddings)
    pca_dims = min(pca_dims, tr.shape[0], tr.shape[1])
    pca = PCA(n_components=pca_dims, random_state=seed).fit(tr)
    n_components = min(n_components, tr.shape[0])
    gmm = GaussianMixture(
        n_components=n_components, covariance_type="full", random_state=seed, reg_covar=reg_covar,
    ).fit(pca.transform(tr))
    return gmm.score_samples(pca.transform(scaler.transform(eval_embeddings)))


def embedding_anomaly_report(
    model: torch.nn.Module,
    train_ds: ArrayDataset,
    eval_ds: ArrayDataset,
    batch_size: int = 128,
    swap_tf: bool = True,
    nu: float = 0.05,
    gmm_components: int = 8,
    pca_dims: int = 256,
    reg_covar: float = 1e-4,
) -> dict:
    """Embeddings -> OC-SVM and GMM scores -> the EER of each."""
    if eval_ds.labels is None:
        raise ValueError(
            "embedding_anomaly_report needs a LABELED eval dataset (the "
            "report is an EER over its labels)"
        )
    bona_train = train_ds.filter_label(1)
    if len(bona_train) == 0:
        raise ValueError("train_ds has no bonafide (label 1) rows to fit on")
    tr_emb = extract_embeddings(model, bona_train, batch_size, swap_tf)
    ev_emb = extract_embeddings(model, eval_ds, batch_size, swap_tf)
    labels = np.asarray(eval_ds.labels)

    svm_scores = ocsvm_anomaly_scores(tr_emb, ev_emb, nu=nu)
    svm_eer, svm_thr = calculate_eer(svm_scores, labels)
    gmm_scores = gmm_anomaly_scores(tr_emb, ev_emb, gmm_components, pca_dims, reg_covar=reg_covar)
    gmm_eer, gmm_thr = calculate_eer(gmm_scores, labels)
    return {
        "ocsvm": {"eer": svm_eer, "threshold": svm_thr, "scores": svm_scores},
        "gmm": {"eer": gmm_eer, "threshold": gmm_thr, "scores": gmm_scores},
        "embedding_dim": int(tr_emb.shape[1]),
        "n_bonafide_train": len(bona_train),
    }
