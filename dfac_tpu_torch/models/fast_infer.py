"""CNN2D serving path: folded BatchNorm, fused conv blocks, no transposes.

Counterpart of the CNN2D half of :mod:`dfac_tpu.models.fast_infer`:

* **BatchNorm folding** — at eval BN is affine, so it folds into the conv
  kernel and bias (``W' = W * inv``, ``b' = (b - mean) * inv + shift``,
  ``inv = scale / sqrt(var + eps)``).
* **Fused blocks** — every block is conv + bias + ReLU (+ time pool) in
  one call of :func:`dfac_tpu_torch.ops.conv_block.fused_conv_block`, so
  on CUDA all three run through the hand-written kernel and the pre-pool
  activation never reaches device memory. The JAX package's depthwise-conv
  pooling was a TPU layout workaround; the pool here lives in the
  kernel's epilogue.
* bf16 activations with f32 accumulation by default.

Folded weights keep the JAX layouts (HWIO kernels, ``(128 * F, 1)``
classifier) so the tests compare like with like.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from dfac_tpu_torch.models.common import BN_EPS
from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores

# A batch of a memory-mapped store is a read-only view, and ``ingest`` only
# reads the tensor over it; silence torch's warning for this module alone,
# once, rather than swap the process-wide filters on every batch.
warnings.filterwarnings(
    "ignore", message="The given NumPy array is not writable", category=UserWarning, module=__name__
)


def fold_cnn2d(state_dict: dict) -> dict:
    """Fold BN stats into the conv kernels/biases of a CNN2D ``state_dict``
    (the port's names); returns ``{w1..w3 (HWIO), b1..b3, w_cls, b_cls}``
    as f32 tensors on the state_dict's device."""
    sd = {k: v.detach().float() for k, v in state_dict.items() if v.is_floating_point()}
    folded = {}
    for i, (ci, bi) in enumerate([(0, 1), (5, 6), (10, 11)], 1):
        inv = sd[f"conv.{bi}.weight"] * torch.rsqrt(sd[f"conv.{bi}.running_var"] + BN_EPS)
        kernel = sd[f"conv.{ci}.weight"].permute(2, 3, 1, 0)  # OIHW -> HWIO
        folded[f"w{i}"] = (kernel * inv).contiguous()
        folded[f"b{i}"] = (sd[f"conv.{ci}.bias"] - sd[f"conv.{bi}.running_mean"]) * inv + sd[
            f"conv.{bi}.bias"
        ]
    folded["w_cls"] = sd["classifier.weight"].t().contiguous()
    folded["b_cls"] = sd["classifier.bias"].clone()
    return folded


def cnn2d_fast_scores_tf(
    folded: dict,
    feats_tf: torch.Tensor,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Swapped-orientation (B, T, F) features -> (B,) scores: the
    CNN2D-native grid, which the GEMM front-end's (B, T, 180) output feeds
    without a transpose."""
    return cnn2d_fused_scores(folded, feats_tf, apply_sigmoid, compute_dtype)


def cnn2d_fast_scores(
    folded: dict,
    feats_stored: torch.Tensor,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Stored-orientation (B, F, T) features -> (B,) scores, i.e.
    ``sigmoid(CNN2D(transpose(feats)))`` with BN folded. The kernel pools
    over H, so the grid turns to (T, F) once, at entry."""
    feats_tf = feats_stored.to(compute_dtype).transpose(1, 2).contiguous()
    return cnn2d_fused_scores(folded, feats_tf, apply_sigmoid, compute_dtype)


def ingest(feats_np: np.ndarray, compute_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host -> device upload of a feature batch.

    The chain's first op casts to ``compute_dtype``, so the cast happens on
    the host (bit-identical, half the bytes in bf16); for a CUDA device the
    batch is staged in pinned memory and copied with ``non_blocking``, so
    the upload of batch k+1 overlaps the scoring of batch k. A batch of a
    memory-mapped store is read-only; the tensor over it is only read."""
    t = torch.from_numpy(np.ascontiguousarray(feats_np)).to(compute_dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def predict_scores_fast(
    state_dict: dict,
    ds,
    device: torch.device,
    batch_size: int = 512,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    stats=None,
) -> np.ndarray:
    """Score a whole :class:`~dfac_tpu_torch.data.pipeline.ArrayDataset`
    through the folded chain on ``device``; (N,) float32 in dataset order.

    ``swap_tf`` follows the reference predict CLI (``src/predict.py:100-111``):
    True means the features are stored (F, T) and the model sees the
    transposed grid."""
    from dfac_tpu_torch.train.evaluate import collect_masked_scores

    folded = {k: v.to(device) for k, v in fold_cnn2d(state_dict).items()}
    score = cnn2d_fast_scores if swap_tf else cnn2d_fast_scores_tf
    with torch.inference_mode():
        return collect_masked_scores(
            lambda feats: score(folded, feats, apply_sigmoid, compute_dtype),
            ds, batch_size,
            prepare_batch=lambda b: ingest(b.features, compute_dtype, device),
            stats=stats,
        )
