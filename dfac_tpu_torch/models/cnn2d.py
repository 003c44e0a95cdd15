"""CNN2D — the primary (submitted) classifier.

Counterpart of :mod:`dfac_tpu.models.cnn2d`; parity target reference
``src/model.py:5-42``. A 2D CNN over the (T=321, F=180) grid as a
1-channel image: three [Conv 3x3 SAME -> BatchNorm -> ReLU] blocks with
channels 1 -> 32 -> 64 -> 128, (2, 1) average pooling and dropout after
blocks 1-2; head = mean over time -> channel-major flatten ->
Linear(128 * F, 1).

Parameter names are the reference ``state_dict``'s (``conv.0/.1``,
``conv.5/.6``, ``conv.10/.11``, ``classifier``), so reference ``.pt``
files load with ``load_state_dict``. In ``train()`` mode BatchNorm uses
batch statistics and updates its running ones, and the byte-quantized
:class:`~.common.FastDropout` (in ``nn.Dropout``'s place) is active; in
``eval()`` mode this is the f32 eval model. ``compute_dtype=torch.bfloat16``
runs the layers in bf16 with f32 parameters, BatchNorm statistics and
logits (:mod:`.common`; JAX ``dfac_tpu/models/cnn2d.py:37-71``). The
serving path is the folded chain in :mod:`.fast_infer`.

``in_features`` is the width of the model-view input's last axis (F with
``swap_tf``, T without), which sizes the classifier; the JAX module reads
it from the data, so the port's callers pass the data's
(:func:`~dfac_tpu_torch.models.model_width`).
"""

from __future__ import annotations

import torch
from torch import nn

from dfac_tpu_torch.models.common import FastDropout, Linear, conv_bn_relu, time_pool


class CNN2D(nn.Module):
    takes_bn_frozen = True  # models.common.frozen_batchnorm: the JAX model's bn_frozen

    def __init__(
        self,
        in_features: int = 180,
        base_channels: int = 32,
        dropout: float = 0.2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        bc = base_channels
        self.in_features = in_features
        self.compute_dtype = compute_dtype
        self.conv = nn.Sequential(
            *conv_bn_relu(1, bc), time_pool(), FastDropout(dropout),
            *conv_bn_relu(bc, bc * 2), time_pool(), FastDropout(dropout),
            *conv_bn_relu(bc * 2, bc * 4),
        )
        self.classifier = Linear(bc * 4 * in_features, 1)

    def forward(self, x: torch.Tensor, return_embedding: bool = False):
        """x: (B, T, F) in model-view orientation -> f32 logits (B, 1); with
        ``return_embedding``, ``(logits, embedding)``, the embedding the
        classifier reads (the mean over time, channel-major: c * F + f,
        128 * F wide) in f32 (JAX ``dfac_tpu/models/cnn2d.py:66-71``)."""
        h = self.conv(x.unsqueeze(1).to(self.compute_dtype or x.dtype))  # (B, C, T', F)
        embedding = h.mean(dim=2).flatten(1)
        logits = self.classifier(embedding).float()
        return (logits, embedding.float()) if return_embedding else logits

    @staticmethod
    def widths(sd: dict) -> dict:
        """The constructor's widths that ``sd`` (a state_dict) was made with."""
        bc = sd["conv.0.weight"].shape[0]
        return {"base_channels": bc, "in_features": sd["classifier.weight"].shape[1] // (4 * bc)}
