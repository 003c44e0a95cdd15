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
``eval()`` mode this is the f32 eval model. The serving path is the
folded chain in :mod:`.fast_infer`.
"""

from __future__ import annotations

import torch
from torch import nn

from dfac_tpu_torch.models.common import FastDropout, conv_bn_relu, time_pool


class CNN2D(nn.Module):
    def __init__(
        self,
        in_features: int = 180,
        base_channels: int = 32,
        dropout: float = 0.2,
    ):
        super().__init__()
        bc = base_channels
        self.in_features = in_features
        self.conv = nn.Sequential(
            *conv_bn_relu(1, bc), time_pool(), FastDropout(dropout),
            *conv_bn_relu(bc, bc * 2), time_pool(), FastDropout(dropout),
            *conv_bn_relu(bc * 2, bc * 4),
        )
        self.classifier = nn.Linear(bc * 4 * in_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, F) in model-view orientation -> logits (B, 1)."""
        h = self.conv(x.unsqueeze(1))  # (B, C, T', F)
        return self.classifier(h.mean(dim=2).flatten(1))  # channel-major: c * F + f
