"""CNN1D — the 1D classifier that treats the feature dims as channels.

Counterpart of :mod:`dfac_tpu.models.cnn1d` (``CNN1D``); parity target
reference ``src/model_cnn1d.py:5-46``: three [Conv1d k=3 SAME ->
BatchNorm -> ReLU] blocks 180 -> 32 -> 64 -> 128 sliding over time, with
dropout after blocks 1-2, then the mean over time and Linear(128, 1).

Parameter names are the reference ``state_dict``'s (``conv.0/.1``,
``conv.4/.5``, ``conv.8/.9``, ``classifier``), so reference ``.pt`` files
load with ``load_state_dict``. ``train()``/``eval()`` and
``compute_dtype`` as :class:`~.cnn2d.CNN2D` (JAX
``dfac_tpu/models/cnn1d.py:29-49``); ``in_features``, the conv channels,
is the model-view input's last axis. The serving path is the folded chain
in :mod:`.fast_infer`.

``CNN1DVariant`` is the kernel-size study's body (JAX
``dfac_tpu/models/cnn1d.py:52-82``, reference
``src/compare_kernels.py:38-67``): CNN1D with a kernel size per layer
(SAME padding, odd sizes) and CNN1D's parameter names.
"""

from __future__ import annotations

import torch
from torch import nn

from dfac_tpu_torch.models.common import FastDropout, Linear, conv1d_bn_relu


class CNN1DVariant(nn.Module):
    def __init__(
        self,
        in_features: int = 180,
        base_channels: int = 32,
        kernel_sizes: tuple[int, int, int] = (3, 3, 3),
        dropout: float = 0.2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        bc = base_channels
        k1, k2, k3 = (int(k) for k in kernel_sizes)
        self.in_features = in_features
        self.compute_dtype = compute_dtype
        self.conv = nn.Sequential(
            *conv1d_bn_relu(in_features, bc, k1), FastDropout(dropout),
            *conv1d_bn_relu(bc, bc * 2, k2), FastDropout(dropout),
            *conv1d_bn_relu(bc * 2, bc * 4, k3),
        )
        self.classifier = Linear(bc * 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, F), F the conv channels -> f32 logits (B, 1)."""
        h = self.conv(x.transpose(1, 2).to(self.compute_dtype or x.dtype))  # (B, C, T)
        return self.classifier(h.mean(dim=2)).float()

    @staticmethod
    def widths(sd: dict) -> dict:
        """The constructor's widths that ``sd`` (a state_dict) was made with."""
        w = sd["conv.0.weight"]
        return {"in_features": w.shape[1], "base_channels": w.shape[0],
                "kernel_sizes": tuple(sd[f"conv.{i}.weight"].shape[2] for i in (0, 4, 8))}


class CNN1D(CNN1DVariant):
    def __init__(
        self,
        in_features: int = 180,
        base_channels: int = 32,
        dropout: float = 0.2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__(in_features, base_channels, (3, 3, 3), dropout, compute_dtype)

    @staticmethod
    def widths(sd: dict) -> dict:
        w = sd["conv.0.weight"]
        return {"in_features": w.shape[1], "base_channels": w.shape[0]}
