"""CNN1D — the 1D classifier that treats the feature dims as channels.

Counterpart of :mod:`dfac_tpu.models.cnn1d` (``CNN1D``); parity target
reference ``src/model_cnn1d.py:5-46``: three [Conv1d k=3 SAME ->
BatchNorm -> ReLU] blocks 180 -> 32 -> 64 -> 128 sliding over time, with
dropout after blocks 1-2, then the mean over time and Linear(128, 1).

Parameter names are the reference ``state_dict``'s (``conv.0/.1``,
``conv.4/.5``, ``conv.8/.9``, ``classifier``), so reference ``.pt`` files
load with ``load_state_dict``. ``train()``/``eval()`` as
:class:`~.cnn2d.CNN2D`. The serving path is the folded chain in
:mod:`.fast_infer`. ``CNN1DVariant`` (the kernel-size study's body) is not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from dfac_tpu_torch.models.common import BN_EPS, BN_MOMENTUM, FastDropout


def conv1d_bn_relu(c_in: int, c_out: int) -> list[nn.Module]:
    """Conv1d k=3 SAME -> BatchNorm1d -> ReLU, in the reference's order."""
    return [
        nn.Conv1d(c_in, c_out, 3, padding=1),
        nn.BatchNorm1d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM),
        nn.ReLU(),
    ]


class CNN1D(nn.Module):
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
            *conv1d_bn_relu(in_features, bc), FastDropout(dropout),
            *conv1d_bn_relu(bc, bc * 2), FastDropout(dropout),
            *conv1d_bn_relu(bc * 2, bc * 4),
        )
        self.classifier = nn.Linear(bc * 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, F), F the conv channels -> logits (B, 1)."""
        h = self.conv(x.transpose(1, 2))  # (B, C, T)
        return self.classifier(h.mean(dim=2))
