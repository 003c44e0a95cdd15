"""DeepfakeDetector — the variable-length-capable "dlqueen" model.

Counterpart of :mod:`dfac_tpu.models.detector`; parity target reference
``src/dlqueen_model.py:115-173``. ConvEncoder: Conv1d k=5, then k=3 twice
(SAME), C -> hidden=256, each followed by BatchNorm, exact GELU and
byte dropout (0.2). StatsPool: the length-masked mean and std over time
-> (B, 2 * hidden), in f32. Head: Linear(512, 256) -> GELU -> dropout
(0.3) -> Linear(256, 1).

Batches are padded to one T with a length mask, as in the JAX package;
BatchNorm's batch statistics cover every frame, pad frames included, as
there. Parameter names are the reference ``state_dict``'s (``enc.net.{0,
1,4,5,8,9}``, ``head.0``, ``head.3``), so reference ``.pt`` files load
with ``load_state_dict``. ``compute_dtype=torch.bfloat16`` runs the
encoder and the head in bf16 as :class:`~.cnn2d.CNN2D` does; the stats
pool stays in f32 (JAX ``dfac_tpu/models/detector.py:47-83``). The
serving path is the folded chain in :mod:`.fast_infer`.
"""

from __future__ import annotations

import torch
from torch import nn

from dfac_tpu_torch.models.common import BatchNorm1d, Conv1d, FastDropout, Linear


def stats_pool(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Masked mean and std over time: x (B, T, C), lengths (B,) valid frame
    counts -> (B, 2C). The denominator is clamped to >= 1 and the variance
    floored at 1e-6 before the sqrt (reference
    ``src/dlqueen_model.py:115-129``)."""
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[..., None]  # (B, T, 1)
    denom = torch.clamp_min(mask.sum(dim=1), 1.0)  # (B, 1)
    mean = (x * mask).sum(dim=1) / denom
    var = (mask * torch.square(x - mean[:, None, :])).sum(dim=1) / denom
    std = torch.sqrt(torch.clamp_min(var, 1e-6))
    return torch.cat([mean, std], dim=-1)


class ConvEncoder(nn.Module):
    """The reference's ``enc``: one ``Sequential`` named ``net``."""

    def __init__(self, in_channels: int, hidden: int, dropout: float):
        super().__init__()
        layers: list[nn.Module] = []
        for c_in, k in ((in_channels, 5), (hidden, 3), (hidden, 3)):
            layers += [
                Conv1d(c_in, hidden, k, padding=k // 2),
                BatchNorm1d(hidden),
                nn.GELU(approximate="none"),
                FastDropout(dropout),
            ]
        self.net = nn.Sequential(*layers)


class DeepfakeDetector(nn.Module):
    takes_bn_frozen = True  # models.common.frozen_batchnorm: the JAX model's bn_frozen

    def __init__(
        self,
        in_channels: int = 180,
        hidden: int = 256,
        dropout: float = 0.3,
        encoder_dropout: float = 0.2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.enc = ConvEncoder(in_channels, hidden, encoder_dropout)
        self.head = nn.Sequential(
            Linear(2 * hidden, hidden),
            nn.GELU(approximate="none"),
            FastDropout(dropout),
            Linear(hidden, 1),
        )

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, T, C); lengths: (B,) or None (every frame valid) -> (B,)
        f32 logits."""
        if lengths is None:
            lengths = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
        dt = self.compute_dtype or x.dtype
        h = self.enc.net(x.transpose(1, 2).to(dt))  # (B, hidden, T)
        z = stats_pool(h.transpose(1, 2).float(), lengths)  # (B, 2 * hidden), f32
        return self.head(z.to(dt))[:, 0].float()

    @staticmethod
    def widths(sd: dict) -> dict:
        """The constructor's widths that ``sd`` (a state_dict) was made with."""
        w = sd["enc.net.0.weight"]
        return {"in_channels": w.shape[1], "hidden": w.shape[0]}
