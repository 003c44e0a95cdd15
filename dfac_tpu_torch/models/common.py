"""Shared building blocks (the CNN2D subset of :mod:`dfac_tpu.models.common`).

torch's own layers already carry the reference semantics that the JAX
package had to write out:

* BatchNorm with eps 1e-5 and momentum 0.1: batch statistics with the
  biased variance in training, running variance updated with the
  *unbiased* batch variance (``TorchBatchNorm`` in JAX);
* floor-mode (2, 1) average pooling over time (321 -> 160).

Dropout is the JAX package's byte-quantized :class:`FastDropout`: one
``uint8`` draw per element compared against ``round(rate * 256)``, kept
values rescaled by the true quantized keep probability (rate 0.2 keeps
205/256). It has no parameters, so the ``state_dict`` is the reference's.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


@contextlib.contextmanager
def f32_convs():
    """cuDNN convolutions in full f32 for the scope (no TF32, whose 10-bit
    mantissa is torch's default for f32 convs on Ampere and later). The
    JAX package's f32 layers run at ``Precision.HIGHEST``; the port's f32
    model, trained or evaluated, computes the same products. Matmuls are
    f32 already (``torch.backends.cuda.matmul.allow_tf32`` is False by
    default). Restores the previous setting on exit."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv_bn_relu(c_in: int, c_out: int) -> list[nn.Module]:
    """Conv 3x3 SAME -> BatchNorm -> ReLU, as the reference ``Sequential``
    lays them out (so state_dict indices match)."""
    return [
        nn.Conv2d(c_in, c_out, 3, padding=1),
        nn.BatchNorm2d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM),
        nn.ReLU(),
    ]


def time_pool() -> nn.Module:
    """Floor-mode (2, 1) average pool over the time (H) axis of NCHW."""
    return nn.AvgPool2d((2, 1))


def byte_dropout_thresh(rate: float) -> int:
    """Quantized dropout threshold: one uint8 byte per element is compared
    against ``round(rate * 256)``, clamped to [0, 256]; 0 keeps
    everything, 256 drops everything (torch's rate 1.0 -> zeros)."""
    return max(0, min(int(round(rate * 256)), 256))


def apply_byte_dropout(x: torch.Tensor, bits: torch.Tensor, thresh: int) -> torch.Tensor:
    """Keep the elements whose byte is >= ``thresh``, rescaled by the true
    quantized keep probability ``1 - thresh / 256`` (E[output] == input).
    ``thresh`` comes from :func:`byte_dropout_thresh`; 0 and 256 do not
    read ``bits``."""
    if thresh <= 0:
        return x
    if thresh >= 256:
        return torch.zeros_like(x)
    keep_p = 1.0 - thresh / 256.0
    return torch.where(bits >= thresh, x / keep_p, torch.zeros((), dtype=x.dtype, device=x.device))


class FastDropout(nn.Module):
    """Element dropout from one random byte per element (the JAX package's
    ``FastDropout``). Inert in eval mode. The bytes come from
    ``self.generator`` when one is set (a ``torch.Generator`` on the
    input's device; the trainer sets one from its seed), else from torch's
    default generator of that device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        thresh = byte_dropout_thresh(self.rate)
        if not self.training or thresh <= 0:
            return x
        if thresh >= 256:
            return torch.zeros_like(x)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=self.generator)
        return apply_byte_dropout(x, bits, thresh)

    def extra_repr(self) -> str:
        return f"rate={self.rate}, keep={256 - byte_dropout_thresh(self.rate)}/256"
