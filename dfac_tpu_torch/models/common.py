"""Shared building blocks (the CNN2D subset of :mod:`dfac_tpu.models.common`).

torch's own layers already carry the reference semantics that the JAX
package had to write out:

* eval-mode BatchNorm with eps 1e-5, whose running variance torch updates
  with the *unbiased* batch variance (``TorchBatchNorm`` in JAX);
* floor-mode (2, 1) average pooling over time (321 -> 160);
* dropout, which is inert at eval, so ``nn.Dropout`` stands in for the JAX
  package's byte-quantized ``FastDropout`` (only training would tell them
  apart).
"""

from __future__ import annotations

from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


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
