"""Shared building blocks (counterpart of :mod:`dfac_tpu.models.common`).

torch's own layers already carry the reference semantics that the JAX
package had to write out:

* BatchNorm with eps 1e-5 and momentum 0.1: batch statistics with the
  biased variance in training, running variance updated with the
  *unbiased* batch variance (``TorchBatchNorm`` in JAX);
* floor-mode (2, 1) average pooling over time (321 -> 160).

Dropout is the JAX package's byte-quantized :class:`FastDropout`: one
``uint8`` draw per element compared against ``round(rate * 256)``, kept
values rescaled by the true quantized keep probability (rate 0.2 keeps
205/256); channel dropout is :class:`ChannelDropout`, torch's
``Dropout1d``/``Dropout2d`` rule. Neither has parameters, so the
``state_dict`` is the reference's.

**bf16 compute** (the JAX package's ``compute_dtype``, its ``Conv``,
``Dense`` and ``TorchBatchNorm`` with ``dtype=bfloat16``): a model built
with ``compute_dtype=torch.bfloat16`` casts its input to bf16 and its
logits to f32; in between, the layers here follow the dtype of what they
are handed. :class:`Conv1d`, :class:`Conv2d` and :class:`Linear` keep f32
parameters and, on a bf16 input, run the conv or matmul on bf16 copies of
the weight (bf16 out) and then add the bias cast to bf16, as flax's
layers do; :class:`BatchNorm1d` and :class:`BatchNorm2d` take their
statistics (and update the running ones) in f32 from the bf16 input and
cast the result back to bf16. Pools, ReLU, GELU and dropout then run in
bf16. On an f32 input every layer is torch's own. The casts are written
out, not left to ``torch.autocast``, which keeps BatchNorm's and
softmax's outputs in f32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
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


class Conv1d(nn.Conv1d):
    """``nn.Conv1d``; on an input of another dtype than its f32 weight,
    the conv on the weight cast to that dtype, then the bias in it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return self._conv_forward(x, self.weight.to(x.dtype), None) + self.bias.to(x.dtype)[:, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with :class:`Conv1d`'s rule for a bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return self._conv_forward(x, self.weight.to(x.dtype), None) + self.bias.to(x.dtype)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` with :class:`Conv1d`'s rule for a bf16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (eps 1e-5, momentum 0.1) computed in f32 from
    its input, the result in the input's dtype. With ``sync_group`` set
    (:func:`set_batchnorm_group`), training mode takes the statistics of
    every rank's rows (:func:`synced_batch_norm`, the
    JAX ``TorchBatchNorm`` under ``axis_name``); without one it is
    ``nn.BatchNorm1d``'s own path."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.sync_group = None  # a torch.distributed group to sync the batch statistics over

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return synced_batch_norm(self, x, self.sync_group)
        return super().forward(x.float()).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """:class:`BatchNorm1d`'s rule over NCHW."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return synced_batch_norm(self, x, self.sync_group)
        return super().forward(x.float()).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks of ``group``; the backward sums the gradient
    across them too (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed across the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def synced_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, group) -> torch.Tensor:
    """Training-mode BatchNorm of ``bn`` (channels on dim 1) with the
    statistics of the rows of every rank of ``group``: f32 mean and E[x²]
    of this rank's rows, averaged across ranks, var = E[x²] - mean² clamped
    at 0, the running statistics updated with momentum and the unbiased
    factor of the global count (``dfac_tpu/models/common.py:96-103``). The
    result is computed in f32 and returned in ``x``'s dtype."""
    world = dist.get_world_size(group)
    xf = x.float()
    c = xf.shape[1]
    dims = [0, *range(2, xf.dim())]
    stats = all_reduce_sum(torch.cat([xf.mean(dims), xf.square().mean(dims)]), group) / world
    mean, mean_sq = stats[:c], stats[c:]
    var = (mean_sq - mean.square()).clamp_min(0.0)
    n = (xf.numel() // c) * world
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach() * (n / max(n - 1, 1)), alpha=m)
        bn.num_batches_tracked.add_(1)
    shape = (1, c) + (1,) * (xf.dim() - 2)
    # one pass for (x - mean) * rsqrt(var + eps) * weight + bias: autograd keeps x - mean alone of
    # the activation's size beside x itself
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return torch.addcmul(bn.bias.view(shape), xf - mean.view(shape), scale.view(shape)).to(x.dtype)


def set_batchnorm_group(model: nn.Module, group) -> None:
    """Sync every BatchNorm of ``model`` over ``group`` in training mode
    (None: each keeps ``nn.BatchNorm``'s own path). Raises where a
    BatchNorm of the model is not one of the port's, which would train on
    its rank's rows alone."""
    for name, m in model.named_modules():
        if isinstance(m, (BatchNorm1d, BatchNorm2d)):
            m.sync_group = group
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{name}: {type(m).__name__} cannot sync its statistics across ranks")


def conv_bn_relu(c_in: int, c_out: int) -> list[nn.Module]:
    """Conv 3x3 SAME -> BatchNorm -> ReLU, as the reference ``Sequential``
    lays them out (so state_dict indices match)."""
    return [Conv2d(c_in, c_out, 3, padding=1), BatchNorm2d(c_out), nn.ReLU()]


def conv1d_bn_relu(c_in: int, c_out: int, k: int = 3) -> list[nn.Module]:
    """Conv1d k SAME (odd k) -> BatchNorm1d -> ReLU, in the reference's order."""
    return [Conv1d(c_in, c_out, k, padding=k // 2), BatchNorm1d(c_out), nn.ReLU()]


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


def random_bytes(shape, device: torch.device, generator: torch.Generator | None) -> torch.Tensor:
    """:class:`FastDropout`'s draw: one uniform ``uint8`` per element."""
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=generator)


def keep_draws(shape, keep: float, device: torch.device, generator: torch.Generator | None) -> torch.Tensor:
    """:class:`ChannelDropout`'s draw: True with probability ``keep``."""
    return torch.rand(shape, device=device, generator=generator) < keep


class _Dropout(nn.Module):
    """A dropout rule that draws from ``self.generator`` when one is set (a
    ``torch.Generator`` on the input's device; the trainers set theirs,
    seeded from their seed), else from torch's default generator of that
    device. Inert in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None


class FastDropout(_Dropout):
    """Element dropout from one random byte per element (the JAX package's
    ``FastDropout``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        thresh = byte_dropout_thresh(self.rate)
        if not self.training or thresh <= 0:
            return x
        if thresh >= 256:
            return torch.zeros_like(x)
        return apply_byte_dropout(x, random_bytes(x.shape, x.device, self.generator), thresh)

    def extra_repr(self) -> str:
        return f"rate={self.rate}, keep={256 - byte_dropout_thresh(self.rate)}/256"


class ChannelDropout(_Dropout):
    """torch ``Dropout1d``/``Dropout2d`` (the JAX package's
    ``ChannelDropout``): each sample drops whole channels of its (B, C,
    ...) activation, one keep draw per (sample, channel), the kept values
    scaled by ``1 / (1 - rate)`` in the activation's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = keep_draws((x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2), keep, x.device, self.generator)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


@contextlib.contextmanager
def frozen_batchnorm(model: nn.Module, frozen: bool = True):
    """The JAX models' ``bn_frozen=True`` (``dfac_tpu/models/cnn2d.py:41-58``,
    ``cae.py:47-101``, ``detector.py:55-73``) for the scope: every BatchNorm
    of ``model`` in eval mode, so it normalizes with its running statistics
    and leaves ``running_mean``, ``running_var`` and ``num_batches_tracked``
    as they are, while dropout and every other layer keep their mode and
    gradients still reach BatchNorm's weight and bias. Each BatchNorm's
    mode is restored on exit. ``frozen=False`` does nothing.

    A model whose class does not set ``takes_bn_frozen`` raises the
    ``TypeError`` that the JAX package's ``model.apply(..., bn_frozen=True)``
    raises for a module whose ``__call__`` has no such argument (the zoo,
    CNN1D)."""
    if not frozen:
        yield
        return
    if not getattr(model, "takes_bn_frozen", False):
        raise TypeError(f"{type(model).__name__}.__call__() got an unexpected keyword argument 'bn_frozen'")
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    modes = [m.training for m in norms]
    for m in norms:
        m.eval()
    try:
        yield
    finally:
        for m, mode in zip(norms, modes):
            m.train(mode)


def set_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Point every dropout of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, _Dropout):
            m.generator = generator
