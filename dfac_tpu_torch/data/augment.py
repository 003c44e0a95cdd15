"""Batch augmentations on the device, as functions of explicit draws.

Counterpart of :mod:`dfac_tpu.data.augment` (parity target reference
``src/augmentation.py:5-186``): one random draw per *batch*, not per
sample (the detector's SpecAugment apart: its masks are per sample);
contiguous masked segments with ratios uniform in [min, max],
floor-length; a circular time shift. JAX's PRNG draws cannot be
reproduced in torch, so each op is split in two:

* a deterministic function of the draws (``time_shift(x, shift)``,
  ``channel_drop(x, keep)``, ``gaussian_jitter(x, noise, std)``,
  ``_segment_mask(length, u, u2)``, the detector's per-sample
  ``dlqueen_spec_augment(x, time_draws, freq_draws)``), equal to the JAX
  op given the draws the JAX op makes from its key (the CPU tests hold
  them to it);
* a draw layer on an explicit ``torch.Generator`` on the batch's device
  (``draw_*``). Nothing leaves the device: the shift is a tensor and the
  roll a gather, so an augmented step has no host sync.

An :data:`AugmentFn` is ``(x, generator) -> x`` on model-view batches
``[B, T, F]``; :func:`build_augment_fn` chains the enabled stages in the
reference's order (specaug, shift, drop, jitter).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

AugmentFn = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


# -- deterministic ops ------------------------------------------------------


def time_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Circular shift along time by ``shift`` frames (``jnp.roll(x, shift,
    axis=1)``): ``out[:, t] = x[:, (t - shift) mod T]``."""
    t = x.shape[1]
    src = torch.remainder(torch.arange(t, device=x.device) - shift, t)
    return x.index_select(1, src)


def channel_drop(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Zero the feature columns where ``keep`` (shape (1, 1, F)) is False;
    no rescaling, as the reference."""
    return x * keep.to(x.dtype)


def gaussian_jitter(x: torch.Tensor, noise: torch.Tensor, std: float) -> torch.Tensor:
    """``x + noise * std`` with ``noise`` standard normal of x's shape."""
    return x + noise * std


def _segment_mask(length: int, u: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Boolean (length,) mask with one contiguous True segment.

    ``u`` is the ratio drawn in [min_ratio, max_ratio), ``u2`` uniform in
    [0, 1). The integer arithmetic is the JAX package's
    (``dfac_tpu/data/augment.py:56-71``): the f32 product ``length * u``
    truncated to int32 and clipped to [1, length - 1] is the segment
    length; the start is ``u2 * (length - seg + 1)`` in f32, truncated and
    held to ``length - seg``."""
    seg = (length * u.float()).to(torch.int32).clamp(1, length - 1)
    start = (u2.float() * (length - seg + 1).float()).to(torch.int32)
    start = torch.minimum(start, length - seg)
    idx = torch.arange(length, device=u.device)
    return (idx >= start) & (idx < start + seg)


def time_mask(x: torch.Tensor, u: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """SpecAugment time masking: zero one contiguous time segment for the
    whole batch (reference ``augmentation.py:83-121``)."""
    mask = _segment_mask(x.shape[1], u, u2)
    return torch.where(mask[None, :, None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def feature_mask(x: torch.Tensor, u: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """SpecAugment feature masking (reference ``augmentation.py:124-162``)."""
    mask = _segment_mask(x.shape[2], u, u2)
    return torch.where(mask[None, None, :], torch.zeros((), dtype=x.dtype, device=x.device), x)


def spec_augment(x: torch.Tensor, time_draws: tuple | None, feature_draws: tuple | None) -> torch.Tensor:
    """Combined SpecAugment (reference ``augmentation.py:165-186``): the
    time mask, then the feature mask, each where its ``(u, u2)`` is given."""
    if time_draws is not None:
        x = time_mask(x, *time_draws)
    if feature_draws is not None:
        x = feature_mask(x, *feature_draws)
    return x


def count_mask(length: int, widths: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(..., length) keep-mask with one zero segment per mask: ``widths``
    and ``u`` (shape (..., num_masks)) are each mask's width and its start
    uniform in [0, 1). The start is the JAX package's f32 product ``u *
    (length - w + 1)`` truncated to int32 (``dfac_tpu/data/augment.py:108-124``,
    the dlqueen draw scheme of reference ``src/dlqueen_model.py:33-62``)."""
    w = widths.to(torch.int32)
    start = (u.float() * (length - w + 1).float()).to(torch.int32)
    idx = torch.arange(length, device=widths.device)
    inside = (idx >= start[..., None]) & (idx < (start + w)[..., None])  # (..., num_masks, length)
    return ~inside.any(dim=-2)


def dlqueen_spec_augment(x: torch.Tensor, time_draws: tuple, freq_draws: tuple) -> torch.Tensor:
    """Per-sample time and frequency masking of (B, T, C) batches: every
    sample has its own masks (reference ``src/dlqueen_model.py:357-364``).
    ``time_draws`` and ``freq_draws`` are ``(widths, u)`` of shape (B,
    num_masks) for :func:`count_mask`; :func:`draw_dlqueen_masks` makes
    them."""
    b, t, c = x.shape
    tmask = count_mask(t, *time_draws).to(x.dtype)  # (B, T)
    fmask = count_mask(c, *freq_draws).to(x.dtype)  # (B, C)
    return x * tmask[:, :, None] * fmask[:, None, :]


# -- draws -------------------------------------------------------------------


def _uniform(gen: torch.Generator, device, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return u if (minval, maxval) == (0.0, 1.0) else minval + (maxval - minval) * u


def draw_segment(gen: torch.Generator, device, min_ratio: float, max_ratio: float) -> tuple:
    """The two uniforms of :func:`_segment_mask`."""
    return _uniform(gen, device, minval=min_ratio, maxval=max_ratio), _uniform(gen, device)


def max_time_shift(t: int, max_shift_ratio: float) -> int:
    """The largest shift the reference draws (0: the op is the identity)."""
    if max_shift_ratio <= 0 or t <= 1:
        return 0
    return int(t * max_shift_ratio)


def draw_time_shift(gen: torch.Generator, x: torch.Tensor, max_shift_ratio: float) -> torch.Tensor | None:
    """A shift uniform in [-max_shift, max_shift], or None where the op is
    the identity."""
    m = max_time_shift(x.shape[1], max_shift_ratio)
    if m < 1:
        return None
    return torch.randint(-m, m + 1, (), generator=gen, device=x.device)


def draw_channel_drop(gen: torch.Generator, x: torch.Tensor, drop_prob: float) -> torch.Tensor | None:
    """Bernoulli keep mask of shape (1, 1, F), or None for drop_prob <= 0."""
    if drop_prob <= 0:
        return None
    return _uniform(gen, x.device, (1, 1, x.shape[2])) >= drop_prob


def draw_count_masks(gen: torch.Generator, batch: int, length: int, max_width: int, num_masks: int,
                     device) -> tuple:
    """Each sample's mask widths uniform in [0, min(max_width, length)]
    (0: the mask is a no-op) and start uniforms, shape (batch, num_masks)."""
    widths = torch.randint(0, min(max_width, length) + 1, (batch, num_masks), generator=gen, device=device)
    return widths, _uniform(gen, device, (batch, num_masks))


def draw_dlqueen_masks(gen: torch.Generator, x: torch.Tensor, time_mask_max: int = 30, time_mask_n: int = 2,
                       freq_mask_max: int = 24, freq_mask_n: int = 2) -> tuple:
    """The draws of :func:`dlqueen_spec_augment` for a (B, T, C) batch."""
    b, t, c = x.shape
    return (draw_count_masks(gen, b, t, time_mask_max, time_mask_n, x.device),
            draw_count_masks(gen, b, c, freq_mask_max, freq_mask_n, x.device))


def draw_jitter(gen: torch.Generator, x: torch.Tensor, std: float) -> torch.Tensor | None:
    if std <= 0:
        return None
    return torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)


# -- pipeline ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One augmentation: ``draw(gen, x)`` makes its draws (None: the stage
    is the identity), ``apply(x, draws)`` applies them."""

    name: str
    draw: Callable[[torch.Generator, torch.Tensor], Any]
    apply: Callable[[torch.Tensor, Any], torch.Tensor]

    def __call__(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        draws = self.draw(gen, x)
        return x if draws is None else self.apply(x, draws)


def compose(*fns: AugmentFn | None) -> AugmentFn:
    """Chain augmentations in order, each drawing from the same generator
    (reference ``augmentation.py:73-80``)."""
    active = [f for f in fns if f is not None]

    def _apply(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        for f in active:
            x = f(x, gen)
        return x

    return _apply


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Flag-level mirror of the reference train.py augmentation knobs
    (``src/train.py:158-225``)."""

    spec_augment: bool = False
    time_mask_ratio: float = 0.2
    feature_mask_ratio: float = 0.1
    feature_mask: bool = False
    time_shift: bool = False
    time_shift_ratio: float = 0.1
    channel_drop: bool = False
    channel_drop_prob: float = 0.1
    gaussian_jitter: bool = False
    gaussian_jitter_std: float = 0.01

    @property
    def any_enabled(self) -> bool:
        return self.spec_augment or self.time_shift or self.channel_drop or self.gaussian_jitter


# the minimum mask ratios of the reference's time_mask / feature_mask defaults
TIME_MASK_MIN, FEATURE_MASK_MIN = 0.05, 0.02


def augment_stages(cfg: AugmentConfig) -> list[Stage]:
    """The enabled stages in the reference's application order
    (``src/train.py:343-388``): specaug, time shift, channel drop, jitter."""
    stages: list[Stage] = []
    if cfg.spec_augment:
        def draw_spec(gen, x):
            t = draw_segment(gen, x.device, TIME_MASK_MIN, cfg.time_mask_ratio)
            f = draw_segment(gen, x.device, FEATURE_MASK_MIN, cfg.feature_mask_ratio) if cfg.feature_mask else None
            return t, f

        stages.append(Stage("spec_augment", draw_spec, lambda x, d: spec_augment(x, *d)))
    if cfg.time_shift:
        stages.append(Stage("time_shift", lambda g, x: draw_time_shift(g, x, cfg.time_shift_ratio), time_shift))
    if cfg.channel_drop:
        stages.append(Stage("channel_drop", lambda g, x: draw_channel_drop(g, x, cfg.channel_drop_prob),
                            channel_drop))
    if cfg.gaussian_jitter:
        std = cfg.gaussian_jitter_std
        stages.append(Stage("gaussian_jitter", lambda g, x: draw_jitter(g, x, std),
                            lambda x, noise: gaussian_jitter(x, noise, std)))
    return stages


def build_augment_fn(cfg: AugmentConfig) -> AugmentFn | None:
    """The enabled stages chained (:func:`augment_stages`), or None."""
    stages = augment_stages(cfg)
    return compose(*stages) if stages else None
