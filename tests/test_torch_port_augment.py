"""Augmentation and byte dropout in the PyTorch port against the JAX package.

JAX's PRNG draws cannot be reproduced in torch, so the port writes each op
as a function of its draws. Here the draws are the ones the JAX op makes
from its key (computed with the same ``jax.random`` calls), and each port
op must give the JAX op's output exactly: the ops select, gather, multiply
by 0/1 or add the same f32 products. The port's own draw layer is checked
by its distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfac_tpu.data import augment as jaug
from dfac_tpu.models import common as jcommon
from dfac_tpu_torch.data import augment as taug
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.models import common as tcommon

B, T, F = 3, 37, 20


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, F)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _segment_draws(key, min_ratio, max_ratio):
    """The two uniforms ``jaug._segment_mask`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, (), minval=min_ratio, maxval=max_ratio), jax.random.uniform(k2, ()))


# -- byte dropout -----------------------------------------------------------


@pytest.mark.parametrize("rate,thresh", [(0.0, 0), (0.2, 51), (1.0, 256), (0.999, 256), (0.001, 0)])
def test_byte_dropout_equals_jax_on_the_same_bits(rate, thresh):
    assert tcommon.byte_dropout_thresh(rate) == jcommon.byte_dropout_thresh(rate) == thresh
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 9, 7)).astype(np.float32)
    bits = rng.integers(0, 256, size=x.shape, dtype=np.uint8)
    want = np.asarray(jcommon.apply_byte_dropout(jnp.asarray(x), jnp.asarray(bits), thresh))
    got = tcommon.apply_byte_dropout(_t(x), _t(bits), thresh).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_dropout_draws_the_quantized_keep_rate():
    n = 1 << 20
    mod = tcommon.FastDropout(0.2).train()
    mod.generator = torch.Generator().manual_seed(3)
    out = mod(torch.ones(n))
    kept = out != 0
    p = 205 / 256
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept.float().mean().item() - p) <= 4 * sigma
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 256 / 205))  # 1 / (205/256), the true keep rate
    again = tcommon.FastDropout(0.2).train()
    again.generator = torch.Generator().manual_seed(3)
    assert torch.equal(again(torch.ones(n)), out)  # the explicit generator decides the mask
    x = torch.randn(5, 6)
    assert torch.equal(mod.eval()(x), x)  # inert in eval mode
    assert torch.equal(tcommon.FastDropout(1.0).train()(x), torch.zeros_like(x))


def test_cnn2d_dropout_has_no_parameters_in_the_state_dict():
    model = build_model("cnn2d", in_features=F, base_channels=4)
    assert [type(m).__name__ for m in model.conv].count("FastDropout") == 2
    assert isinstance(model.conv[4], tcommon.FastDropout) and isinstance(model.conv[9], tcommon.FastDropout)
    assert not any(".4." in k or ".9." in k for k in model.state_dict())


# -- the ops on JAX's draws ----------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_time_shift_channel_drop_jitter_equal_jax_on_its_draws(seed):
    key = jax.random.key(seed)
    x = _x(seed)
    m = int(T * 0.1)
    shift = jax.random.randint(key, (), -m, m + 1)
    assert taug.max_time_shift(T, 0.1) == m
    np.testing.assert_array_equal(taug.time_shift(_t(x), _t(shift)).numpy(),
                                  np.asarray(jaug.time_shift(key, jnp.asarray(x), 0.1)))
    for s in (-T - 3, -1, 0, 5, T):  # any shift, as jnp.roll
        np.testing.assert_array_equal(taug.time_shift(_t(x), torch.tensor(s)).numpy(), np.roll(x, s, axis=1))
    keep = jax.random.uniform(key, (1, 1, F)) >= 0.3
    np.testing.assert_array_equal(taug.channel_drop(_t(x), _t(keep)).numpy(),
                                  np.asarray(jaug.channel_drop(key, jnp.asarray(x), 0.3)))
    noise = jax.random.normal(key, x.shape, jnp.float32)
    np.testing.assert_array_equal(taug.gaussian_jitter(_t(x), _t(noise), 0.005).numpy(),
                                  np.asarray(jaug.gaussian_jitter(key, jnp.asarray(x), 0.005)))


@pytest.mark.parametrize("length,lo,hi", [(321, 0.05, 0.2), (180, 0.02, 0.1), (37, 0.05, 0.9), (2, 0.05, 0.2)])
def test_segment_mask_equals_jax_on_its_draws(length, lo, hi):
    for seed in range(25):
        key = jax.random.key(seed)
        u, u2 = _segment_draws(key, lo, hi)
        want = np.asarray(jaug._segment_mask(key, length, lo, hi))
        got = taug._segment_mask(length, _t(u), _t(u2)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 1 <= got.sum() <= max(length - 1, 1)


@pytest.mark.parametrize("u,u2", [(0.0, 0.0), (0.999999, 0.999999), (0.5, 0.999999), (0.00311, 0.5)])
def test_segment_mask_integer_rules_at_the_edges(u, u2):
    """The f32 product truncated to int32, clipped to [1, L - 1], and the
    start held to L - seg: the port's arithmetic on edge draws equals a
    numpy transcription of ``dfac_tpu/data/augment.py:56-71``."""
    for length in (2, 37, 321):
        seg = int(np.clip(np.int32(np.float32(length) * np.float32(u)), 1, length - 1))
        start = min(int(np.int32(np.float32(u2) * np.float32(length - seg + 1))), length - seg)
        want = (np.arange(length) >= start) & (np.arange(length) < start + seg)
        got = taug._segment_mask(length, torch.tensor(u, dtype=torch.float32), torch.tensor(u2, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("feature", [False, True])
def test_masks_and_spec_augment_equal_jax_on_its_draws(feature):
    x = _x(5)
    for seed in range(5):
        key = jax.random.key(seed)
        kt, kf = jax.random.split(key)
        t_draws = tuple(_t(d) for d in _segment_draws(kt, 0.05, 0.2))
        f_draws = tuple(_t(d) for d in _segment_draws(kf, 0.02, 0.1))
        np.testing.assert_array_equal(taug.time_mask(_t(x), *t_draws).numpy(),
                                      np.asarray(jaug.time_mask(kt, jnp.asarray(x), 0.2)))
        np.testing.assert_array_equal(taug.feature_mask(_t(x), *f_draws).numpy(),
                                      np.asarray(jaug.feature_mask(kf, jnp.asarray(x), 0.1)))
        want = jaug.spec_augment(key, jnp.asarray(x), 0.2, 0.1, apply_feature_mask=feature)
        got = taug.spec_augment(_t(x), t_draws, f_draws if feature else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_pipeline_draws(cfg, key, x):
    """The draws JAX's ``build_augment_fn(cfg)(key, x)`` makes, stage by
    stage in its order: ``compose`` splits the key per active stage."""
    n_active = sum((cfg.spec_augment, cfg.time_shift, cfg.channel_drop, cfg.gaussian_jitter))
    keys = iter(jax.random.split(key, n_active))
    draws = []
    if cfg.spec_augment:
        kt, kf = jax.random.split(next(keys))
        t = tuple(_t(d) for d in _segment_draws(kt, 0.05, cfg.time_mask_ratio))
        f = tuple(_t(d) for d in _segment_draws(kf, 0.02, cfg.feature_mask_ratio)) if cfg.feature_mask else None
        draws.append((t, f))
    if cfg.time_shift:
        m = int(x.shape[1] * cfg.time_shift_ratio)
        draws.append(_t(jax.random.randint(next(keys), (), -m, m + 1)))
    if cfg.channel_drop:
        draws.append(_t(jax.random.uniform(next(keys), (1, 1, x.shape[2])) >= cfg.channel_drop_prob))
    if cfg.gaussian_jitter:
        draws.append(_t(jax.random.normal(next(keys), x.shape, jnp.float32)))
    return draws


RECIPE = dict(spec_augment=True, time_mask_ratio=0.2, feature_mask=True, feature_mask_ratio=0.1, time_shift=True,
              time_shift_ratio=0.1, channel_drop=True, channel_drop_prob=0.05, gaussian_jitter=True,
              gaussian_jitter_std=0.005)


@pytest.mark.parametrize("enabled", [tuple(RECIPE), ("spec_augment", "time_shift"), ("channel_drop",
                                                                                    "gaussian_jitter")])
def test_pipeline_order_and_compose_equal_jax(enabled):
    flags = {k: v for k, v in RECIPE.items() if not isinstance(v, bool) or k in enabled}
    flags.update({k: False for k, v in RECIPE.items() if isinstance(v, bool) and k not in enabled})
    jcfg, tcfg = jaug.AugmentConfig(**flags), taug.AugmentConfig(**flags)
    stages = taug.augment_stages(tcfg)
    order = [s.name for s in stages]
    assert order == [n for n in ("spec_augment", "time_shift", "channel_drop", "gaussian_jitter") if flags.get(n)]
    x = _x(7)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(jaug.build_augment_fn(jcfg)(key, jnp.asarray(x)))
        got = _t(x)
        for stage, draws in zip(stages, _jax_pipeline_draws(jcfg, key, x), strict=True):
            got = stage.apply(got, draws)
        np.testing.assert_array_equal(got.numpy(), want)
    # compose chains in order, each stage drawing from one generator
    fn = taug.build_augment_fn(tcfg)
    a = fn(_t(x), torch.Generator().manual_seed(9))
    b = _t(x)
    gen = torch.Generator().manual_seed(9)
    for stage in stages:
        b = stage(b, gen)
    assert torch.equal(a, b)
    assert taug.build_augment_fn(taug.AugmentConfig()) is None


def test_draw_layer_distributions():
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(2, 321, 180)
    us = torch.stack([taug.draw_segment(gen, "cpu", 0.05, 0.2)[0] for _ in range(4000)])
    u2s = torch.stack([taug.draw_segment(gen, "cpu", 0.05, 0.2)[1] for _ in range(4000)])
    assert 0.05 <= us.min() and us.max() < 0.2 and abs(us.mean().item() - 0.125) < 0.005
    assert 0.0 <= u2s.min() and u2s.max() < 1.0 and abs(u2s.mean().item() - 0.5) < 0.02
    shifts = torch.stack([taug.draw_time_shift(gen, x, 0.1) for _ in range(6000)])
    assert shifts.min() == -32 and shifts.max() == 32 and abs(shifts.float().mean().item()) < 1.0
    keep = torch.cat([taug.draw_channel_drop(gen, x, 0.05).reshape(-1) for _ in range(200)])
    assert abs(keep.float().mean().item() - 0.95) < 0.005
    noise = taug.draw_jitter(gen, x, 0.005)
    assert noise.shape == x.shape and abs(noise.mean().item()) < 0.01 and abs(noise.std().item() - 1) < 0.01
    # the inert settings draw nothing, as the JAX ops return x
    assert taug.draw_time_shift(gen, torch.zeros(1, 5, 3), 0.1) is None
    assert taug.draw_channel_drop(gen, x, 0.0) is None and taug.draw_jitter(gen, x, 0.0) is None
