"""PyTorch port of the LFCC front-end (``dfac_tpu_torch``) against the JAX package.

Inputs are numpy from a seed; both packages run on the CPU. The port's
front-end on a CPU tensor is the plain version of its CUDA kernel, so these
tests hold the kernel's arithmetic and the constants it reads to the JAX
reference. The Pallas kernel runs in interpret mode, as
``tests/test_gemm_frontend.py`` runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.features import lfcc as jlfcc
from dfac_tpu.ops.pallas import gemm_frontend as jgemm
from dfac_tpu_torch.features import lfcc as tlfcc
from dfac_tpu_torch.ops import gemm_frontend as tgemm

CFG_J = jlfcc.LFCCConfig()
CFG_T = tlfcc.LFCCConfig()


def _waves(frames, n=2, seed=0):
    rng = np.random.default_rng(seed)
    samples = CFG_T.num_samples(frames)
    t = np.arange(samples) / CFG_T.sample_rate
    tone = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3333 * t)
    return (tone + 0.05 * rng.normal(size=(n, samples))).astype(np.float32)


def test_host_constants_match_jax():
    # the numpy constants were copied; they must stay identical
    np.testing.assert_array_equal(tlfcc.hamming_window(320), jlfcc.hamming_window(320))
    np.testing.assert_array_equal(tlfcc.linear_filterbank(CFG_T), jlfcc.linear_filterbank(CFG_J))
    np.testing.assert_array_equal(tlfcc.dct_matrix(120, 60), jlfcc.dct_matrix(120, 60))
    np.testing.assert_array_equal(tlfcc.delta_kernel(2), jlfcc.delta_kernel(2))
    basis_j, fb_j, dct_j = jgemm._host_constants(CFG_J)
    cos_b, sin_b, fb, dct = tgemm.host_constants(CFG_T)
    np.testing.assert_array_equal(cos_b, basis_j[:320, :257])
    np.testing.assert_array_equal(sin_b, basis_j[:320, 384:641])
    np.testing.assert_array_equal(fb, fb_j[:257, :120])
    np.testing.assert_array_equal(dct, dct_j[:120, :60])


def test_kernel_constants_layout():
    """The kernel's bases hold exactly the plain constants. bf16: the ring's
    stage images [chunk][K slab][n][k], 64-byte swizzled, column n of chunk c
    the cos (n % 16 < 8) or sin of bin 64c + 8(n // 16) + n % 8, each of bins 0..255 once;
    f32: [cos of bins 128c..128c+127 | their sin] for c = 0, 1. The
    filterbank reads no bin past 255, which both leave out."""
    b16, b32, fb_lo, fb_hi = tgemm.kernel_constants(CFG_T)
    cos_b, sin_b, fb, _ = tgemm.host_constants(CFG_T)
    assert b16.shape == (4, 10, 128, 32)
    n = np.arange(128)[:, None]
    k = np.arange(32)[None, :]
    # the 64-byte swizzle: element k of row n lies in 16-byte chunk (k // 8) ^ ((n // 2) % 4)
    stages = b16[:, :, n, 8 * ((k // 8) ^ ((n >> 1) & 3)) + k % 8]
    cols = stages.transpose(0, 2, 1, 3).reshape(4, 128, 320)  # (chunk, n, k)
    n = np.arange(128)
    is_cos = n % 16 < 8
    seen = []
    for c in range(4):
        bins = 64 * c + 8 * (n // 16) + n % 8
        np.testing.assert_array_equal(cols[c][is_cos].T, cos_b[:, bins[is_cos]])
        np.testing.assert_array_equal(cols[c][~is_cos].T, sin_b[:, bins[~is_cos]])
        seen.append(bins[is_cos])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(256))
    assert not fb[256:].any() and (fb_hi <= 255).all()  # bin 256 feeds no filter
    assert (fb_hi - fb_lo).max() < tgemm.MAX_BAND and (np.diff(fb_hi) >= 0).all()
    assert np.bincount(fb_hi // 64).max() <= tgemm.BF16_MAX_FILTERS
    assert np.bincount(fb_hi // 128).max() <= tgemm.F32_MAX_FILTERS
    assert b32.shape == (320, 512)
    for c in range(2):
        np.testing.assert_array_equal(b32[:, 256 * c: 256 * c + 128], cos_b[:, 128 * c: 128 * (c + 1)])
        np.testing.assert_array_equal(b32[:, 256 * c + 128: 256 * (c + 1)], sin_b[:, 128 * c: 128 * (c + 1)])
    # banded filterbank sum == dense product (skipped terms are exact zeros)
    rows = np.arange(257)[:, None]
    band = (rows >= fb_lo[None, :]) & (rows <= fb_hi[None, :])
    assert not fb[~band].any()
    power = np.random.default_rng(0).random((5, 257)).astype(np.float32)
    banded = np.stack(
        [(power[:, fb_lo[m]: fb_hi[m] + 1] * fb[fb_lo[m]: fb_hi[m] + 1, m]).sum(1) for m in range(120)], 1
    )
    np.testing.assert_allclose(banded, power @ fb, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_filters", [200, 40])
def test_kernel_constants_refuse_other_filterbanks(n_filters):
    """The kernel's epilogue assumes the default filterbank's shape: 200
    filters put more than 32 ends in a 64-bin chunk, 40 filters span more
    than 5 bins each. kernel_constants refuses both rather than let the
    kernel read past its power ring."""
    import dataclasses

    with pytest.raises(ValueError, match="does not fit"):
        tgemm.kernel_constants(dataclasses.replace(CFG_T, n_filters=n_filters))


@pytest.mark.parametrize("frames", [33, 17])
def test_frames_by_reshape_matches_jax(frames):
    w = _waves(frames)
    got = tgemm.frames_by_reshape(torch.from_numpy(w), CFG_T).numpy()
    want = np.asarray(jgemm.frames_by_reshape(jnp.asarray(w), CFG_J))
    np.testing.assert_array_equal(got, want)  # pure data movement: exact
    np.testing.assert_array_equal(tlfcc.frames(torch.from_numpy(w), CFG_T).numpy(), want)


def test_compute_deltas_matches_jax():
    c = np.random.default_rng(1).normal(size=(3, 21, 60)).astype(np.float32)
    got = tlfcc.compute_deltas(torch.from_numpy(c), 2).numpy()
    want = np.asarray(jlfcc.compute_deltas(jnp.asarray(c), 2))
    # same five terms in the same order; XLA may fuse multiply-adds
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("frames", [33, 17])
def test_gemm_features_match_jax_pallas(frames):
    w = _waves(frames, seed=frames)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgemm.gemm_lfcc_features_tf(jnp.asarray(w), CFG_J))
    got = tgemm.gemm_lfcc_features_tf(torch.from_numpy(w), CFG_T).numpy()
    assert got.shape == want.shape == (2, frames, 180)
    # both are f32 products of the same constants in different summation
    # orders; the log of the smallest energies amplifies that a little
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
    stored = tgemm.gemm_lfcc_features(torch.from_numpy(w), CFG_T).numpy()
    np.testing.assert_array_equal(stored, np.swapaxes(got, -1, -2))


def test_gemm_features_match_jax_fft():
    w = _waves(33)
    want = np.asarray(jlfcc.lfcc_features(jnp.asarray(w), CFG_J))
    got = tgemm.gemm_lfcc_features(torch.from_numpy(w), CFG_T).numpy()
    # direct DFT vs FFT: same math, other summation order (the JAX package's
    # own bound, tests/test_gemm_frontend.py:47)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)
    fft_port = tlfcc.lfcc_features(torch.from_numpy(w), CFG_T).numpy()
    np.testing.assert_allclose(fft_port, want, atol=5e-3, rtol=1e-3)


def test_bf16_compute_rounds_operands_only():
    w = _waves(17)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jgemm.gemm_lfcc_cepstra(jnp.asarray(w), CFG_J, compute_dtype=jnp.bfloat16))
    got = tgemm.gemm_lfcc_cepstra(torch.from_numpy(w), CFG_T, torch.bfloat16).numpy()
    # identical bf16 operands, f32 accumulation on both sides
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)
