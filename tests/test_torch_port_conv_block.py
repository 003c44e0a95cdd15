"""PyTorch port of the fused conv block against the JAX package's Pallas kernels.

On a CPU tensor ``dfac_tpu_torch.ops.conv_block.fused_conv_block`` runs the
plain version of its CUDA kernel; here it is held to ``fused_conv_block_v2``
and ``fused_conv_block`` (Pallas, interpret mode) and to
``reference_conv_block`` (XLA), on inputs made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.ops.pallas import conv_block as jcb
from dfac_tpu_torch.ops import conv_block as tcb

CASES = [
    (64, 24, 8, 16, True),
    (33, 24, 8, 16, True),   # odd H: floor-mode pool drops the tail row
    (32, 24, 8, 16, False),
    (40, 20, 1, 8, True),    # single input channel (block 1)
    (96, 24, 8, 16, True),   # several Pallas tiles
]


def _inputs(h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize("h,w,cin,cout,pool", CASES)
def test_conv_block_matches_pallas_v2_and_xla(h, w, cin, cout, pool):
    x, wk, b = _inputs(h, w, cin, cout)
    got = tcb.fused_conv_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), pool).numpy()
    with pltpu.force_tpu_interpret_mode():
        v2 = np.asarray(jcb.fused_conv_block_v2(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=pool))
    ref = np.asarray(jcb.reference_conv_block(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=pool))
    assert got.shape == v2.shape == ref.shape
    # f32 throughout; only the summation order of the 9 * C_in terms differs
    # (the bound tests/test_conv_block.py holds the Pallas kernels to)
    np.testing.assert_allclose(got, v2, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_conv_block_matches_pallas_v1():
    x, wk, b = _inputs(33, 24, 8, 16, seed=1)
    got = tcb.reference_conv_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), True).numpy()
    with pltpu.force_tpu_interpret_mode():
        v1 = np.asarray(jcb.fused_conv_block(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=True))
    np.testing.assert_allclose(got, v1, atol=1e-4, rtol=1e-4)


def test_conv_block_bf16_pools_before_the_cast():
    """bf16: the pool runs in f32 and the result is cast once, as in the
    Pallas epilogue; the two sides differ only where an f32 sum taken in
    another order rounds to the neighbouring bf16 value (one last bit)."""
    x, wk, b = _inputs(33, 24, 8, 16, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tcb.fused_conv_block(xb, torch.from_numpy(wk), torch.from_numpy(b), True)
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = jcb.fused_conv_block_v2(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk), jnp.asarray(b), pool=True)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    bound = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert (np.abs(got - want) <= bound).all()


def test_conv_block_rejects_other_devices():
    x, wk, b = _inputs(8, 8, 2, 4)
    with pytest.raises(ValueError):
        tcb.fused_conv_block(torch.from_numpy(x).to("meta"), torch.from_numpy(wk), torch.from_numpy(b))
