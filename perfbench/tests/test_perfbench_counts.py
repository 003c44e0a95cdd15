"""The operation and byte counts against counts made by hand from the shapes."""

from __future__ import annotations

import pytest

from perfbench.counts import cae, cnn2d
from perfbench.lib.peaks import bound

FULL = {"in_features": 180, "frames": 321, "base_channels": 32}


def test_cnn2d_forward():
    # 2 * 9 * C_in * C_out * T * F per conv at T = 321, 160, 80
    assert cnn2d.conv_flops(FULL) == [2 * 9 * 1 * 32 * 321 * 180, 2 * 9 * 32 * 64 * 160 * 180,
                                      2 * 9 * 64 * 128 * 80 * 180]
    assert sum(cnn2d.conv_flops(FULL)) == 3_218_330_880
    assert cnn2d.forward_flops(FULL) == 3_218_330_880 + 2 * 128 * 180


def test_cnn2d_train_step():
    # forward + weight gradients + input gradients of convs 2 and 3, and the head three times
    convs = 3_218_330_880
    assert cnn2d.train_step_flops(FULL) == 2 * convs + (convs - 33_281_280) + 3 * 46_080
    assert cnn2d.train_step_flops(FULL) == pytest.approx(9.62e9, rel=1e-3)


def test_cae_forward():
    enc = 2 * 9 * (1 * 32 * 321 * 180 + 32 * 64 * 160 * 90 + 64 * 128 * 80 * 45 + 128 * 256 * 40 * 22)
    dec = 2 * 4 * (256 * 128 * 20 * 11 + 128 * 64 * 40 * 22 + 64 * 32 * 80 * 45 + 32 * 1 * 160 * 90)
    assert cae.forward_flops(FULL) == enc + dec
    assert cae.forward_flops(FULL) == pytest.approx(1.79e9, rel=1e-2)


@pytest.mark.parametrize("dtype,want", [
    ("float32", [(0.1497, "bytes"), (2.0283, "operations"), (4.0566, "operations")]),
    ("bfloat16", [(0.0748, "bytes"), (0.1409, "bytes"), (0.2748, "operations")]),
])
def test_k2_bounds_at_b128(dtype, want):
    # the bounds chip_smoke.py printed for K2 at B=128 (PERF.md's kernel table)
    got = cnn2d.k2_block_bounds(FULL, 128, dtype)
    assert [lim for _, lim in got] == [lim for _, lim in want]
    assert [round(ms, 4) for ms, _ in got] == [ms for ms, _ in want]
    assert cnn2d.k2_batch_bound_s(FULL, 128, dtype) == pytest.approx(sum(ms for ms, _ in got) / 1e3)


def test_bound_takes_the_larger_side():
    assert bound(3.35e9) == pytest.approx((1.0, "bytes"))
    assert bound(1.0, f32=67e9) == pytest.approx((1.0, "operations"))
    assert bound(3.35e9, bf16=989e9 * 2)[1] == "operations"
