"""The port's probe kernels (5-9) against the JAX probes' own Pallas kernels.

On CPU tensors the port's wrappers run their plain versions; every JAX call
runs under ``pltpu.force_tpu_interpret_mode()``. Arrays cross over as numpy.

* K6: ``scripts/pallas_err_probe.py`` is imported with ``sys.argv`` cleared
  (it runs all four cases at import), then each case runs once more through
  its ``run``.
* K7, K8, K9: ``scripts/train_opt_probe.py``'s ``stage11_pallas_conv1``
  (B=16: two of ``kern_v3``'s 8-sample groups), ``stage12_conv_formulations``
  (B=2) and ``stage13_conv_aligned`` (B=2) run with ``bench_slope``
  replaced by a capture of ``(fn(*args), args)``.
* K5: the probe's ``_pool_kernel`` is a closure inside ``main()``, so a copy
  of its body and BlockSpecs (``pool_kernel_probe.py:81-109``) stands in for
  it, first held to ``flax.linen.avg_pool``.

Checksum bound: bf16 x bf16 products are exact in f32, so the two sides
differ only by f32 summation order: |port - JAX| <= 1e-5 * sum |y| per
sample, with sum |y| from the plain version in f64.
"""

import functools
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu_torch.models.fast_infer import fold_cnn2d
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops import conv_probe as tcp
from dfac_tpu_torch.ops.pool import time_pool, time_pool_plain
from dfac_tpu_torch.scripts import pallas_err_probe as t_err
from dfac_tpu_torch.scripts import pool_kernel_probe as t_pool
from dfac_tpu_torch.scripts import train_opt_probe as t_opt
from dfac_tpu_torch.utils.convert import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _import_script(name: str):
    """Import ``scripts/<name>.py`` under interpret mode, with no arguments."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [f"{name}.py"]
    try:
        with pltpu.force_tpu_interpret_mode():
            spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def _check_checksums(case: tcp.Case, inp, w, want: np.ndarray) -> None:
    """The port's ``case`` on JAX arrays against the Pallas output."""
    x, wt = _to_torch(inp), _to_torch(w)
    got = case.kernel(x, wt).numpy()
    y = case.plain(x, wt).double()
    bound = 1e-5 * y.abs().sum(dim=tuple(range(1, y.dim()))).numpy()
    assert got.shape == want.shape == (y.shape[0], 8, 128)
    assert (got == got[:, :1, :1]).all() and (want == want[:, :1, :1]).all()
    assert (np.abs(got[:, 0, 0] - want[:, 0, 0]) <= bound).all(), (got[:, 0, 0], want[:, 0, 0], bound)


@pytest.fixture(scope="module")
def err_probe():
    return _import_script("pallas_err_probe")


@pytest.mark.parametrize("name", ["g", "i", "j", "k"])
def test_k6_checksums_match_pallas(err_probe, name):
    kern, arr, blk, warr = err_probe.CASES[name]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(err_probe.run(kern, arr, blk, warr)(arr, warr))
    _check_checksums(tcp.CASES[name], arr, warr, want)


@pytest.fixture(scope="module")
def opt_probe():
    return _import_script("train_opt_probe")


def _capture_stage(mod, stage: str, batch: int, names) -> dict:
    """Run the JAX script's ``stage`` at ``batch`` in interpret mode with each
    timing replaced by one call: {case: (Pallas output, (input, w))}."""
    captured = []

    def capture(fn, *args, **_):
        captured.append((np.asarray(fn(*args)), args))
        return 1.0

    mod.bench_slope = capture
    with pltpu.force_tpu_interpret_mode():
        getattr(mod, stage)(batch, jnp.bfloat16)
    assert len(captured) == len(names)
    return dict(zip(names, captured))


@pytest.fixture(scope="module")
def stage13_capture(opt_probe):
    """Stage 13 at B=2 in interpret mode."""
    return _capture_stage(opt_probe, "stage13_conv_aligned", 2, "ghijk")


@pytest.mark.parametrize("name", ["g", "h", "i", "j", "k"])
def test_k9_stage13_checksums_match_pallas(stage13_capture, name):
    want, (inp, w) = stage13_capture[name]
    _check_checksums(tcp.CASES[name], inp, w, want)


@pytest.fixture(scope="module")
def stage11_capture(opt_probe):
    """Stage 11 at B=16 (two of ``kern_v3``'s groups of 8): the XLA control,
    then v0-v4."""
    return _capture_stage(opt_probe, "stage11_pallas_conv1", 16, ["control", *tcp.STAGE11_CASES])


@pytest.fixture(scope="module")
def stage12_capture(opt_probe):
    """Stage 12 at B=2: a, c, d, f."""
    return _capture_stage(opt_probe, "stage12_conv_formulations", 2, list(tcp.STAGE12_CASES))


def _close_bf16_last_bit(got: np.ndarray, want: np.ndarray) -> bool:
    """Within one bf16 last bit (rtol 2^-7 + atol 1e-4, K2's bound): f32 sums
    taken in other orders can straddle a rounding boundary."""
    return bool((np.abs(got - want) <= 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-4).all())


@pytest.mark.parametrize("name", ["v0", "v1", "v2", "v3"])
def test_k7_stage11_checksums_match_pallas(stage11_capture, name):
    """v3 at B=16: two sums of 8 samples each; the bound is 1e-5 sum |y| over
    the group (for v0, y = (x, x^2): 1e-5 (sum |x| + sum x^2))."""
    want, (inp, w) = stage11_capture[name]
    _check_checksums(tcp.STAGE11_CASES[name], inp, w, want)
    if name == "v3":
        assert want.shape == (2, 8, 128)


def test_k7_emit_matches_pallas(stage11_capture):
    want, (inp, w) = stage11_capture["v4"]
    x, wt = _to_torch(inp), _to_torch(w)
    got = tcp.conv1_emit(x, wt)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (16, 160, 180, 32)
    assert _close_bf16_last_bit(got.float().numpy(), want.astype(np.float32))
    assert np.mean(got.float().numpy() != want.astype(np.float32)) < 1e-3


def test_stage11_control_is_the_jax_conv(stage11_capture):
    """The port's control (one bf16 ``F.conv2d``, NHWC out) computes the JAX
    script's XLA conv1 (bf16 in and out, f32 sums in other orders)."""
    want, (inp, w) = stage11_capture["control"]
    got = t_opt.conv1_control(_to_torch(inp), _to_torch(w))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (16, 321, 180, 32)
    assert _close_bf16_last_bit(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("name", ["a", "c", "d", "f"])
def test_k8_stage12_checksums_match_pallas(stage12_capture, name):
    """c included: its Pallas taps 7 and 8 are clamped (see the formula test)."""
    want, (inp, w) = stage12_capture[name]
    _check_checksums(tcp.STAGE12_CASES[name], inp, w, want)


def test_k9_sample0_equals_k6(err_probe, stage13_capture):
    """The two scripts draw the same arrays, so stage 13's sample 0 is K6's."""
    for name in "gijk":
        _, (inp, w) = stage13_capture[name]
        _, arr, _, warr = err_probe.CASES[name]
        np.testing.assert_array_equal(np.asarray(inp[:1]), np.asarray(arr[:1]))
        np.testing.assert_array_equal(np.asarray(w), np.asarray(warr))


def _y_direct(name: str, inp: np.ndarray, w: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """y from the formulas in ``ops/conv_probe.py``'s docstring, as loops in f64."""
    if name == "i":
        return inp @ w
    conv1 = name in "gh"
    x = inp[..., None] if conv1 else inp
    w = w.reshape(9, 1, -1) if conv1 else w
    width = x.shape[2] if name in "gk" else cols
    y = np.zeros((x.shape[0], rows, width, w.shape[-1]))
    for k in range(9):
        dy, dx = divmod(k, 3)
        for f in range(width):
            col = (f + dx - 1) % x.shape[2] if name in "gk" else f + dx
            y[:, :, f] += x[:, dy : dy + rows, col] @ w[k]
    return y


@pytest.mark.parametrize("name", ["g", "h", "i", "j", "k"])
def test_plain_versions_follow_the_formulas(name, monkeypatch):
    """Every y of the plain versions, the wrap columns included, at a tiny
    size (the module's output windows shrunk to rows x cols)."""
    rng = np.random.default_rng(ord(name))
    rows, cols = 5, 6
    for const, value in (("CONV1_ROWS", rows), ("CONV1_SLICE_COLS", cols), ("CONV2_ROWS", rows),
                         ("CONV2_SLICE_COLS", cols)):
        monkeypatch.setattr(tcp, const, value)
    shapes = {"g": ((2, 8, 10), (9, 3)), "h": ((2, 8, 10), (9, 3)), "i": ((2, rows, cols, 9), (9, 3)),
              "j": ((2, 8, 10, 4), (9, 4, 5)), "k": ((2, 8, 10, 4), (9, 4, 5))}
    inp, w = (rng.normal(size=s).astype(np.float32) for s in shapes[name])
    x, wt = torch.from_numpy(inp).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    want = _y_direct(name, x.double().numpy(), wt.double().numpy(), rows, cols)
    fn = {"g": lambda: tcp.conv1_taps_checksum(x, wt, "roll", return_y=True),
          "h": lambda: tcp.conv1_taps_checksum(x, wt, "slice", return_y=True),
          "i": lambda: tcp.patches_checksum(x, wt, return_y=True),
          "j": lambda: tcp.conv2_checksum(x, wt, "slice", return_y=True),
          "k": lambda: tcp.conv2_checksum(x, wt, "roll", return_y=True)}[name]
    out, y = fn()
    assert y.shape == want.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=1e-5)  # f32 sums of <= 36 exact products
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(y.sum(dim=(1, 2, 3)).numpy()[:, None, None], (2, 8, 128)))


def _y_pass_direct(name: str, inp: np.ndarray, w: np.ndarray) -> np.ndarray:
    """y of the K7/K8 cases from ``ops/conv_probe.py``'s docstring, as loops
    in f64; c's taps come from ``jax.lax.dynamic_slice`` itself."""
    if name == "v0":
        return np.stack([inp, inp * inp], axis=-1)
    if name == "c":
        width = tcp.FLAT_WIDTH
        xf = jnp.asarray(inp[:, 0])
        m = inp.shape[-1] - 2 * width
        taps = [np.asarray(jax.lax.dynamic_slice(xf, (0, dy * width + dx), (xf.shape[0], m)), np.float64)
                for dy in range(3) for dx in range(3)]
        return np.stack(taps, axis=-1) @ w
    if name == "f":
        ci = inp.shape[-1]
        rows, cols = inp.shape[1] - 2, inp.shape[2] - 2
        y = np.zeros((inp.shape[0], rows, cols, w.shape[-1]))
        for dy in range(3):
            for dx in range(3):
                y += inp[:, dy : dy + rows, dx : dx + cols] @ w[dx, ci * dy : ci * (dy + 1)]
        return y
    same = name in ("v1", "v2", "v3", "v4")
    x = np.pad(inp, ((0, 0), (1, 1), (1, 1))) if same else inp
    w9 = w.reshape(9, -1)
    rows, cols = x.shape[1] - 2, x.shape[2] - 2
    y = np.zeros((x.shape[0], rows, cols, w9.shape[-1]))
    for k in range(9):
        dy, dx = divmod(k, 3)
        y += x[:, dy : dy + rows, dx : dx + cols, None] * w9[k]
    if name == "v3":  # groups of 8; the tail is dropped
        n = y.shape[0] // tcp.GROUP
        y = y[: tcp.GROUP * n].reshape(n, tcp.GROUP * rows, cols, -1)
    if name == "v4":
        a = np.maximum(y * np.float32(1.01) + np.float32(0.01), 0.0)
        tp = rows // 2
        y = 0.5 * (a[:, 0 : 2 * tp : 2] + a[:, 1 : 2 * tp : 2])
    return y


PASS_SHAPES = {  # (input, weights) at a tiny size: odd T, F not a multiple of 8
    "v0": ((2, 5, 7), (3, 3, 4)), "v1": ((2, 5, 7), (3, 3, 4)), "v2": ((2, 5, 7), (3, 3, 4)),
    "v3": ((12, 5, 7), (3, 3, 4)),  # one group of 8 and a tail of 4
    "v4": ((2, 7, 6), (3, 3, 4)),   # odd T: conv row 6 is dropped
    "a": ((2, 5, 7), (9, 4)), "d": ((2, 5, 7), (9, 4)),
    "c": ((2, 1, 5 * 6), (9, 4)),   # T = 3, F = 4: W = 6, Np = 30, M = 18
    "f": ((2, 5, 6, 4), (3, 12, 5)),
}


@pytest.mark.parametrize("name", list(PASS_SHAPES))
def test_pass_plain_versions_follow_the_formulas(name, monkeypatch):
    """Every y (v4: every emitted value) of the stage 11/12 plain versions,
    through the CPU wrappers, at a tiny size (c's row width shrunk to 6)."""
    monkeypatch.setattr(tcp, "FLAT_WIDTH", 6)
    rng = np.random.default_rng(len(name) + ord(name[-1]))
    s_in, s_w = PASS_SHAPES[name]
    x = torch.from_numpy(rng.normal(size=s_in).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=s_w).astype(np.float32)).to(torch.bfloat16)
    want = _y_pass_direct(name, x.double().numpy(), w.double().numpy())
    if name == "v4":
        got = tcp.conv1_emit(x, w)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 3, 6, 4)
        assert _close_bf16_last_bit(got.float().numpy(), want)
        return
    fn = {"v0": lambda: (tcp.sum_sq_checksum(x), tcp.sum_sq_plain(x)),
          "v1": lambda: tcp.conv1_same_checksum(x, w, "fma", return_y=True),
          "v2": lambda: tcp.conv1_same_checksum(x, w, "mma", return_y=True),
          "v3": lambda: tcp.conv1_group_checksum(x, w, return_y=True),
          "a": lambda: tcp.conv1_valid_checksum(x, w, "mma", return_y=True),
          "d": lambda: tcp.conv1_valid_checksum(x, w, "fma", return_y=True),
          "c": lambda: tcp.flat_shift_checksum(x, w, return_y=True),
          "f": lambda: tcp.conv2_dx_checksum(x, w, return_y=True)}[name]
    out, y = fn()
    assert y.shape == want.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=1e-5)  # f32 sums of <= 36 exact products
    sums = y.double().sum(dim=tuple(range(1, y.dim()))).numpy()
    assert out.shape == (want.shape[0], 8, 128)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(sums[:, None, None], out.shape), rtol=1e-6)


def test_flat_shift_reads_clamped_taps(monkeypatch):
    """kern_c's dynamic slices of M = Np - 2W from offsets dy W + dx: the
    starts 2W + 1 and 2W + 2 (taps 7, 8) are clamped to 2W, tap 6's, so the
    three taps read one window; zero-filling past the end would differ."""
    assert tcp.flat_offsets() == [0, 1, 2, 182, 183, 184, 364, 364, 364]
    monkeypatch.setattr(tcp, "FLAT_WIDTH", 6)
    xf = torch.arange(30, dtype=torch.float32).reshape(1, 1, 30).to(torch.bfloat16)
    w9 = torch.zeros(9, 1, dtype=torch.bfloat16)
    w9[8] = 1  # y = tap 8 alone
    y = tcp.flat_shift_plain(xf, w9)[0, :, 0]
    np.testing.assert_array_equal(y.numpy(), np.arange(12, 30))  # xf[12 + m], not xf[14 + m]


def test_v3_drops_the_tail_and_v4_floors_odd_t():
    x = torch.randn(12, 5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w = torch.randn(3, 3, 4, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    tail = x.clone()
    tail[8:] = 1e4  # samples past the last full group are not read
    assert torch.equal(tcp.conv1_group_checksum(x, w), tcp.conv1_group_checksum(tail, w))
    assert tcp.conv1_group_checksum(x[:7], w).shape == (0, 8, 128)
    odd = tcp.conv1_emit(x[:, :5], w)
    assert odd.shape == (12, 2, 7, 4)  # T = 5: conv rows (0, 1), (2, 3); conv row 4 is dropped
    # ... but input row 4 is still conv row 3's halo: one more zero row changes nothing
    six = torch.cat([x[:, :5], torch.zeros_like(x[:, :1])], dim=1)
    assert torch.equal(odd, tcp.conv1_emit(six, w)[:, :2])


def test_conv_probe_rejects_bad_arguments():
    x = torch.zeros(1, 12, 16, dtype=torch.bfloat16)
    w9 = torch.zeros(9, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mode"):
        tcp.conv1_taps_checksum(x, w9, "wrap")
    with pytest.raises(ValueError, match="outside"):
        tcp.conv1_taps_checksum(x, w9, "slice")  # 322 rows of taps in 12
    with pytest.raises(ValueError, match="w2"):
        tcp.conv2_checksum(torch.zeros(1, 12, 16, 4), torch.zeros(9, 3, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        tcp.patches_checksum(torch.zeros(1, 2, 2, 9, device="meta"), torch.zeros(9, 4, device="meta"))


def test_conv_pass_rejects_bad_arguments(monkeypatch):
    x = torch.zeros(2, 5, 7, dtype=torch.bfloat16)
    w, w9 = torch.zeros(3, 3, 4, dtype=torch.bfloat16), torch.zeros(9, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unit"):
        tcp.conv1_same_checksum(x, w, "vpu")
    with pytest.raises(ValueError, match=r"w \(9, 'CO'\)"):
        tcp.conv1_valid_checksum(x, w)  # stage 11's (3, 3, CO) weights where stage 12's (9, CO) go
    with pytest.raises(ValueError, match=r"w \(3, 3, 'CO'\)"):
        tcp.conv1_emit(x, w9)
    with pytest.raises(ValueError, match="VALID"):
        tcp.conv1_valid_checksum(x[:, :2], w9)
    with pytest.raises(ValueError, match="no output"):
        monkeypatch.setattr(tcp, "FLAT_WIDTH", 15)
        tcp.flat_shift_checksum(torch.zeros(2, 1, 30), w9)  # M = 30 - 30
    with pytest.raises(ValueError, match="w2dx"):
        tcp.conv2_dx_checksum(torch.zeros(1, 5, 6, 4), torch.zeros(3, 8, 5))  # 3 CI rows, not 2 CI


# ---- K5: a copy of the probe's Pallas pool -------------------------------

def _pool_kernel(x_ref, o_ref):  # scripts/pool_kernel_probe.py:81-87
    x = x_ref[...]  # (1, 2*TT, F, C)
    _, t2, f, c = x.shape
    g = x.reshape(t2 // 2, 2, f, c)
    o_ref[...] = ((g[:, 0] + g[:, 1]) * jnp.asarray(0.5, x.dtype)).astype(o_ref.dtype)[None]


@functools.partial(jax.jit, static_argnames=("tt",))
def pool_pallas(h, tt=16):  # scripts/pool_kernel_probe.py:89-109
    b, t, f, c = h.shape
    t2 = t - (t % 2)
    h = h[:, :t2]
    to = t2 // 2
    assert to % tt == 0, (to, tt)
    return pl.pallas_call(
        _pool_kernel,
        out_shape=jax.ShapeDtypeStruct((b, to, f, c), h.dtype),
        grid=(b, to // tt),
        in_specs=[pl.BlockSpec((1, 2 * tt, f, c), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, tt, f, c), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
    )(h)


POOL_SHAPES = [((2, 33, 8, 16), 16), ((1, 64, 6, 32), 8), ((3, 17, 4, 8), 8), ((2, 321, 3, 4), 16)]


@pytest.mark.parametrize("shape,tt", POOL_SHAPES[:2])
def test_pallas_pool_copy_is_flax_avg_pool(shape, tt):
    x = jnp.asarray(np.random.default_rng(1).normal(size=shape), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        got = np.asarray(pool_pallas(x, tt=tt).astype(jnp.float32))
    want = np.asarray(nn.avg_pool(x, (2, 1), (2, 1), "VALID").astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,tt", POOL_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_time_pool_plain_matches_pallas_bitwise(shape, tt, dtype):
    """Odd T included: the last row is dropped. Bit-exact: both round the
    sum to the dtype and halve exactly."""
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pool_pallas(jnp.asarray(x, dtype), tt=tt).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = time_pool(xt, tt)
    assert got.dtype == xt.dtype and got.shape == (shape[0], shape[1] // 2, *shape[2:])
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(time_pool_plain(xt).float().numpy(), want)


def test_time_pool_keeps_the_probe_precondition():
    with pytest.raises(ValueError, match="multiple of the tile"):
        time_pool(torch.zeros(1, 34, 2, 2), tt=16)  # T // 2 = 17
    before = _build.launch_counts()
    time_pool(torch.zeros(1, 32, 2, 2))
    assert _build.launch_counts() == before  # CPU: the plain version, no launch


# ---- the pool probe's chain ----------------------------------------------

def _jax_chain(folded, pool):
    """The chain as ``scripts/pool_kernel_probe.py:54-119`` builds it."""
    dt = jnp.bfloat16

    def conv(h, i):
        h = jax.lax.conv_general_dilated(
            h, folded[f"w{i}"].astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
        return jnp.maximum(h + folded[f"b{i}"], 0.0).astype(dt)

    def head(h):
        hm = jnp.mean(h.astype(jnp.float32), axis=1)
        emb = jnp.swapaxes(hm, 1, 2).reshape(hm.shape[0], -1)
        return (emb.astype(dt) @ folded["w_cls"].astype(dt) + folded["b_cls"])[:, 0]

    def chain(x):
        h = pool(conv(x[..., None], 1))
        h = pool(conv(h, 2))
        return head(conv(h, 3))

    return chain


def _pool_dw(h):
    c = h.shape[-1]
    return jax.lax.conv_general_dilated(
        h, jnp.full((2, 1, 1, c), 0.5, jnp.bfloat16), (2, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c,
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)


JAX_POOLS = {"reduce_window": lambda h: nn.avg_pool(h, (2, 1), (2, 1), "VALID"), "depthwise": _pool_dw,
             "pallas": pool_pallas}


@pytest.fixture(scope="module")
def chain_inputs():
    """Flax init with BatchNorm statistics and affine parameters drawn from a
    seed, so the folded biases are not zero (the probe's own are)."""
    model = jbuild("cnn2d")
    variables = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.zeros((1, 321, 180))))
    rng = np.random.default_rng(4)
    for i in (1, 2, 3):
        bn, stats = variables["params"][f"bn{i}"], variables["batch_stats"][f"bn{i}"]
        c = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn["bias"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        stats["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(2, 64, 180)).astype(np.float32)  # T//2, T//4 multiples of 16
    return variables, x


@pytest.mark.parametrize("pool", list(JAX_POOLS))
def test_pool_probe_chain_matches_jax(chain_inputs, pool):
    variables, x = chain_inputs
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_chain(jfast.fold_cnn2d(variables), JAX_POOLS[pool])(jnp.asarray(x, jnp.bfloat16)))
    folded = fold_cnn2d(state_dict_from_jax(variables))
    assert min(folded[f"b{i}"].abs().max().item() for i in (1, 2, 3)) > 0.1
    with torch.inference_mode():
        got = t_pool.make_chain(folded, t_pool.POOLS[pool])(torch.from_numpy(x).to(torch.bfloat16))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)  # two bf16 chains


def test_pool_probe_conv_rounds_once(chain_inputs):
    """The probe's conv adds the f32 bias to the f32 sum and rounds once to
    bf16, as the JAX probe's conv does (``pool_kernel_probe.py:54-60``)."""
    variables, x = chain_inputs
    jfolded = jfast.fold_cnn2d(variables)
    h = np.random.default_rng(5).normal(size=(2, 16, 12, 32)).astype(np.float32)
    hj = jnp.asarray(h, jnp.bfloat16)
    y = jax.lax.conv_general_dilated(hj, jfolded["w2"].astype(jnp.bfloat16), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    want = np.asarray(jnp.maximum(y + jfolded["b2"], 0.0).astype(jnp.bfloat16).astype(jnp.float32))
    folded = fold_cnn2d(state_dict_from_jax(variables))
    got = t_pool.conv(torch.from_numpy(h).to(torch.bfloat16), folded, 2)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    got = got.float().numpy()
    # f32 sums in another order may straddle a bf16 rounding boundary (one
    # last bit, rarely); rounding the sum before the bias moves ~1 in 9 here
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0)
    assert np.mean(got != want) < 1e-3


# ---- the port's entry points on the CPU ----------------------------------

def test_pallas_err_probe_entry_point(capsys):
    sums = t_err.main(["--device", "cpu"])
    *lines, last = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["== g", "== i", "== j", "== k"]
    assert all(re.fullmatch(r"== [gijk]: OK -?\d+\.\d{3}", ln) for ln in lines)
    assert list(sums) == ["g", "i", "j", "k"] and all(np.isfinite(list(sums.values())))
    assert last == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))  # CPU: plain versions


def test_train_opt_probe_stage13_entry_point(capsys, monkeypatch):
    """Stages 11, 12 and 13 at B=8 (one of v3's groups); on the CPU a time
    is a host timing of the plain versions and may come out negative."""
    monkeypatch.setattr(t_opt, "REPS", 1)  # one timed run per length keeps the rehearsal short
    times = t_opt.main(["--stages", "11,12,13", "--batch", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^  cuDNN conv1 fwd \(control\)   : +-?\d+\.\d+ ms$", out, flags=re.M)
    rows = re.findall(r"^  (v[0-4]) .+: +-?\d+\.\d+ ms$", out, flags=re.M)
    assert rows == list(tcp.STAGE11_CASES) and list(times["11"]) == ["control", *tcp.STAGE11_CASES]
    rows = re.findall(r"^  ([acdfghijk]) .+: +-?\d+\.\d+ ms  \( *[-\d.na]+ TF/s\)$", out, flags=re.M)
    assert rows == list("acdfghijk") and list(times["12"]) == list("acdf") and list(times["13"]) == list("ghijk")
    for heading in ("== stage 11: Pallas conv1-pass feasibility (B=8) ==",
                    "== stage 12: conv formulation shoot-out (B=8) ==",
                    "== stage 13: aligned conv formulations (B=8) =="):
        assert heading in out
    assert out.strip().splitlines()[-1] == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))


def test_train_opt_probe_refuses_unported_stages():
    proc = subprocess.run([sys.executable, "-m", "dfac_tpu_torch.scripts.train_opt_probe", "--stages", "4",
                           "--device", "cpu"], capture_output=True, text=True, cwd=str(ROOT))
    assert proc.returncode != 0
    assert "stage 4 is not ported" in proc.stderr and proc.stdout == ""
    assert "stages 1-10, 16, 17 time XLA lowerings of the JAX training step and reach no Pallas kernel" in proc.stderr


def test_pool_kernel_probe_entry_point(capsys):
    result = t_pool.main(["--batch", "4", "--n-corpus", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("depthwise", "pallas"):
        assert re.search(rf"^max \|logit diff\| vs base \({name}\): \d\.\d{{3}}e[-+]\d+$", out, flags=re.M)
        assert result["diff"][name] <= 2e-2
    assert set(result["utt_s"]) == {"reduce_window", "depthwise", "pallas"}
    assert result["pallas_launches"] == 0 and result["pallas_batches"] == 12  # CPU: plain versions
    assert out.strip().splitlines()[-1] == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))
