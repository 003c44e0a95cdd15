"""The port's probe kernels (5, 6, 9) against the JAX probes' own Pallas kernels.

On CPU tensors the port's wrappers run their plain versions; every JAX call
runs under ``pltpu.force_tpu_interpret_mode()``. Arrays cross over as numpy.

* K6: ``scripts/pallas_err_probe.py`` is imported with ``sys.argv`` cleared
  (it runs all four cases at import), then each case runs once more through
  its ``run``.
* K9: ``scripts/train_opt_probe.py``'s ``stage13_conv_aligned`` runs with
  ``bench_slope`` replaced by a capture of ``(fn(*args), args)``.
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


def _check_checksums(name: str, inp, w, want: np.ndarray) -> None:
    """The port's case ``name`` on JAX arrays against the Pallas output."""
    case = tcp.CASES[name]
    x, wt = _to_torch(inp), _to_torch(w)
    got = case.kernel(x, wt).numpy()
    bound = 1e-5 * case.plain(x, wt).double().abs().sum(dim=(1, 2, 3)).numpy()
    assert got.shape == want.shape == (x.shape[0], 8, 128)
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
    _check_checksums(name, arr, warr, want)


@pytest.fixture(scope="module")
def stage13_capture():
    """Stage 13 at B=2 in interpret mode: {case: (Pallas output, (input, w))}."""
    mod = _import_script("train_opt_probe")
    captured = []

    def capture(fn, *args, **_):
        captured.append((np.asarray(fn(*args)), args))
        return 1.0

    mod.bench_slope = capture
    with pltpu.force_tpu_interpret_mode():
        mod.stage13_conv_aligned(2, jnp.bfloat16)
    return dict(zip("ghijk", captured))


@pytest.mark.parametrize("name", ["g", "h", "i", "j", "k"])
def test_k9_stage13_checksums_match_pallas(stage13_capture, name):
    want, (inp, w) = stage13_capture[name]
    _check_checksums(name, inp, w, want)


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


def test_train_opt_probe_stage13_entry_point(capsys):
    times = t_opt.main(["--stages", "13", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    rows = re.findall(r"^  ([ghijk]) .+: +\d+\.\d+ ms  \( *[-\d.na]+ TF/s\)$", out, flags=re.M)
    assert rows == list("ghijk") and list(times["13"]) == list("ghijk")
    assert "== stage 13: aligned conv formulations (B=2) ==" in out
    assert out.strip().splitlines()[-1] == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))


def test_train_opt_probe_refuses_unported_stages():
    proc = subprocess.run([sys.executable, "-m", "dfac_tpu_torch.scripts.train_opt_probe", "--stages", "4",
                           "--device", "cpu"], capture_output=True, text=True, cwd=str(ROOT))
    assert proc.returncode != 0
    assert "stage 4 not yet ported" in proc.stderr and proc.stdout == ""


def test_pool_kernel_probe_entry_point(capsys):
    result = t_pool.main(["--batch", "4", "--n-corpus", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("depthwise", "pallas"):
        assert re.search(rf"^max \|logit diff\| vs base \({name}\): \d\.\d{{3}}e[-+]\d+$", out, flags=re.M)
        assert result["diff"][name] <= 2e-2
    assert set(result["utt_s"]) == {"reduce_window", "depthwise", "pallas"}
    assert result["pallas_launches"] == 0 and result["pallas_batches"] == 12  # CPU: plain versions
    assert out.strip().splitlines()[-1] == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))
