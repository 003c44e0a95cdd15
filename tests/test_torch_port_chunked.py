"""Stages 14 and 15 of the training probe (kernels 10 and 11) against the JAX stages.

``scripts/train_opt_probe.py``'s ``stage14_conv_chunked`` and
``stage15_conv2_chunks`` run at B=2 with ``bench_slope`` replaced by a
capture of ``(fn(*args), args)`` and ``pl.pallas_call`` by
``functools.partial(pallas_call, interpret=True)``: JAX's generic
interpreter. ``kern_h2`` (``:1251``) and ``kern_c2`` (``:1462``) read past
the edge of their refs; the generic interpreter turns each ``pl.ds`` read
into ``jax.lax.dynamic_slice``, which clamps the start so that the slice
fits, while the TPU interpreter (``pltpu.force_tpu_interpret_mode``, which
the other probe tests use) refuses the read. The clamped read is the
reference the port reproduces; one test pins both interpreters'
behaviour.

Checksum bound: bf16 x bf16 products are exact in f32, so the two sides
differ only by f32 summation order: |port - JAX| <= 1e-5 * sum |y| per
sample, with sum |y| from the plain version in f64.
"""

import contextlib
import functools
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops import conv_probe as tcp
from dfac_tpu_torch.scripts import train_opt_probe as t_opt

ROOT = Path(__file__).resolve().parents[1]
STAGES = {"stage14_conv_chunked": list(tcp.STAGE14_CASES), "stage15_conv2_chunks": list(tcp.STAGE15_CASES)}
CASES = {**tcp.STAGE14_CASES, **tcp.STAGE15_CASES}
LABELS = {**t_opt.STAGE14_LABELS, **t_opt.STAGE15_LABELS}


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


@pytest.fixture(scope="module")
def opt_probe():
    spec = importlib.util.spec_from_file_location("_jax_train_opt_probe_chunked", ROOT / "scripts" / "train_opt_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_stages(mod, tpu_interpreter: bool):
    """Both stages at B=2 -> (stdout, [(Pallas output, (input, w)) of each
    case that ran, in order])."""
    captured = []

    def capture(fn, *args, **_):
        captured.append((np.asarray(fn(*args)), args))
        return 1.0

    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        stack.enter_context(contextlib.redirect_stdout(out))
        mp.setattr(mod, "bench_slope", capture)
        if tpu_interpreter:
            stack.enter_context(pltpu.force_tpu_interpret_mode())
        else:
            mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        for stage in STAGES:
            getattr(mod, stage)(2, jnp.bfloat16)
    return out.getvalue(), captured


@pytest.fixture(scope="module")
def capture(opt_probe):
    """{case: (Pallas output, (input, w))} under the generic interpreter."""
    _, captured = _run_stages(opt_probe, tpu_interpreter=False)
    assert len(captured) == len(CASES)
    return dict(zip(CASES, captured))


@pytest.mark.parametrize("name", list(CASES))
def test_k10_k11_checksums_match_pallas(capture, name):
    """h2 and c2 included: their Pallas reads are clamped (see the formula tests)."""
    want, (inp, w) = capture[name]
    x, wt = _to_torch(inp), _to_torch(w)
    case = CASES[name]
    got = case.kernel(x, wt).numpy()
    y = case.plain(x, wt).double()
    bound = 1e-5 * y.abs().sum(dim=tuple(range(1, y.dim()))).numpy()
    assert got.shape == want.shape == (2, 8, 128)
    assert (got == got[:, :1, :1]).all() and (want == want[:, :1, :1]).all()
    assert (np.abs(got[:, 0, 0] - want[:, 0, 0]) <= bound).all(), (got[:, 0, 0], want[:, 0, 0], bound)


def _case_lines(out: str) -> dict:
    """{case: the text of its line, with any error message after it}."""
    parts = re.split(r"^  (?=\w\d \w)", out, flags=re.M)
    return {p.split()[0]: p for p in parts[1:]}


def test_tpu_interpreter_refuses_only_the_reads_past_the_edge(opt_probe, capture):
    """Under ``force_tpu_interpret_mode`` h2 and c2 fail with an
    out-of-bounds read and no other case fails; the others give the generic
    interpreter's outputs bit for bit. On the clamped reads, what
    zero-filling would give lies outside the bound of the generic interpreter's checksums."""
    out, captured = _run_stages(opt_probe, tpu_interpreter=True)
    lines = _case_lines(out)
    assert list(lines) == list(CASES)
    failed = [name for name, text in lines.items() if "FAILED" in text]
    assert failed == ["h2", "c2"]
    assert all("Out-of-bounds read" in lines[name] for name in failed)
    ran = [name for name in CASES if name not in failed]
    assert len(captured) == len(ran)
    for name, (got, _) in zip(ran, captured):
        np.testing.assert_array_equal(got, capture[name][0])
    for name, zero_filled in (("h2", _h2_zero_filled), ("c2", _c2_zero_filled)):
        want, (inp, w) = capture[name]
        y = zero_filled(_to_torch(inp).double().numpy(), _to_torch(w).double().numpy())
        sums = y.reshape(y.shape[0], -1).sum(axis=1)
        bound = 1e-5 * np.abs(y).reshape(y.shape[0], -1).sum(axis=1)
        assert (np.abs(sums - want[:, 0, 0]) > bound).all(), (name, sums, want[:, 0, 0])


# ---- the formulas, at a tiny size -----------------------------------------

def _conv_valid(x: np.ndarray, w: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """x (B, T, F, CI), w (9, CI, CO) -> sum_k x[t+dy, f+dx] w[k], t < rows, f < cols, in f64."""
    y = np.zeros((x.shape[0], rows, cols, w.shape[-1]))
    for k in range(9):
        dy, dx = divmod(k, 3)
        y += x[:, dy : dy + rows, dx : dx + cols] @ w[k]
    return y


def _h2_windows(x: np.ndarray, w9: np.ndarray, start) -> np.ndarray:
    """h2's y with window i read from input column start(i)."""
    width = tcp.H2_WINDOW
    return np.concatenate([_conv_valid(x[:, :, start(i) : start(i) + width + 2, None], w9[:, None], tcp.CONV1_ROWS,
                                       width) for i in range(tcp.H2_WINDOWS)], axis=2)


def _h2_direct(x: np.ndarray, w9: np.ndarray) -> np.ndarray:
    """Each window sliced by ``jax.lax.dynamic_slice`` itself (``pl.ds(i W, W + 2)``)."""
    width = tcp.H2_WINDOW
    windows = [np.asarray(jax.lax.dynamic_slice(jnp.asarray(x), (0, 0, i * width), (x.shape[0], x.shape[1], width + 2)),
                          np.float64) for i in range(tcp.H2_WINDOWS)]
    return np.concatenate([_conv_valid(win[..., None], w9[:, None], tcp.CONV1_ROWS, width) for win in windows], axis=2)


def _h2_zero_filled(x: np.ndarray, w9: np.ndarray) -> np.ndarray:
    """What a read past the edge returning zeros would give."""
    xz = np.pad(x, ((0, 0), (0, 0), (0, tcp.H2_WINDOWS * tcp.H2_WINDOW + 2)))
    return _h2_windows(xz, w9, lambda i: i * tcp.H2_WINDOW)


def _c2_taps(row: np.ndarray, start) -> np.ndarray:
    """(B, CHUNKS CHUNK_LEN, 16) taps: tap k of chunk c from ``start(c, o_k)``, taps 9-15 zero."""
    mc, width = tcp.CHUNK_LEN, tcp.FLAT_WIDTH
    chunks = []
    for c in range(tcp.CHUNKS):
        taps = [start(c, dy * width + dx) for dy in range(3) for dx in range(3)]
        chunks.append(np.stack(taps + [np.zeros_like(taps[0])] * 7, axis=-1))
    return np.concatenate(chunks, axis=1)


def _c2_direct(xf: np.ndarray, wt: np.ndarray) -> np.ndarray:
    """Each tap sliced by ``jax.lax.dynamic_slice`` itself (``pl.ds(c Mc + o, Mc)``)."""
    row, mc = jnp.asarray(xf[:, 0]), tcp.CHUNK_LEN
    taps = _c2_taps(row, lambda c, o: np.asarray(jax.lax.dynamic_slice(row, (0, c * mc + o), (row.shape[0], mc)),
                                                 np.float64))
    return taps @ wt.T


def _c2_zero_filled(xf: np.ndarray, wt: np.ndarray) -> np.ndarray:
    mc = tcp.CHUNK_LEN
    row = np.pad(xf[:, 0], ((0, 0), (0, tcp.CHUNKS * mc + 3 * tcp.FLAT_WIDTH)))
    return _c2_taps(row, lambda c, o: row[:, c * mc + o : c * mc + o + mc]) @ wt.T


FORMULAS = {  # case -> (module constants, input shape, weight shape, y in f64 from the docstring's formula)
    "h2": ({"CONV1_ROWS": 5, "H2_WINDOW": 4}, (2, 8, 9), (9, 3), _h2_direct),  # window 1 clamped to 9 - 6 = 3
    "i2": ({"CONV1_ROWS": 5}, (2, 9, 7, 6), (9, 3),
           lambda p, w: np.einsum("bktf,kc->btfc", p[:, :, : tcp.CONV1_ROWS], w)),
    "j4": ({"CONV2_ROWS": 5, "CONV2_SLICE_COLS": 6}, (2, 8, 10, 4), (3, 12, 5),
           lambda h, w: _conv_valid(h, w.reshape(3, 3, 4, 5).transpose(1, 0, 2, 3).reshape(9, 4, 5), 5, 6)),
    "j5": ({"CONV3_ROWS": 5, "CONV3_COLS": 6}, (2, 8, 10, 4), (9, 4, 5), lambda h, w: _conv_valid(h, w, 5, 6)),
    # L - Mc = 28: chunk 2's taps 24 + {5, 6, 7, 10, 11, 12} clamp to 28, chunk 3's all
    "c2": ({"FLAT_WIDTH": 5, "CHUNK_LEN": 12, "CHUNKS": 4}, (2, 2, 40), (3, 16), _c2_direct),
}
KERNELS = {"h2": tcp.chunked_taps_checksum, "i2": tcp.tap_planes_checksum, "j4": tcp.conv2_dx_window_checksum,
           "j5": tcp.conv3_checksum, "c2": tcp.flat_chunks_checksum}


@pytest.mark.parametrize("name", list(FORMULAS))
def test_chunked_plain_versions_follow_the_formulas(name, monkeypatch):
    """Every y of the plain versions, through the CPU wrappers, with the
    module's windows shrunk; h2's and c2's reads past the edge clamped as
    ``jax.lax.dynamic_slice`` clamps them, which zero-filling would not give."""
    consts, s_in, s_w, direct = FORMULAS[name]
    for const, value in consts.items():
        monkeypatch.setattr(tcp, const, value)
    rng = np.random.default_rng(ord(name[0]) + ord(name[1]))
    x = torch.from_numpy(rng.normal(size=s_in).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=s_w).astype(np.float32)).to(torch.bfloat16)
    xd, wd = x.double().numpy(), w.double().numpy()
    want = direct(xd, wd)
    out, y = KERNELS[name](x, w, return_y=True)
    assert y.shape == want.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=1e-5)  # f32 sums of <= 36 exact products
    sums = y.double().sum(dim=tuple(range(1, y.dim()))).numpy()
    assert out.shape == (2, 8, 128)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(sums[:, None, None], out.shape), rtol=1e-6)
    if name in ("h2", "c2"):
        zero_filled = {"h2": _h2_zero_filled, "c2": _c2_zero_filled}[name](xd, wd)
        assert zero_filled.shape == want.shape and not np.allclose(zero_filled, want, atol=1e-3)


def test_window_starts_are_clamped():
    """At the stages' widths: h2's second window from Fp - 130 = 126; c2's
    chunks 0-6 unclamped (largest start 49,518), chunk 7's nine taps from L -
    Mc = 50,816."""
    assert tcp.h2_col_starts(256) == [0, 126]
    starts = tcp.chunk_starts(t_opt.XF_LEN)
    assert t_opt.XF_LEN == 59008 and len(starts) == 8
    assert starts[6][-1] == 6 * 8192 + 2 * 182 + 2 == 49518
    assert all(s == c * 8192 + o for c in range(7) for s, o in zip(starts[c], starts[0]))
    assert starts[7] == [59008 - 8192] * 9


# ---- the cases that compute another case's function ------------------------

def test_j2_and_j3_are_stage13_j(capture):
    """The JAX stages draw j2's and j3's arrays from the same keys; on them
    the port's j2, j3 and stage 13's j agree bit for bit, and the two Pallas
    checksums differ by summation order only."""
    (want2, (h2_in, w2_in)), (want3, (h3_in, w3_in)) = capture["j2"], capture["j3"]
    np.testing.assert_array_equal(np.asarray(h2_in), np.asarray(h3_in))
    np.testing.assert_array_equal(np.asarray(w2_in), np.asarray(w3_in))
    h, w = _to_torch(h2_in), _to_torch(w2_in)
    j = tcp.CASES["j"].kernel(h, w)
    assert torch.equal(tcp.STAGE14_CASES["j2"].kernel(h, w), j) and torch.equal(tcp.STAGE15_CASES["j3"].kernel(h, w), j)
    y = tcp.CASES["j"].plain(h, w).double()
    bound = 1e-5 * y.abs().sum(dim=(1, 2, 3)).numpy()
    assert (np.abs(want2[:, 0, 0] - want3[:, 0, 0]) <= bound).all()


def test_j4_is_f_on_the_window():
    """j4's plain version is stage 12's f (``conv2_dx_plain``) on h1 cut to
    (CONV2_ROWS + 2, CONV2_SLICE_COLS + 2)."""
    gen = torch.Generator().manual_seed(4)
    h1 = torch.randn(2, 176, 192, 32, generator=gen).to(torch.bfloat16)
    w2i = (0.1 * torch.randn(3, 96, 64, generator=gen)).to(torch.bfloat16)
    want = tcp.conv2_dx_plain(h1[:, : tcp.CONV2_ROWS + 2, : tcp.CONV2_SLICE_COLS + 2], w2i)
    got = tcp.conv2_dx_window_plain(h1, w2i)
    assert got.shape == (2, 160, 176, 64) and torch.equal(got, want)


def test_chunked_wrappers_reject_bad_arguments(monkeypatch):
    x, w9 = torch.zeros(1, 12, 16, dtype=torch.bfloat16), torch.zeros(9, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="outside"):
        tcp.chunked_taps_checksum(x, w9)  # 322 rows of taps in 12
    with pytest.raises(ValueError, match="p9"):
        tcp.tap_planes_checksum(torch.zeros(1, 8, 320, 4), w9)
    with pytest.raises(ValueError, match="w2i"):
        tcp.conv2_dx_window_checksum(torch.zeros(1, 176, 192, 4), torch.zeros(3, 8, 5))
    with pytest.raises(ValueError, match="w3"):
        tcp.conv3_checksum(torch.zeros(1, 96, 192, 4), torch.zeros(9, 3, 5))
    with pytest.raises(ValueError, match="wt"):
        tcp.flat_chunks_checksum(torch.zeros(1, 2, 9000), torch.zeros(32, 9))
    monkeypatch.setattr(tcp, "CHUNK_LEN", 100)
    with pytest.raises(ValueError, match="does not fit"):
        tcp.flat_chunks_checksum(torch.zeros(1, 2, 99), torch.zeros(32, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        tcp.conv3_checksum(torch.zeros(1, 96, 192, 4, device="meta"), torch.zeros(9, 4, 5, device="meta"))


# ---- the entry point on the CPU -------------------------------------------

def test_train_opt_probe_stages_14_15_entry_point(capsys, monkeypatch):
    """On the CPU a time is a host timing of the plain versions and may come out negative."""
    monkeypatch.setattr(t_opt, "REPS", 1)
    monkeypatch.setattr(t_opt, "ITERS", (1, 2))
    times = t_opt.main(["--stages", "14,15", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for heading in ("== stage 14: chunked conv formulations (B=2) ==",
                    "== stage 15: conv2/conv3 chunked trailing dots (B=2) =="):
        assert heading in out
    rows = re.findall(r"^  (\w\d) .+: +-?\d+\.\d+ ms  \( *[-\d.na]+ TF/s\)$", out, flags=re.M)
    assert rows == list(CASES) and list(times["14"]) == list(tcp.STAGE14_CASES)
    assert list(times["15"]) == list(tcp.STAGE15_CASES)
    for name in CASES:
        assert f"  {LABELS[name]:28s}: " in out
    assert out.strip().splitlines()[-1] == "kernel launches: " + json.dumps(dict.fromkeys(_build.LAUNCHES, 0))
    assert t_opt.calls_per_case() == 1 + (2 + 1) + (2 + 2)
