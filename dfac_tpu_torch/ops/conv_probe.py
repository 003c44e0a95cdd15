"""Conv-formulation probe kernels 6 to 11 and their plain versions.

Counterpart of the Pallas kernels of ``scripts/pallas_err_probe.py``
(``kern_g/i/j/k``, K6) and of stages 11 to 15 of
``scripts/train_opt_probe.py`` (K7 ``kern_v0..v4``, K8 ``kern_a/c/d/f``,
K9 ``kern_g/h/i/j/k``, K10 ``kern_h2/i2/j2``, K11 ``make_convk``,
``make_conv_inter`` and ``kern_c2``). Each checksum case forms every output ``y`` of a
conv in f32 from bf16 operands and returns the per-sample sum, broadcast to
``(B, 8, 128)`` f32 as the Pallas kernels write it:

====  ============================================  ======================================================
case  function                                      y[b, t, f, co]
====  ============================================  ======================================================
g     ``conv1_taps_checksum(mode="roll")``          sum_k x[t+dy, (f+dx-1) mod Fp] w9[k, co], f < Fp
h     ``conv1_taps_checksum(mode="slice")``         sum_k x[t+dy, f+dx] w9[k, co], f < CONV1_SLICE_COLS
i     ``patches_checksum``                          sum_k p[t, f, k] w9[k, co]
j     ``conv2_checksum(mode="slice")``              sum_{k,ci} h[t+dy, f+dx, ci] w2[k, ci, co], f < CONV2_SLICE_COLS
k     ``conv2_checksum(mode="roll")``               as j with the column (f+dx-1) mod F2p, f < F2p
v0    ``sum_sq_checksum``                           no conv: the sum is sum x + sum x^2
v1    ``conv1_same_checksum(unit="fma")``           sum_k xp[t+dy, f+dx] w[dy, dx, co], t < T, f < F (xp: x
                                                    zero-padded by one on each side, SAME)
v2    ``conv1_same_checksum(unit="mma")``           as v1
v3    ``conv1_group_checksum``                      as v1, summed over each group of 8 samples: (B // 8, 8, 128)
v4    ``conv1_emit``                                not a checksum: v1's y -> y 1.01 + 0.01 -> ReLU -> mean of
                                                    rows 2t, 2t+1, t < T // 2 -> (B, T // 2, F, CO) in x's dtype
a     ``conv1_valid_checksum(unit="mma")``          sum_k x[t+dy, f+dx] w9[k, co], t < T-2, f < F-2 (VALID)
c     ``flat_shift_checksum``                       y[b, m, co] = sum_k xf[min(dy W + dx, 2W) + m] w9[k, co],
                                                    m < Np - 2W, on the flat padded sample xf (W = F + 2)
d     ``conv1_valid_checksum(unit="fma")``          as a
f     ``conv2_dx_checksum``                         conv2 of h1 (B, T2+2, F+2, CI) with w2[3dy+dx, ci] =
                                                    w2dx[dx, CI dy + ci], t < T2, f < F
h2    ``chunked_taps_checksum``                     sum_k x[t+dy, s_i + j + dx] w9[k, co] at f = i H2_WINDOW + j,
                                                    j < H2_WINDOW, i < H2_WINDOWS, s_i = ``h2_col_starts(Fp)[i]``
i2    ``tap_planes_checksum``                       sum_k p9[k, t, f] w9[k, co], f < Fp (tap-leading patches)
j2    ``conv2_checksum(mode="slice")``              j's y
j3    ``conv2_checksum(mode="slice")``              j's y
j4    ``conv2_dx_window_checksum``                  f's y on h1 (B, T2p, F2p, CI), f < CONV2_SLICE_COLS
j5    ``conv3_checksum``                            sum_{k,ci} h2[t+dy, f+dx, ci] w3[k, ci, co], t < CONV3_ROWS,
                                                    f < CONV3_COLS
c2    ``flat_chunks_checksum``                      y[b, m, co] = sum_{k<16} wt[co, k] tap_k[m], m < CHUNKS CHUNK_LEN:
                                                    tap_k[m] = xf[b, 0, ``chunk_starts(L)[c][k]`` + m - c CHUNK_LEN]
                                                    for k < 9 (c = m // CHUNK_LEN), 0 for k >= 9
====  ============================================  ======================================================

with ``k = 3 dy + dx`` and, for g-k and i2-j5, ``t < CONV1_ROWS`` (conv1)
or ``CONV2_ROWS`` (conv2): stage 13's aligned windows, module constants
(the tests shrink them). ``pltpu.roll`` is ``np.roll``, so the roll taps
wrap around the padded width. ``jax.lax.dynamic_slice`` clamps a start so
that the slice fits, and so does JAX's interpreter for a ``pl.ds`` read
past the edge of a ref: c's taps 7 and 8 (offsets 2W + 1, 2W + 2) read
tap 6's window (2W), h2's second window starts at Fp - 130, not 128, and
c2's last chunk reads from L - CHUNK_LEN for every tap. That is the
reference's result, and the port's. ``unit`` picks the hardware: f32
FMAs on the CUDA cores (``"fma"``) or ``wgmma`` on the tensor cores with
K = 9 padded to 16 (``"mma"``). v4's kernel forms both conv rows of a
pooled pixel as one tensor-core product through ``ops/conv_block.py``'s
``CIN1_TC_K`` and ``CIN1_TC_N`` maps, as K2's block 1 does.

On a CUDA tensor each function launches ``csrc/conv_probe.cu`` (bf16 only)
or raises; on a CPU tensor it runs the plain version. A launch counts under
its stage's key of ``_build.LAUNCHES`` (j2 and j3 under stage 14's and 15's,
though they run j's kernel). The plain versions
(``*_plain``) return ``y`` itself, in f32 (v0: ``(x, x^2)``; v3: grouped,
``(B // 8, 8 T, F, CO)``; v4: the emitted tensor); :func:`checksum` turns
y into the ``(B, 8, 128)`` result. They run f32 products through
``conv2d`` and ``matmul`` with TF32 off, so they are a reference on the
card too.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build

CONV1_ROWS, CONV1_SLICE_COLS = 320, 128  # stage 13's Tv and kern_h's window
CONV2_ROWS, CONV2_SLICE_COLS = 160, 176  # stage 13's T2 and kern_j's window
CONV2_CHANNELS = (32, 64)                 # the CUDA kernel's C_in -> C_out

_CASE_ID = {("conv1", "roll"): 0, ("conv1", "slice"): 1, ("patches", None): 2,
            ("conv2", "slice"): 3, ("conv2", "roll"): 4}


@contextlib.contextmanager
def no_tf32():
    """Full f32 products in cuDNN convs and matmuls (a reference on the card)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def checksum(y: torch.Tensor) -> torch.Tensor:
    """(B, ...) outputs -> (B, 8, 128) f32, every entry the sample's f32 sum."""
    s = y.float().sum(dim=tuple(range(1, y.dim())))
    return s[:, None, None].expand(-1, 8, 128).contiguous()


def _check_mode(mode: str) -> None:
    if mode not in ("roll", "slice"):
        raise ValueError(f"mode must be 'roll' or 'slice', got {mode!r}")


@no_tf32()
def _taps_conv_plain(inp: torch.Tensor, w: torch.Tensor, mode: str, rows: int, cols: int) -> torch.Tensor:
    """inp (B, T, F, CI), w (9, CI, CO) -> y (B, rows, cols, CO), f32."""
    _check_mode(mode)
    x = inp.float()
    if mode == "roll":  # column (f + dx - 1) mod F, f < F
        x = torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)
        cols = inp.shape[2]
    x = x[:, : rows + 2, : cols + 2]
    wk = w.float().reshape(3, 3, w.shape[-2], w.shape[-1]).permute(3, 2, 0, 1)  # OIHW
    return F.conv2d(x.permute(0, 3, 1, 2), wk).permute(0, 2, 3, 1)


def conv1_taps_plain(x, w9, mode="roll") -> torch.Tensor:
    """x (B, Tp, Fp), w9 (9, CO) -> y (B, CONV1_ROWS, Fp or CONV1_SLICE_COLS, CO)."""
    return _taps_conv_plain(x[..., None], w9[:, None, :], mode, CONV1_ROWS, CONV1_SLICE_COLS)


@no_tf32()
def patches_plain(p: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """p (B, rows, cols, 9), w9 (9, CO) -> y (B, rows, cols, CO)."""
    return p.float() @ w9.float()


def conv2_plain(h, w2, mode="slice") -> torch.Tensor:
    """h (B, T2p, F2p, CI), w2 (9, CI, CO) -> y (B, CONV2_ROWS, CONV2_SLICE_COLS or F2p, CO)."""
    return _taps_conv_plain(h, w2, mode, CONV2_ROWS, CONV2_SLICE_COLS)


def _kernel_operands(inp, w):
    """bf16, contiguous, on one device, 16-byte aligned (the kernels stage
    rows and weights with 16-byte loads)."""
    if inp.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the conv-probe kernel takes bfloat16 inputs and weights, got {inp.dtype}, {w.dtype}")
    if w.device != inp.device:
        raise ValueError("inputs and weights must lie on one device")
    inp, w = inp.contiguous(), w.contiguous()
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in (inp, w))


def _launch(kind, mode, inp, w, rows, cols, n_out, return_y, key="conv_probe"):
    batch, t_in, f_in = inp.shape[:3]
    inp, w = _kernel_operands(inp, w)
    out = torch.empty((batch, 8, 128), device=inp.device, dtype=torch.float32)
    y = torch.empty((batch, rows, cols, n_out), device=inp.device, dtype=torch.float32) if return_y else None
    if batch == 0:
        return (out, y) if return_y else out
    done = torch.zeros(batch, device=inp.device, dtype=torch.int32)  # finished blocks per sample
    lib = _build.library()
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    with torch.cuda.device(inp.device):
        err = lib.dfac_conv_probe(_CASE_ID[kind, mode], inp.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  y.data_ptr() if return_y else None, done.data_ptr(), batch, t_in, f_in, rows,
                                  cols, n_out, stream)
    _build.check(err, f"conv_probe {kind}/{mode} launch")
    _build.LAUNCHES[key] += 1
    return (out, y) if return_y else out


def _dispatch(inp, kernel, plain, return_y, reduce=checksum):
    if inp.is_cuda:
        return kernel()
    if inp.device.type != "cpu":
        raise ValueError(f"unsupported device {inp.device}")
    y = plain()
    return (reduce(y), y) if return_y else reduce(y)


def conv1_taps_checksum(x, w9, mode="roll", return_y=False):
    """Cases g (``mode="roll"``, every column) and h (``"slice"``, the first
    CONV1_SLICE_COLS): x (B, Tp, Fp), w9 (9, CO) -> (B, 8, 128) f32, and y if asked."""
    if x.dim() != 3 or w9.dim() != 2 or w9.shape[0] != 9:
        raise ValueError(f"want x (B, Tp, Fp) and w9 (9, CO); got {tuple(x.shape)}, {tuple(w9.shape)}")
    _check_mode(mode)
    rows, cols = CONV1_ROWS, CONV1_SLICE_COLS
    if rows + 2 > x.shape[1] or (mode == "slice" and cols + 2 > x.shape[2]):
        raise ValueError(f"rows={rows}, cols={cols} need taps outside x {tuple(x.shape)}")
    width = x.shape[2] if mode == "roll" else cols
    return _dispatch(x, lambda: _launch("conv1", mode, x, w9, rows, width, w9.shape[1], return_y),
                     lambda: conv1_taps_plain(x, w9, mode), return_y)


def patches_checksum(p, w9, return_y=False):
    """Case i: p (B, rows, cols, 9), w9 (9, CO) -> (B, 8, 128) f32, and y if asked."""
    if p.dim() != 4 or p.shape[-1] != 9 or w9.dim() != 2 or w9.shape[0] != 9:
        raise ValueError(f"want p (B, T, F, 9) and w9 (9, CO); got {tuple(p.shape)}, {tuple(w9.shape)}")
    _, rows, cols, _ = p.shape
    return _dispatch(p, lambda: _launch("patches", None, p, w9, rows, cols, w9.shape[1], return_y),
                     lambda: patches_plain(p, w9), return_y)


def conv2_checksum(h, w2, mode="slice", return_y=False, key="conv_probe"):
    """Cases j (``mode="slice"``, the first CONV2_SLICE_COLS columns) and k
    (``"roll"``, every column): h (B, T2p, F2p, CI), w2 (9, CI, CO) ->
    (B, 8, 128) f32, and y if asked. The CUDA kernel takes CI=32, CO=64; its
    launch counts under ``key``."""
    if h.dim() != 4 or w2.dim() != 3 or w2.shape[:2] != (9, h.shape[-1]):
        raise ValueError(f"want h (B, T, F, CI) and w2 (9, CI, CO); got {tuple(h.shape)}, {tuple(w2.shape)}")
    _check_mode(mode)
    rows, cols = CONV2_ROWS, CONV2_SLICE_COLS
    if rows + 2 > h.shape[1] or (mode == "slice" and cols + 2 > h.shape[2]):
        raise ValueError(f"rows={rows}, cols={cols} need taps outside h {tuple(h.shape)}")
    if h.is_cuda and tuple(w2.shape[1:]) != CONV2_CHANNELS:
        raise ValueError(f"the conv2 kernel takes {CONV2_CHANNELS[0]} -> {CONV2_CHANNELS[1]} channels, "
                         f"got w2 {tuple(w2.shape)}")
    width = h.shape[2] if mode == "roll" else cols
    return _dispatch(h, lambda: _launch("conv2", mode, h, w2, rows, width, w2.shape[2], return_y, key),
                     lambda: conv2_plain(h, w2, mode), return_y)


class Case(NamedTuple):
    kernel: Callable  # f(input, weights) -> (B, 8, 128) f32
    plain: Callable   # f(input, weights) -> y, f32
    inp: str          # the probes' input array (train_opt_probe.stage1N_inputs): x, patches, h1, xpad_flat, p9, h2arr, xf
    weights: str      # and its weights: w9, w2, w, w2dx, w2i, w3 or wt


# The probes' five cases, in stage 13's order.
CASES = {
    "g": Case(lambda x, w: conv1_taps_checksum(x, w, "roll"), lambda x, w: conv1_taps_plain(x, w, "roll"), "x", "w9"),
    "h": Case(lambda x, w: conv1_taps_checksum(x, w, "slice"), lambda x, w: conv1_taps_plain(x, w, "slice"),
              "x", "w9"),
    "i": Case(patches_checksum, patches_plain, "patches", "w9"),
    "j": Case(lambda h, w: conv2_checksum(h, w, "slice"), lambda h, w: conv2_plain(h, w, "slice"), "h1", "w2"),
    "k": Case(lambda h, w: conv2_checksum(h, w, "roll"), lambda h, w: conv2_plain(h, w, "roll"), "h1", "w2"),
}


# ---- stages 11 and 12 (kernels 7 and 8) -----------------------------------

FLAT_WIDTH = 182              # c's row width W = F + 2 at stage 12's F = 180
EMIT_AFFINE = (1.01, 0.01)    # kern_v4's y * 1.01 + 0.01
CONV1_CHANNELS = 32           # every conv1 kernel's C_out (kern_v1's): v1-v4, a, c, d, and stages 13-15's
GROUP = 8                     # kern_v3's samples per grid step

_PASS_ID = {"v0": 0, "v1": 1, "v2": 2, "v3": 3, "v4": 4, "a": 5, "c": 6, "d": 7, "f": 8}
_UNITS = {"fma": ("v1", "d"), "mma": ("v2", "a")}  # unit -> (SAME case, VALID case)


def sum_sq_plain(x) -> torch.Tensor:
    """v0: x (B, T, F) -> y (B, T, F, 2) = (x, x^2) in f32, so that
    :func:`checksum` gives sum x + sum x^2."""
    xf = x.float()
    return torch.stack((xf, xf * xf), dim=-1)


@no_tf32()
def conv1_same_plain(x, w) -> torch.Tensor:
    """v1/v2: x (B, T, F), w (3, 3, CO) -> y (B, T, F, CO), SAME zero padding."""
    wk = w.float().reshape(3, 3, -1).permute(2, 0, 1)[:, None]  # OIHW
    return F.conv2d(x.float()[:, None], wk, padding=1).permute(0, 2, 3, 1)


def conv1_group_plain(x, w) -> torch.Tensor:
    """v3: y of the first ``GROUP * (B // GROUP)`` samples as (B // GROUP,
    GROUP * T, F, CO): one row of the result per group."""
    n = x.shape[0] // GROUP
    y = conv1_same_plain(x[: n * GROUP], w)
    return y.reshape(n, GROUP * x.shape[1], *y.shape[2:])


def conv1_emit_plain(x, w) -> torch.Tensor:
    """v4: x (B, T, F), w (3, 3, CO) -> (B, T // 2, F, CO) in x's dtype."""
    scale, shift = EMIT_AFFINE
    a = torch.clamp_min(conv1_same_plain(x, w) * scale + shift, 0.0)
    tp = x.shape[1] // 2  # floor mode: an odd T's last row is dropped
    return (0.5 * (a[:, 0 : 2 * tp : 2] + a[:, 1 : 2 * tp : 2])).to(x.dtype)


def conv1_valid_plain(x, w9) -> torch.Tensor:
    """a/d: x (B, T, F), w9 (9, CO) -> y (B, T - 2, F - 2, CO)."""
    return _taps_conv_plain(x[..., None], w9[:, None, :], "slice", x.shape[1] - 2, x.shape[2] - 2)


def flat_offsets() -> list[int]:
    """c's tap offsets dy W + dx (W = FLAT_WIDTH), clamped at Np - M = 2W as
    ``jax.lax.dynamic_slice`` clamps the start of an M-long slice."""
    width = FLAT_WIDTH
    return [min(dy * width + dx, 2 * width) for dy in range(3) for dx in range(3)]


@no_tf32()
def flat_shift_plain(xf, w9) -> torch.Tensor:
    """c: xf (B, 1, Np), w9 (9, CO) -> y (B, M, CO), M = Np - 2 FLAT_WIDTH."""
    m = xf.shape[-1] - 2 * FLAT_WIDTH
    x = xf[:, 0].float()
    return torch.stack([x[:, o : o + m] for o in flat_offsets()], dim=-1) @ w9.float()


def conv2_dx_weights(w2dx) -> torch.Tensor:
    """w2dx (3, 3 CI, CO) -> w2 (9, CI, CO), w2[3 dy + dx, ci] = w2dx[dx, CI dy + ci]."""
    ci = w2dx.shape[1] // 3
    return w2dx.reshape(3, 3, ci, -1).transpose(0, 1).reshape(9, ci, -1)


def conv2_dx_plain(h1, w2dx) -> torch.Tensor:
    """f: h1 (B, T2 + 2, F + 2, CI), w2dx (3, 3 CI, CO) -> y (B, T2, F, CO)."""
    return _taps_conv_plain(h1, conv2_dx_weights(w2dx), "slice", h1.shape[1] - 2, h1.shape[2] - 2)


def _pass_launch(case, inp, w, out, y_shape, return_y, t_in, f_in, n_out, group=1):
    """One launch of ``dfac_conv_pass`` into ``out``: (results, 8, 128) f32,
    or v4's emitted tensor."""
    inp, w = _kernel_operands(inp, inp if w is None else w)  # v0 reads no weights
    y = torch.empty(y_shape, device=inp.device, dtype=torch.float32) if return_y else None
    if out.numel() == 0:  # no result block: the Pallas grid is empty too
        return (out, y) if return_y else out
    done = torch.zeros(out.shape[0], device=inp.device, dtype=torch.int32) if case != "v4" else None
    lib = _build.library()
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    with torch.cuda.device(inp.device):
        err = lib.dfac_conv_pass(_PASS_ID[case], inp.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 y.data_ptr() if return_y else None, None if done is None else done.data_ptr(),
                                 out.shape[0], t_in, f_in, n_out, group, stream)
    _build.check(err, f"conv_pass {case} launch")
    _build.LAUNCHES["conv1_pass" if case.startswith("v") else "conv_forms"] += 1
    return (out, y) if return_y else out


def _sums(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((n, 8, 128), device=like.device, dtype=torch.float32)


def _check_conv1(x, w, lead: tuple) -> None:
    """x (B, T, F) and w (*lead, CO)."""
    if x.dim() != 3 or tuple(w.shape[:-1]) != lead:
        raise ValueError(f"want x (B, T, F) and w {lead + ('CO',)}; got {tuple(x.shape)}, {tuple(w.shape)}")


def _check_unit(unit: str, x, w) -> None:
    if unit not in _UNITS:
        raise ValueError(f"unit must be 'fma' or 'mma', got {unit!r}")
    _check_conv1_channels(x, w)


def _check_conv1_channels(x, w) -> None:
    if x.is_cuda and w.shape[-1] != CONV1_CHANNELS:
        raise ValueError(f"the conv1 kernels take {CONV1_CHANNELS} output channels, got w {tuple(w.shape)}")


def sum_sq_checksum(x):
    """v0: x (B, T, F) -> (B, 8, 128) f32, every entry sum x + sum x^2 of the sample."""
    if x.dim() != 3:
        raise ValueError(f"want x (B, T, F), got {tuple(x.shape)}")
    b, t, f = x.shape
    return _dispatch(x, lambda: _pass_launch("v0", x, None, _sums(b, x), None, False, t, f, 0),
                     lambda: sum_sq_plain(x), False)


def conv1_same_checksum(x, w, unit="fma", return_y=False):
    """v1 (``unit="fma"``) and v2 (``"mma"``): SAME conv1, x (B, T, F), w
    (3, 3, CO) -> (B, 8, 128) f32, and y (B, T, F, CO) if asked."""
    _check_conv1(x, w, (3, 3))
    _check_unit(unit, x, w)
    b, t, f = x.shape
    case, co = _UNITS[unit][0], w.shape[-1]
    return _dispatch(x, lambda: _pass_launch(case, x, w, _sums(b, x), (b, t, f, co), return_y, t, f, co),
                     lambda: conv1_same_plain(x, w), return_y)


def conv1_group_checksum(x, w, return_y=False):
    """v3: the SAME conv1 on the tensor cores, summed over each group of
    ``GROUP`` samples -> (B // GROUP, 8, 128) f32, and y grouped as
    :func:`conv1_group_plain` if asked. A tail of fewer than ``GROUP``
    samples is dropped, as ``kern_v3``'s grid of B // 8 steps drops it."""
    _check_conv1(x, w, (3, 3))
    _check_unit("mma", x, w)
    b, t, f = x.shape
    n, co = b // GROUP, w.shape[-1]
    return _dispatch(x, lambda: _pass_launch("v3", x, w, _sums(n, x), (n, GROUP * t, f, co), return_y, t, f, co,
                                             GROUP),
                     lambda: conv1_group_plain(x, w), return_y)


def conv1_emit(x, w):
    """v4: x (B, T, F), w (3, 3, CO) -> (B, T // 2, F, CO) in x's dtype: the
    SAME conv1, y * 1.01 + 0.01, ReLU and the mean of conv rows 2t and
    2t + 1 in f32, one cast at the end. The CUDA kernel takes CO = 32."""
    _check_conv1(x, w, (3, 3))
    _check_conv1_channels(x, w)
    b, t, f = x.shape
    co = w.shape[-1]

    def kernel():
        out = torch.empty((b, t // 2, f, co), device=x.device, dtype=torch.bfloat16)
        return _pass_launch("v4", x, w, out, None, False, t, f, co)

    return _dispatch(x, kernel, lambda: conv1_emit_plain(x, w), False, reduce=lambda y: y)


def conv1_valid_checksum(x, w9, unit="mma", return_y=False):
    """a (``unit="mma"``) and d (``"fma"``): VALID conv1, x (B, T, F), w9
    (9, CO) -> (B, 8, 128) f32, and y (B, T - 2, F - 2, CO) if asked."""
    _check_conv1(x, w9, (9,))
    _check_unit(unit, x, w9)
    b, t, f = x.shape
    if t < 3 or f < 3:
        raise ValueError(f"a VALID 3x3 conv needs T, F >= 3, got x {tuple(x.shape)}")
    case, co = _UNITS[unit][1], w9.shape[-1]
    return _dispatch(x, lambda: _pass_launch(case, x, w9, _sums(b, x), (b, t - 2, f - 2, co), return_y, t, f, co),
                     lambda: conv1_valid_plain(x, w9), return_y)


def flat_shift_checksum(xf, w9, return_y=False):
    """c: xf (B, 1, Np) flat padded samples of row width FLAT_WIDTH, w9 (9,
    CO) -> (B, 8, 128) f32, and y (B, M, CO), M = Np - 2 FLAT_WIDTH, if asked."""
    if xf.dim() != 3 or xf.shape[1] != 1 or w9.dim() != 2 or w9.shape[0] != 9:
        raise ValueError(f"want xf (B, 1, Np) and w9 (9, CO); got {tuple(xf.shape)}, {tuple(w9.shape)}")
    _check_unit("mma", xf, w9)
    b, _, n_p = xf.shape
    width = FLAT_WIDTH
    m = n_p - 2 * width
    if m < 1:
        raise ValueError(f"FLAT_WIDTH {width} leaves no output in xf {tuple(xf.shape)} (M = Np - 2 FLAT_WIDTH)")
    co = w9.shape[-1]
    return _dispatch(xf, lambda: _pass_launch("c", xf, w9, _sums(b, xf), (b, m, co), return_y, n_p, width, co),
                     lambda: flat_shift_plain(xf, w9), return_y)


def conv2_dx_checksum(h1, w2dx, return_y=False):
    """f: h1 (B, T2 + 2, F + 2, CI) pre-padded, w2dx (3, 3 CI, CO) -> (B, 8,
    128) f32, and y (B, T2, F, CO) if asked. The CUDA kernel takes CI = 32,
    CO = 64 and reads w2dx as it is."""
    if h1.dim() != 4 or w2dx.dim() != 3 or w2dx.shape[:2] != (3, 3 * h1.shape[-1]):
        raise ValueError(f"want h1 (B, T, F, CI) and w2dx (3, 3 CI, CO); got {tuple(h1.shape)}, {tuple(w2dx.shape)}")
    b, t, f, ci = h1.shape
    if t < 3 or f < 3:
        raise ValueError(f"a VALID 3x3 conv needs T, F >= 3, got h1 {tuple(h1.shape)}")
    co = w2dx.shape[-1]
    if h1.is_cuda and (ci, co) != CONV2_CHANNELS:
        raise ValueError(f"the conv2 kernel takes {CONV2_CHANNELS[0]} -> {CONV2_CHANNELS[1]} channels, "
                         f"got w2dx {tuple(w2dx.shape)}")
    return _dispatch(h1, lambda: _pass_launch("f", h1, w2dx, _sums(b, h1), (b, t - 2, f - 2, co), return_y, t, f, co),
                     lambda: conv2_dx_plain(h1, w2dx), return_y)


# Stage 11's five cases (train_opt_probe.py:927-931) on x (B, T, F), w (3, 3, CO).
STAGE11_CASES = {
    "v0": Case(lambda x, w: sum_sq_checksum(x), lambda x, w: sum_sq_plain(x), "x", "w"),
    "v1": Case(lambda x, w: conv1_same_checksum(x, w, "fma"), conv1_same_plain, "x", "w"),
    "v2": Case(lambda x, w: conv1_same_checksum(x, w, "mma"), conv1_same_plain, "x", "w"),
    "v3": Case(conv1_group_checksum, conv1_group_plain, "x", "w"),
    "v4": Case(conv1_emit, conv1_emit_plain, "x", "w"),  # both return the emitted tensor
}
# Stage 12's four (:1050-1055).
STAGE12_CASES = {
    "a": Case(lambda x, w: conv1_valid_checksum(x, w, "mma"), conv1_valid_plain, "x", "w9"),
    "c": Case(flat_shift_checksum, flat_shift_plain, "xpad_flat", "w9"),
    "d": Case(lambda x, w: conv1_valid_checksum(x, w, "fma"), conv1_valid_plain, "x", "w9"),
    "f": Case(conv2_dx_checksum, conv2_dx_plain, "h1", "w2dx"),
}
EMIT_CASE = "v4"


# ---- stages 14 and 15 (kernels 10 and 11) ---------------------------------

H2_WINDOW, H2_WINDOWS = 128, 2   # kern_h2's output columns per window and windows per row (pl.ds(fi 128, 130))
CONV3_ROWS, CONV3_COLS = 80, 176  # stage 15's conv3 window: make_convk(96, 192, 64, 128, 16, 5)
CONV3_CHANNELS = (64, 128)        # the conv3 kernel's C_in -> C_out
CHUNK_LEN, CHUNKS = 8192, 8       # kern_c2's Mc and its loop's n_mc

_CHUNK_ID = {"h2": 0, "i2": 1, "j4": 2, "j5": 3, "c2": 4}
_CHUNK_KEY = {"h2": "conv_chunked", "i2": "conv_chunked", "j4": "conv_trailing", "j5": "conv_trailing",
              "c2": "conv_trailing"}


def h2_col_starts(fp: int) -> list[int]:
    """The input column of each of h2's windows: ``pl.ds(i W, W + 2)`` on a
    ref Fp wide (W = H2_WINDOW), its start clamped to Fp - W - 2 as JAX's
    interpreter clamps it: [0, 126] at Fp = 256."""
    return [min(i * H2_WINDOW, fp - H2_WINDOW - 2) for i in range(H2_WINDOWS)]


def chunked_taps_plain(x, w9) -> torch.Tensor:
    """h2: x (B, Tp, Fp), w9 (9, CO) -> y (B, CONV1_ROWS, H2_WINDOWS H2_WINDOW,
    CO): window i is the VALID conv1 from input column h2_col_starts(Fp)[i]."""
    return torch.cat([_taps_conv_plain(x[:, :, s:, None], w9[:, None, :], "slice", CONV1_ROWS, H2_WINDOW)
                      for s in h2_col_starts(x.shape[2])], dim=2)


@no_tf32()
def tap_planes_plain(p9, w9) -> torch.Tensor:
    """i2: p9 (B, 9, Tp, Fp) tap-leading patches, w9 (9, CO) -> y (B, CONV1_ROWS, Fp, CO)."""
    return p9[:, :, :CONV1_ROWS].float().permute(0, 2, 3, 1) @ w9.float()


def conv2_dx_window_plain(h1, w2i) -> torch.Tensor:
    """j4: h1 (B, T2p, F2p, CI), w2i (3, 3 CI, CO) -> y (B, CONV2_ROWS, CONV2_SLICE_COLS, CO)."""
    return _taps_conv_plain(h1, conv2_dx_weights(w2i), "slice", CONV2_ROWS, CONV2_SLICE_COLS)


def conv3_plain(h2, w3) -> torch.Tensor:
    """j5: h2 (B, T3p, F2p, CI), w3 (9, CI, CO) -> y (B, CONV3_ROWS, CONV3_COLS, CO)."""
    return _taps_conv_plain(h2, w3, "slice", CONV3_ROWS, CONV3_COLS)


def chunk_starts(length: int) -> list[list[int]]:
    """c2's tap starts [c][k] = min(c Mc + dy W + dx, L - Mc) in a flat row
    of L = ``length`` elements (W = FLAT_WIDTH, Mc = CHUNK_LEN): JAX's
    interpreter clamps each ``pl.ds(c Mc + o_k, Mc)`` read so that it fits."""
    width, mc = FLAT_WIDTH, CHUNK_LEN
    return [[min(c * mc + dy * width + dx, length - mc) for dy in range(3) for dx in range(3)]
            for c in range(CHUNKS)]


@no_tf32()
def flat_chunks_plain(xf, wt) -> torch.Tensor:
    """c2: xf (B, R, L), wt (CO, 16) -> y (B, CHUNKS CHUNK_LEN, CO), chunk by
    chunk: taps 0-8 from row 0 of xf at :func:`chunk_starts`, taps 9-15 zero
    (as kern_c2 concatenates them), times wt transposed."""
    x = xf[:, 0].float()
    zeros = x.new_zeros(x.shape[0], CHUNK_LEN, 16 - 9)
    return torch.cat([torch.cat([torch.stack([x[:, s : s + CHUNK_LEN] for s in starts], dim=-1), zeros], dim=-1)
                      @ wt.float().t() for starts in chunk_starts(xf.shape[-1])], dim=1)


def _chunk_launch(case, inp, w, y_shape, return_y, t_in, f_in, rows, cols, win, n_out):
    """One launch of ``dfac_conv_chunk``: (B, 8, 128) f32, and y if asked."""
    batch = inp.shape[0]
    inp, w = _kernel_operands(inp, w)
    out = _sums(batch, inp)
    y = torch.empty(y_shape, device=inp.device, dtype=torch.float32) if return_y else None
    if batch == 0:
        return (out, y) if return_y else out
    done = torch.zeros(batch, device=inp.device, dtype=torch.int32)  # finished blocks per sample
    lib = _build.library()
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    with torch.cuda.device(inp.device):
        err = lib.dfac_conv_chunk(_CHUNK_ID[case], inp.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  y.data_ptr() if return_y else None, done.data_ptr(), batch, t_in, f_in, rows, cols,
                                  win, n_out, stream)
    _build.check(err, f"conv_chunk {case} launch")
    _build.LAUNCHES[_CHUNK_KEY[case]] += 1
    return (out, y) if return_y else out


def _check_window(inp, rows, cols, what) -> None:
    if rows + 2 > inp.shape[1] or cols + 2 > inp.shape[2]:
        raise ValueError(f"rows={rows}, cols={cols} need taps outside {what} {tuple(inp.shape)}")


def chunked_taps_checksum(x, w9, return_y=False):
    """h2: x (B, Tp, Fp), w9 (9, CO) -> (B, 8, 128) f32, and y (see
    :func:`chunked_taps_plain`) if asked. The CUDA kernel takes CO = 32."""
    _check_conv1(x, w9, (9,))
    _check_unit("mma", x, w9)
    _check_window(x, CONV1_ROWS, H2_WINDOW, "x")
    b, t, f = x.shape
    rows, cols, co = CONV1_ROWS, H2_WINDOWS * H2_WINDOW, w9.shape[1]
    return _dispatch(x, lambda: _chunk_launch("h2", x, w9, (b, rows, cols, co), return_y, t, f, rows, cols, H2_WINDOW,
                                              co),
                     lambda: chunked_taps_plain(x, w9), return_y)


def tap_planes_checksum(p9, w9, return_y=False):
    """i2: p9 (B, 9, Tp, Fp), w9 (9, CO) -> (B, 8, 128) f32, and y (B,
    CONV1_ROWS, Fp, CO) if asked."""
    if p9.dim() != 4 or p9.shape[1] != 9 or w9.dim() != 2 or w9.shape[0] != 9:
        raise ValueError(f"want p9 (B, 9, T, F) and w9 (9, CO); got {tuple(p9.shape)}, {tuple(w9.shape)}")
    b, _, t, f = p9.shape
    rows, co = CONV1_ROWS, w9.shape[1]
    if rows > t:
        raise ValueError(f"rows={rows} need planes of at least as many rows, got p9 {tuple(p9.shape)}")
    return _dispatch(p9, lambda: _chunk_launch("i2", p9, w9, (b, rows, f, co), return_y, t, f, rows, f, 0, co),
                     lambda: tap_planes_plain(p9, w9), return_y)


def conv2_dx_window_checksum(h1, w2i, return_y=False):
    """j4: h1 (B, T2p, F2p, CI), w2i (3, 3 CI, CO) -> (B, 8, 128) f32, and y
    (B, CONV2_ROWS, CONV2_SLICE_COLS, CO) if asked. The CUDA kernel takes
    CI = 32, CO = 64 and reads w2i as it is."""
    if h1.dim() != 4 or w2i.dim() != 3 or w2i.shape[:2] != (3, 3 * h1.shape[-1]):
        raise ValueError(f"want h1 (B, T, F, CI) and w2i (3, 3 CI, CO); got {tuple(h1.shape)}, {tuple(w2i.shape)}")
    rows, cols = CONV2_ROWS, CONV2_SLICE_COLS
    _check_window(h1, rows, cols, "h1")
    b, t, f, ci = h1.shape
    co = w2i.shape[-1]
    if h1.is_cuda and (ci, co) != CONV2_CHANNELS:
        raise ValueError(f"the conv2 kernel takes {CONV2_CHANNELS[0]} -> {CONV2_CHANNELS[1]} channels, "
                         f"got w2i {tuple(w2i.shape)}")
    return _dispatch(h1, lambda: _chunk_launch("j4", h1, w2i, (b, rows, cols, co), return_y, t, f, rows, cols, 0, co),
                     lambda: conv2_dx_window_plain(h1, w2i), return_y)


def conv3_checksum(h2, w3, return_y=False):
    """j5: h2 (B, T3p, F2p, CI), w3 (9, CI, CO) -> (B, 8, 128) f32, and y (B,
    CONV3_ROWS, CONV3_COLS, CO) if asked. The CUDA kernel takes CI = 64, CO = 128."""
    if h2.dim() != 4 or w3.dim() != 3 or w3.shape[:2] != (9, h2.shape[-1]):
        raise ValueError(f"want h2 (B, T, F, CI) and w3 (9, CI, CO); got {tuple(h2.shape)}, {tuple(w3.shape)}")
    rows, cols = CONV3_ROWS, CONV3_COLS
    _check_window(h2, rows, cols, "h2")
    b, t, f, ci = h2.shape
    co = w3.shape[-1]
    if h2.is_cuda and (ci, co) != CONV3_CHANNELS:
        raise ValueError(f"the conv3 kernel takes {CONV3_CHANNELS[0]} -> {CONV3_CHANNELS[1]} channels, "
                         f"got w3 {tuple(w3.shape)}")
    return _dispatch(h2, lambda: _chunk_launch("j5", h2, w3, (b, rows, cols, co), return_y, t, f, rows, cols, 0, co),
                     lambda: conv3_plain(h2, w3), return_y)


def flat_chunks_checksum(xf, wt, return_y=False):
    """c2: xf (B, R, L) whose row 0 holds flat padded samples of row width
    FLAT_WIDTH, wt (CO, 16) -> (B, 8, 128) f32, and y (B, CHUNKS CHUNK_LEN,
    CO) if asked. The CUDA kernel takes CO = 32."""
    if xf.dim() != 3 or wt.dim() != 2 or wt.shape[1] != 16:
        raise ValueError(f"want xf (B, R, L) and wt (CO, 16); got {tuple(xf.shape)}, {tuple(wt.shape)}")
    b, r, length = xf.shape
    if length < CHUNK_LEN:
        raise ValueError(f"CHUNK_LEN {CHUNK_LEN} does not fit in xf {tuple(xf.shape)}")
    co = wt.shape[0]
    if xf.is_cuda and co != CONV1_CHANNELS:
        raise ValueError(f"the conv1 kernels take {CONV1_CHANNELS} output channels, got wt {tuple(wt.shape)}")
    cols = CHUNKS * CHUNK_LEN
    return _dispatch(xf, lambda: _chunk_launch("c2", xf, wt, (b, cols, co), return_y, length, FLAT_WIDTH, r, cols,
                                               CHUNK_LEN, co),
                     lambda: flat_chunks_plain(xf, wt), return_y)


def _conv2_slice(key):
    return Case(lambda h, w: conv2_checksum(h, w, "slice", key=key), lambda h, w: conv2_plain(h, w, "slice"),
                "h1", "w2")


# Stage 14's three cases (train_opt_probe.py:1316-1320); j2 is j's kernel.
STAGE14_CASES = {
    "h2": Case(chunked_taps_checksum, chunked_taps_plain, "x", "w9"),
    "i2": Case(tap_planes_checksum, tap_planes_plain, "p9", "w9"),
    "j2": _conv2_slice("conv_chunked"),
}
# Stage 15's four (:1426-1476); j3 is j's kernel.
STAGE15_CASES = {
    "j3": _conv2_slice("conv_trailing"),
    "j4": Case(conv2_dx_window_checksum, conv2_dx_window_plain, "h1", "w2i"),
    "j5": Case(conv3_checksum, conv3_plain, "h2arr", "w3"),
    "c2": Case(flat_chunks_checksum, flat_chunks_plain, "xf", "wt"),
}
