"""Conv-formulation probe checksums (kernels 6 and 9) and their plain versions.

Counterpart of the Pallas kernels of ``scripts/pallas_err_probe.py``
(``kern_g/i/j/k``) and of stage 13 of ``scripts/train_opt_probe.py``
(``kern_g/h/i/j/k``, the same four plus ``h``). Each forms every output
``y`` of a conv in f32 from bf16 operands and returns the per-sample sum,
broadcast to ``(B, 8, 128)`` f32 as the Pallas kernels write it:

====  =====================================  ======================================================
case  function                               y[b, t, f, co]
====  =====================================  ======================================================
g     ``conv1_taps_checksum(mode="roll")``   sum_k x[t+dy, (f+dx-1) mod Fp] w9[k, co], f < Fp
h     ``conv1_taps_checksum(mode="slice")``  sum_k x[t+dy, f+dx] w9[k, co], f < CONV1_SLICE_COLS
i     ``patches_checksum``                   sum_k p[t, f, k] w9[k, co]
j     ``conv2_checksum(mode="slice")``       sum_{k,ci} h[t+dy, f+dx, ci] w2[k, ci, co], f < CONV2_SLICE_COLS
k     ``conv2_checksum(mode="roll")``        as j with the column (f+dx-1) mod F2p, f < F2p
====  =====================================  ======================================================

with ``k = 3 dy + dx`` and ``t < CONV1_ROWS`` or ``CONV2_ROWS``: the
probes' aligned windows, module constants (the tests shrink them).
``pltpu.roll`` is ``np.roll``, so the roll taps wrap around the padded
width.

On a CUDA tensor each function launches ``csrc/conv_probe.cu`` (bf16 only)
or raises; on a CPU tensor it runs the plain version. The plain versions
(``*_plain``) return ``y`` itself, in f32; :func:`checksum` turns it into
the ``(B, 8, 128)`` result. They run f32 products through ``conv2d`` and
``matmul``, so TF32 must be off where they serve as a reference on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build

CONV1_ROWS, CONV1_SLICE_COLS = 320, 128  # stage 13's Tv and kern_h's window
CONV2_ROWS, CONV2_SLICE_COLS = 160, 176  # stage 13's T2 and kern_j's window
CONV2_CHANNELS = (32, 64)                 # the CUDA kernel's C_in -> C_out

_CASE_ID = {("conv1", "roll"): 0, ("conv1", "slice"): 1, ("patches", None): 2,
            ("conv2", "slice"): 3, ("conv2", "roll"): 4}


def checksum(y: torch.Tensor) -> torch.Tensor:
    """(B, ...) outputs -> (B, 8, 128) f32, every entry the sample's f32 sum."""
    s = y.float().sum(dim=tuple(range(1, y.dim())))
    return s[:, None, None].expand(-1, 8, 128).contiguous()


def _check_mode(mode: str) -> None:
    if mode not in ("roll", "slice"):
        raise ValueError(f"mode must be 'roll' or 'slice', got {mode!r}")


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


def patches_plain(p: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """p (B, rows, cols, 9), w9 (9, CO) -> y (B, rows, cols, CO)."""
    return p.float() @ w9.float()


def conv2_plain(h, w2, mode="slice") -> torch.Tensor:
    """h (B, T2p, F2p, CI), w2 (9, CI, CO) -> y (B, CONV2_ROWS, CONV2_SLICE_COLS or F2p, CO)."""
    return _taps_conv_plain(h, w2, mode, CONV2_ROWS, CONV2_SLICE_COLS)


def _launch(kind, mode, inp, w, rows, cols, n_out, return_y):
    if inp.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the conv-probe kernel takes bfloat16 inputs and weights, got {inp.dtype}, {w.dtype}")
    if w.device != inp.device:
        raise ValueError("inputs and weights must lie on one device")
    batch, t_in, f_in = inp.shape[:3]
    inp = inp.contiguous()
    if inp.data_ptr() % 16:  # the kernel stages rows with 16-byte loads
        inp = inp.clone()
    w = w.contiguous()
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
    _build.LAUNCHES["conv_probe"] += 1
    return (out, y) if return_y else out


def _dispatch(inp, kernel, plain, return_y):
    if inp.is_cuda:
        return kernel()
    if inp.device.type != "cpu":
        raise ValueError(f"unsupported device {inp.device}")
    y = plain()
    return (checksum(y), y) if return_y else checksum(y)


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


def conv2_checksum(h, w2, mode="slice", return_y=False):
    """Cases j (``mode="slice"``, the first CONV2_SLICE_COLS columns) and k
    (``"roll"``, every column): h (B, T2p, F2p, CI), w2 (9, CI, CO) ->
    (B, 8, 128) f32, and y if asked. The CUDA kernel takes CI=32, CO=64."""
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
    return _dispatch(h, lambda: _launch("conv2", mode, h, w2, rows, width, w2.shape[2], return_y),
                     lambda: conv2_plain(h, w2, mode), return_y)


class Case(NamedTuple):
    kernel: Callable  # f(input, weights) -> (B, 8, 128) f32
    plain: Callable   # f(input, weights) -> y, f32
    inp: str          # the probes' input array (train_opt_probe.stage13_inputs): x, patches or h1
    weights: str      # and its weights: w9 or w2


# The probes' five cases, in stage 13's order.
CASES = {
    "g": Case(lambda x, w: conv1_taps_checksum(x, w, "roll"), lambda x, w: conv1_taps_plain(x, w, "roll"), "x", "w9"),
    "h": Case(lambda x, w: conv1_taps_checksum(x, w, "slice"), lambda x, w: conv1_taps_plain(x, w, "slice"),
              "x", "w9"),
    "i": Case(patches_checksum, patches_plain, "patches", "w9"),
    "j": Case(lambda h, w: conv2_checksum(h, w, "slice"), lambda h, w: conv2_plain(h, w, "slice"), "h1", "w2"),
    "k": Case(lambda h, w: conv2_checksum(h, w, "roll"), lambda h, w: conv2_plain(h, w, "roll"), "h1", "w2"),
}
