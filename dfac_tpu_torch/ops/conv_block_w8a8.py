"""The w8a8 chain's kernels and their plain PyTorch versions.

No Pallas counterpart: the JAX package's w8a8 chain
(:mod:`dfac_tpu.models.fast_infer_int8`, ``_w8a8_chain``,
``fast_infer_int8.py:169-209``) runs block 1 and the int8 blocks 2 and 3
as XLA convolutions. No PyTorch convolution takes int8 on CUDA, so on the
card each block is one hand-written kernel (``csrc/conv_block_w8a8.cu``):

* :func:`conv_block_w8a8`, blocks 2 and 3: a 3x3 SAME implicit GEMM on the
  tensor cores (``wgmma`` m64nNk32 s8) with the epilogue fused, NHWC::

    x (B, H, W, C_in) int8, w (3, 3, C_in, C_out) int8 HWIO, deq, b (C_out,) f32
    acc = conv(x, w) in int32;  h = relu(acc * deq + b)
    inv_s given (block 2): min(round(h * inv_s), 127) as int8, then the int8
        time pool (q0 + q1 + 1) >> 1 -> (B, H // 2, W, C_out) int8
    time_mean (block 3): the sum of h over time, t = 0, 1, ..., H - 1 in
        that order, times float32(1 / H) -> (B, W, C_out) f32
    neither: h -> (B, H, W, C_out) f32

  ``acc * deq`` and ``+ b`` round as two f32 operations and the round is
  half to even, in both versions, so the kernel equals the plain version
  bit for bit in every mode.
* :func:`block1_w8a8`, block 1: (B, T, F) features (any strides) -> int8
  (B, T // 2, F, 32), the conv rows' 9 taps summed in order (dy, dx) with
  f32 products and sums, the bias added after the sum, the int8 epilogue
  and the int8 pool (:func:`reference_block1_w8a8`). In f32 the kernel
  takes that order and equals the plain version bit for bit; in bf16 it
  sums on the tensor cores, in their order (the products are exact), so a
  code may move by one step.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. It never falls back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build

QMAX = 127
# The plain version sums exact int8 products in f32: exact while every
# partial sum stays below 2^24, i.e. 9 * C_in * 128 * 128 < 2^24.
MAX_CIN_F32_EXACT = (2**24 - 1) // (9 * 128 * 128)
KERNEL_SHAPES = ((32, 64), (64, 128))  # (C_in, C_out) the kernel takes: CNN2D's blocks 2 and 3
MODE_F32, MODE_POOLED, MODE_MEAN = 0, 1, 2  # the kernel's output modes
B1_COUT = 32  # block 1's output channels


def _f32(v) -> float:
    """A scale as the kernels read it: rounded to f32 (a Python float or a
    CPU scalar tensor, so that reading it does not wait for the device)."""
    return float(torch.tensor(float(v), dtype=torch.float32))


def quant_act(h: torch.Tensor, inv_s) -> torch.Tensor:
    """Post-ReLU activation -> int8 with a static scale: ``min(round(h *
    inv_s), 127)``, the product in f32 and the round half to even
    (``fast_infer_int8.py:67``). ``inv_s`` is an f32 value (a Python float
    or a CPU scalar tensor: no device sync), rounded to f32 first."""
    return torch.mul(h, _f32(inv_s)).round_().clamp_(max=QMAX).to(torch.int8)


def pool2_int8(q: torch.Tensor, time_axis: int = 1) -> torch.Tensor:
    """Stride-2 average pool over ``time_axis`` in the int8 domain:
    ``(a + b + 1) >> 1`` over rows 2p and 2p + 1, an odd last row dropped
    (``fast_infer_int8.py:73``; post-ReLU values are in [0, 127], so the
    sum fits int16, where JAX sums in int32: the same integers)."""
    n = q.shape[time_axis] // 2
    a = q.narrow(time_axis, 0, 2 * n).unflatten(time_axis, (n, 2)).short()
    return ((a.select(time_axis + 1, 0) + a.select(time_axis + 1, 1) + 1) >> 1).to(torch.int8)


def int8_conv_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 accumulators of the 3x3 SAME conv of int8 NHWC ``x`` with
    int8 HWIO ``w``: (B, H, W, C_out). Per tap, an f32 product of the int8
    values (exact products, integer partial sums below 2^24: exact in any
    summation order, TF32 included, as int8 values fit its mantissa). No
    convolution algorithm is used, since Winograd or FFT ones would not be
    exact."""
    c_in = x.shape[-1]
    if c_in > MAX_CIN_F32_EXACT:
        raise ValueError(f"C_in {c_in} > {MAX_CIN_F32_EXACT}: the f32 sums of the plain version would not be exact")
    batch, h, width, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # (B, H + 2, W + 2, C_in), zero halo
    wf = w.float()
    acc = torch.zeros(batch, h, width, w.shape[-1], dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + width] @ wf[dy, dx]
    return acc.to(torch.int32)


def time_mean_f32(h: torch.Tensor) -> torch.Tensor:
    """(B, T, W, C) f32 -> (B, W, C): the sum over time, t = 0, 1, ..., T -
    1 in that order, each addition rounded in f32, then the product with
    float32(1 / T): the kernel's mean mode, bit for bit. Against any other
    order it differs by the rounding of T f32 additions."""
    s = torch.zeros_like(h[:, 0])
    for t in range(h.shape[1]):
        s = s + h[:, t]
    return s * float(np.float32(1.0 / h.shape[1]))


def reference_conv_block_w8a8(x, w, deq, b, inv_s=None, time_mean=False):
    """The kernel's plain PyTorch version (see the module docstring)."""
    acc = int8_conv_acc(x, w)
    h = torch.relu(acc.float() * deq.float() + b.float())
    if time_mean:
        return time_mean_f32(h)
    if inv_s is None:
        return h
    return pool2_int8(quant_act(h, inv_s), time_axis=1)


def _conv_block_w8a8_cuda(x, w, deq, b, inv_s, time_mean):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"want x (B,H,W,C_in) and w (3,3,C_in,C_out); got {tuple(x.shape)}, {tuple(w.shape)}")
    batch, h, width, c_in = x.shape
    c_out = w.shape[-1]
    if (c_in, c_out) not in KERNEL_SHAPES:
        raise ValueError(f"conv_block_w8a8 takes (C_in, C_out) in {KERNEL_SHAPES}, got {(c_in, c_out)}")
    if deq.shape != (c_out,) or b.shape != (c_out,):
        raise ValueError(f"deq and b must be ({c_out},), got {tuple(deq.shape)}, {tuple(b.shape)}")
    if time_mean and (inv_s is not None or h == 0):
        raise ValueError("time_mean takes no inv_s and at least one time row")
    if not (w.device == deq.device == b.device == x.device):
        raise ValueError("x, w, deq and b must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies pixels as 16-byte chunks
        x = x.clone()
    wt = w.permute(0, 1, 3, 2).reshape(9, c_out, c_in).contiguous()  # each tap's rows (cout, cin)
    if wt.data_ptr() % 16:  # and weights too
        wt = wt.clone()
    deq = deq.float().contiguous()
    b = b.float().contiguous()
    if time_mean:
        mode, out = MODE_MEAN, torch.empty((batch, width, c_out), device=x.device, dtype=torch.float32)
    elif inv_s is not None:
        mode, out = MODE_POOLED, torch.empty((batch, h // 2, width, c_out), device=x.device, dtype=torch.int8)
    else:
        mode, out = MODE_F32, torch.empty((batch, h, width, c_out), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dfac_conv_block_w8a8(
            x.data_ptr(), wt.data_ptr(), deq.data_ptr(), b.data_ptr(), _f32(inv_s) if mode == MODE_POOLED else 0.0,
            mode, out.data_ptr(), batch, h, width, c_in, c_out, stream,
        )
    _build.check(err, "conv_block_w8a8 launch")
    _build.LAUNCHES["conv_block_w8a8"] += 1
    return out


def conv_block_w8a8(x: torch.Tensor, w: torch.Tensor, deq: torch.Tensor, b: torch.Tensor, inv_s=None,
                    time_mean: bool = False):
    """One w8a8 block: int8 (B, H, W, C_in) -> int8 (B, H // 2, W, C_out)
    with ``inv_s`` (quantized and pooled; a Python float or a CPU scalar,
    so that reading it does not wait for the device), f32 (B, W, C_out)
    with ``time_mean`` (the mean over time of the f32 output), else f32
    (B, H, W, C_out)."""
    if x.is_cuda:
        return _conv_block_w8a8_cuda(x, w, deq, b, inv_s, time_mean)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return reference_conv_block_w8a8(x, w, deq, b, inv_s, time_mean)


def block1_conv_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Block 1's conv rows in the kernel's order: (B, T, F) features and the
    HWIO (3, 3, 1, C) kernel, both rounded to ``compute_dtype``, ->
    (B, T, F, C) f32, each output the sum of its 9 taps in order (dy, dx),
    each product and each sum rounded in f32 (no FMA), the SAME padding
    zeros included."""
    t, f = x.shape[1:]
    xp = F.pad(x.to(compute_dtype).float(), (1, 1, 1, 1))[..., None]  # (B, T + 2, F + 2, 1)
    wf = w.to(compute_dtype).float()
    y = None
    for dy in range(3):
        for dx in range(3):
            term = xp[:, dy:dy + t, dx:dx + f] * wf[dy, dx, 0]
            y = term if y is None else y + term
    return y


def reference_block1_w8a8(x, w1, b1, inv_s1, compute_dtype: torch.dtype) -> torch.Tensor:
    """The block-1 kernel's plain version: :func:`block1_conv_f32`, then
    ``relu(y + b1)`` (the bias after the conv sum, as JAX adds it),
    :func:`quant_act` of each conv row and the int8 pool
    (:func:`pool2_int8`) -> (B, T // 2, F, C) int8."""
    y = block1_conv_f32(x, w1, compute_dtype)
    return pool2_int8(quant_act(torch.relu(y + b1.float()), inv_s1), time_axis=1)


def _block1_w8a8_cuda(x, w1, b1, inv_s1, dt):
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {dt}")
    if x.dim() != 3 or w1.shape != (3, 3, 1, B1_COUT) or b1.shape != (B1_COUT,):
        raise ValueError(f"want x (B,T,F), w1 (3,3,1,{B1_COUT}), b1 ({B1_COUT},); got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(b1.shape)}")
    if not (w1.device == b1.device == x.device):
        raise ValueError("x, w1 and b1 must lie on one device")
    x = x.to(dt)  # any strides: the kernel reads x at its own
    w = w1.to(dt).float().reshape(9, B1_COUT).contiguous()
    b = b1.float().contiguous()
    batch, t, f = x.shape
    out = torch.empty((batch, t // 2, f, B1_COUT), device=x.device, dtype=torch.int8)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dfac_block1_w8a8(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), _f32(inv_s1), out.data_ptr(), batch, t, f, *x.stride(),
            int(dt == torch.bfloat16), stream,
        )
    _build.check(err, "block1_w8a8 launch")
    _build.LAUNCHES["block1_w8a8"] += 1
    return out


def block1_w8a8(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, inv_s1,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """w8a8 block 1: (B, T, F) features -> int8 (B, T // 2, F, 32) NHWC
    (see :func:`reference_block1_w8a8`); ``inv_s1`` a Python float or a CPU
    scalar."""
    if x.is_cuda:
        return _block1_w8a8_cuda(x, w1, b1, inv_s1, compute_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return reference_block1_w8a8(x, w1, b1, inv_s1, compute_dtype)
