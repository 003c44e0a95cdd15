"""w8a8 conv block: the int8 kernel and its plain PyTorch version.

No Pallas counterpart: the JAX package's w8a8 chain
(:mod:`dfac_tpu.models.fast_infer_int8`, ``_w8a8_chain``) runs blocks 2 and
3 as XLA convolutions, int8 x int8 -> int32 (``fast_infer_int8.py:188-201``).
No PyTorch convolution takes int8 on CUDA, so on the card the block is one
hand-written kernel (``csrc/conv_block_w8a8.cu``): a 3x3 SAME implicit GEMM
on the tensor cores (``mma.sync`` m16n8k32 s8) with the epilogue fused,
NHWC:

    x (B, H, W, C_in) int8, w (3, 3, C_in, C_out) int8 HWIO, deq, b (C_out,) f32
    acc = conv(x, w) in int32;  h = relu(acc * deq + b)
    inv_s given (block 2): min(round(h * inv_s), 127) as int8, then the int8
        time pool (q0 + q1 + 1) >> 1 -> (B, H // 2, W, C_out) int8
    inv_s None (block 3): h -> (B, H, W, C_out) f32

``acc * deq`` and ``+ b`` round as two f32 operations and the round is half
to even, in both versions, so the kernel equals the plain version bit for
bit. On a CUDA tensor :func:`conv_block_w8a8` launches the kernel or raises;
on a CPU tensor it runs :func:`reference_conv_block_w8a8`. It never falls
back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build

QMAX = 127
# The plain version sums exact int8 products in f32: exact while every
# partial sum stays below 2^24, i.e. 9 * C_in * 128 * 128 < 2^24.
MAX_CIN_F32_EXACT = (2**24 - 1) // (9 * 128 * 128)
KERNEL_SHAPES = ((32, 64), (64, 128))  # (C_in, C_out) the kernel takes: CNN2D's blocks 2 and 3


def quant_act(h: torch.Tensor, inv_s) -> torch.Tensor:
    """Post-ReLU activation -> int8 with a static scale: ``min(round(h *
    inv_s), 127)``, the product in f32 and the round half to even
    (``fast_infer_int8.py:67``). ``inv_s`` is an f32 value (a Python float
    or a CPU scalar tensor: no device sync), rounded to f32 first."""
    inv = float(torch.tensor(float(inv_s), dtype=torch.float32))
    return torch.mul(h, inv).round_().clamp_(max=QMAX).to(torch.int8)


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


def reference_conv_block_w8a8(x, w, deq, b, inv_s=None):
    """The kernel's plain PyTorch version (see the module docstring)."""
    acc = int8_conv_acc(x, w)
    h = torch.relu(acc.float() * deq.float() + b.float())
    if inv_s is None:
        return h
    return pool2_int8(quant_act(h, inv_s), time_axis=1)


def _conv_block_w8a8_cuda(x, w, deq, b, inv_s):
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
    if not (w.device == deq.device == b.device == x.device):
        raise ValueError("x, w, deq and b must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies pixels as 16-byte chunks
        x = x.clone()
    wt = w.permute(0, 1, 3, 2).reshape(9, c_out, c_in).contiguous()  # each tap's rows (cout, cin)
    deq = deq.float().contiguous()
    b = b.float().contiguous()
    quantized = inv_s is not None
    if quantized:
        out = torch.empty((batch, h // 2, width, c_out), device=x.device, dtype=torch.int8)
    else:
        out = torch.empty((batch, h, width, c_out), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dfac_conv_block_w8a8(
            x.data_ptr(), wt.data_ptr(), deq.data_ptr(), b.data_ptr(), float(inv_s) if quantized else 0.0,  # f32
            int(quantized), out.data_ptr(), batch, h, width, c_in, c_out, stream,
        )
    _build.check(err, "conv_block_w8a8 launch")
    _build.LAUNCHES["conv_block_w8a8"] += 1
    return out


def conv_block_w8a8(x: torch.Tensor, w: torch.Tensor, deq: torch.Tensor, b: torch.Tensor, inv_s=None):
    """One w8a8 block: int8 (B, H, W, C_in) -> int8 (B, H // 2, W, C_out)
    with ``inv_s`` (quantized and pooled; a Python float or a CPU scalar,
    so that reading it does not wait for the device), else f32 (B, H, W,
    C_out)."""
    if x.is_cuda:
        return _conv_block_w8a8_cuda(x, w, deq, b, inv_s)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return reference_conv_block_w8a8(x, w, deq, b, inv_s)
