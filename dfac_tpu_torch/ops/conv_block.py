"""Fused conv block: kernel 2 and its plain PyTorch version.

Counterpart of :mod:`dfac_tpu.ops.pallas.conv_block`. One CNN2D block at
inference — 3x3 SAME conv with the BatchNorm folded in, + bias, ReLU, and
an optional floor-mode (2, 1) average pool over time — on NHWC tensors:

    x (B, H, W, C_in), w (3, 3, C_in, C_out) HWIO, b (C_out,)
      -> (B, H // 2 if pool else H, W, C_out) in x's dtype

with f32 accumulation and the epilogue (bias, ReLU, pool) in f32 before
one cast. The JAX package has two Pallas kernels for this block
(``fused_conv_block`` with a manual halo DMA and ``fused_conv_block_v2``
with a carried halo); they compute the same function, so one CUDA kernel
(``csrc/conv_block.cu``) covers both.

On a CUDA tensor :func:`fused_conv_block` launches that kernel; on a CPU
tensor it runs :func:`reference_conv_block`. It never falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build


def reference_conv_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool = True):
    """The kernel's plain PyTorch version.

    The operands are rounded to x's dtype (as the kernel reads them), then
    the conv runs in f32: a bf16 ``conv2d`` would return bf16 and lose the
    f32 accumulation the kernel keeps. With pooling, the odd trailing conv
    row is dropped after the conv (floor mode), so it still served as the
    halo of the row before it."""
    xf = x.permute(0, 3, 1, 2).float()  # NCHW
    wf = w.to(x.dtype).permute(3, 2, 0, 1).float()  # OIHW
    y = F.conv2d(xf, wf, padding=1)
    y = torch.relu(y + b.float()[None, :, None, None])
    if pool:
        y = F.avg_pool2d(y, (2, 1))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv_block_cuda(x, w, b, pool):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]) or w.dim() != 4:
        raise ValueError(f"want x (B,H,W,C_in) and w (3,3,C_in,C_out); got {tuple(x.shape)}, {tuple(w.shape)}")
    batch, h, width, c_in = x.shape
    c_out = w.shape[-1]
    if b.shape != (c_out,):
        raise ValueError(f"b must be ({c_out},), got {tuple(b.shape)}")
    if not (w.device == b.device == x.device):
        raise ValueError("x, w and b must lie on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads pixels as 16-byte vectors
        x = x.clone()
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    h_out = h // 2 if pool else h
    out = torch.empty((batch, h_out, width, c_out), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.dfac_conv_block(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            batch, h, width, c_in, c_out, int(pool), int(x.dtype == torch.bfloat16), stream,
        )
    _build.check(err, "conv_block launch")
    _build.LAUNCHES["conv_block"] += 1
    return out


def fused_conv_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool = True):
    """x (B, H, W, C_in), w (3, 3, C_in, C_out), b (C_out,) ->
    (B, H', W, C_out) with H' = floor(H/2) when pooling."""
    if x.is_cuda:
        return _conv_block_cuda(x, w, b, pool)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return reference_conv_block(x, w, b, pool)


def cnn2d_head(
    h: torch.Tensor, folded: dict, apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Block-3 output (B, T', F, C) -> (B,) scores: mean over time,
    channel-major flatten, one output unit. The head is a multiply and a
    sum, with the product rounded to ``compute_dtype`` as the JAX chain's
    ``emb @ w_cls`` in that dtype is."""
    hm = h.mean(dim=1, dtype=torch.float32)  # (B, F, C): mean over time, f32 sums
    emb = hm.transpose(1, 2).reshape(hm.shape[0], -1)  # channel-major
    w_cls = folded["w_cls"][:, 0].to(compute_dtype).float()
    dot = (emb.to(compute_dtype).float() * w_cls).sum(dim=-1)
    logits = dot.to(compute_dtype).float() + folded["b_cls"][0]
    return torch.sigmoid(logits) if apply_sigmoid else logits


def cnn2d_fused_scores(
    folded: dict,
    feats_swapped: torch.Tensor,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Full CNN2D inference on (B, T, F) input through three fused blocks.

    ``folded`` comes from :func:`dfac_tpu_torch.models.fast_infer.fold_cnn2d`."""
    h = feats_swapped.to(compute_dtype)[..., None]
    h = fused_conv_block(h, folded["w1"], folded["b1"], pool=True)
    h = fused_conv_block(h, folded["w2"], folded["b2"], pool=True)
    h = fused_conv_block(h, folded["w3"], folded["b3"], pool=False)
    return cnn2d_head(h, folded, apply_sigmoid, compute_dtype)
