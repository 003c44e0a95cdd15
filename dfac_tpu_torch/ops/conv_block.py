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

Block 1 in bf16 (C_in = 1, C_out = 32, pooled) runs on the tensor cores as
one product per pooled pixel: A (pixels x 16) holds the pixel's 4 x 3
input window, B (16 x 64) both conv rows' weights; the kernel builds B in
registers by the map below (``conv_block_cin1_tc`` in the CUDA source).

Blocks 2 and 3 in f32 (C_in, C_out = 32, 64 or 64, 128; ``conv_block_f32``)
run as an implicit GEMM with exact f32 products on the CUDA cores, each
thread holding a register tile of 2 conv rows x 9 columns x 4 channels;
:func:`f32_tile_geometry` describes its tiles and threads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dfac_tpu_torch.ops import _build

# Block 1's K = 16, N = 64 product. k -> (window row, window column) of the
# input window rows 2ho - 1 .. 2ho + 2, columns col - 1 .. col + 1 of pooled
# pixel (b, ho, col), or None for a zero column of A: k = 4 * row + column.
CIN1_TC_K = tuple(None if k % 4 == 3 else (k // 4, k % 4) for k in range(16))
# n -> (conv row 2ho + r: r, channel): conv row r's tap dy reads window row
# dy + r. Within a conv row, column 8j + m carries channel 8 (m // 2) + 2j +
# m % 2, so that a thread's accumulators (columns 8j + 2q, + 1 of n-tiles j =
# 0..3 in mma.sync's m16n8 layout) are channels 8q .. 8q + 7 of its pixel.
CIN1_TC_N = tuple((n // 32, 8 * (n % 8 // 2) + 2 * (n % 32 // 8) + n % 2) for n in range(64))
# B and the bias are scaled by the pool's 0.5, so the pool is relu + relu:
# exact, as 0.5 * relu(a) == relu(0.5 * a) in binary floating point
CIN1_TC_SCALE = 0.5

# f32 blocks 2 and 3 (conv_block_f32): 256 threads per block, each holding
# 2 conv rows x F32_COLS columns x F32_CH channels; a tile is 2 * row_pairs
# conv rows x F32_TW columns x C_out, its halo (2 * row_pairs + 2) x (F32_TW
# + 2) pixels starting at conv row -1 and column -1 of the tile.
F32_THREADS, F32_COLS, F32_CH, F32_TW = 256, 9, 4, 36


def f32_tile_geometry(h: int, width: int, c_out: int, pool: bool) -> dict:
    """The f32 kernel's tiling, as its index arithmetic computes it: the
    tile counts, the row pairs per tile and, per thread (index =
    threadIdx.x), its channel group ``chg`` (channels 4 chg ..), column group
    ``colg`` (tile columns 9 colg ..) and row pair ``rp`` (tile conv rows
    2 rp, + 1)."""
    groups = c_out // F32_CH
    row_pairs = F32_THREADS // (groups * (F32_TW // F32_COLS))
    pairs = h // 2 if pool else (h + 1) // 2
    tid = torch.arange(F32_THREADS)
    lane, warp = tid % 32, tid // 32
    return {
        "row_pairs": row_pairs,
        "row_tiles": -(-pairs // row_pairs),
        "col_tiles": -(-width // F32_TW),
        "halo_rows": 2 * row_pairs + 2,
        "chg": (warp % (groups // 8)) * 8 + lane % 8,
        "colg": lane // 8,
        "rp": warp // (groups // 8),
    }


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
    w, b = (t.clone() if t.data_ptr() % 16 else t for t in (w, b))  # and weights and biases too
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


def cnn2d_head_from_mean(
    hm: torch.Tensor, folded: dict, apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Block 3's mean over time (B, F, C) f32 -> (B,) scores: channel-major
    flatten, one output unit. The head is a multiply and a sum, with the
    product rounded to ``compute_dtype`` as the JAX chain's ``emb @ w_cls``
    in that dtype is."""
    emb = hm.transpose(1, 2).reshape(hm.shape[0], -1)  # channel-major
    w_cls = folded["w_cls"][:, 0].to(compute_dtype).float()
    dot = (emb.to(compute_dtype).float() * w_cls).sum(dim=-1)
    logits = dot.to(compute_dtype).float() + folded["b_cls"][0]
    return torch.sigmoid(logits) if apply_sigmoid else logits


def cnn2d_head(
    h: torch.Tensor, folded: dict, apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Block-3 output (B, T', F, C) -> (B,) scores: the f32 mean over time,
    then :func:`cnn2d_head_from_mean`."""
    return cnn2d_head_from_mean(h.mean(dim=1, dtype=torch.float32), folded, apply_sigmoid, compute_dtype)


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
