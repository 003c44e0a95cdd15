"""w8a8 int8 serving chain for CNN2D (``predict --fast --int8``).

Counterpart of :mod:`dfac_tpu.models.fast_infer_int8`. Blocks 2 and 3 of
the folded CNN2D run as int8 x int8 -> int32 convolutions with int8
activations between the blocks:

* **Block 1** is one hand-written kernel
  (:func:`~dfac_tpu_torch.ops.conv_block_w8a8.block1_w8a8`): the f32 conv
  of the features and the kernel rounded to the compute dtype, then the f32
  epilogue ``relu(y + b1)``, ``quant_act`` with the calibrated scale and
  the int8 time pool ``pool2_int8``, as the JAX package's XLA program
  computes them; it reads a stored (B, F, T) batch as a transposed view.
* **Blocks 2 and 3** run on the int8 kernel
  (:func:`~dfac_tpu_torch.ops.conv_block_w8a8.conv_block_w8a8`): weights
  quantized per output channel (``amax / 127``), the dequant ``s_act *
  s_w[c]`` folded with the int32 accumulator, bias and ReLU in one
  epilogue; block 2 requantizes and pools in int8, block 3 writes the
  head's f32 mean over time.
* **The head** is
  :func:`~dfac_tpu_torch.ops.conv_block.cnn2d_head_from_mean`: the
  channel-major flatten, the dot rounded to the compute dtype.

Three kernel launches a batch, and no full-size f32 tensor.

Activation scales are static, from one calibration batch through the f32
chain (:func:`calibrate_cnn2d`). The chain runs on the (T, F) grid: block
1 reads a stored (B, F, T) batch as its transposed view, with no copy; the
JAX package swaps the kernels instead, which gives the same integers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.models.common import f32_convs
from dfac_tpu_torch.models.fast_infer import dequant8, fold_cnn2d, score_dataset
from dfac_tpu_torch.ops import conv_block_w8a8 as kw8
from dfac_tpu_torch.ops.conv_block import cnn2d_head_from_mean

_QMAX = 127.0


def _quant_weight_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an HWIO kernel
    (the output channel last): ``(w_q int8, s (C,) f32)`` with ``w ~= w_q *
    s``; an all-zero channel gets scale 1."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    s = torch.where(amax > 0, amax / _QMAX, torch.ones((), dtype=torch.float32, device=w.device))
    return torch.round(w / s).clamp_(-128, 127).to(torch.int8), s


def calibrate_cnn2d(folded: dict, feats: torch.Tensor, swap_tf: bool = True) -> tuple[float, float]:
    """The post-ReLU amax of blocks 1 and 2 of the f32 folded chain on a
    calibration batch: the static activation scales' inputs. ``feats`` is
    (B, F, T) when ``swap_tf``, else (B, T, F). An f32 average pool stands
    in for the int8 pool between the two (the same scale domain)."""
    x = feats.float()
    h = (x.transpose(1, 2) if swap_tf else x)[:, None]  # (B, 1, T, F)
    outs = []
    with f32_convs():
        for i in (1, 2):
            w = folded[f"w{i}"].float().permute(3, 2, 0, 1)  # HWIO -> OIHW
            h = torch.relu(F.conv2d(h, w, padding=1) + folded[f"b{i}"].float()[:, None, None])
            outs.append(float(h.max()))
            h = F.avg_pool2d(h, (2, 1))
    return outs[0], outs[1]


def fold_cnn2d_w8a8(state_dict: dict, calib_feats, swap_tf: bool = True, margin: float = 1.0) -> dict:
    """Fold BN and quantize for the w8a8 chain: :func:`fold_cnn2d`, then
    blocks 2 and 3's kernels per output channel and the two activation
    scales calibrated on ``calib_feats`` (``margin`` head-rooms the amax).
    ``s1``, ``s2`` are Python floats as in JAX; ``inv_s = float32(1 / s)``
    and ``deq = float32(s) * s_w`` in f32. Tensors lie on the
    state_dict's device, but for ``inv_s1``, ``inv_s2``: f32 scalars on
    the CPU, which the chain reads without waiting for the device."""
    folded = fold_cnn2d(state_dict)
    dev = folded["w1"].device
    a1, a2 = calibrate_cnn2d(folded, torch.as_tensor(np.asarray(calib_feats), device=dev), swap_tf=swap_tf)
    s1 = max(a1 * margin, 1e-12) / _QMAX
    s2 = max(a2 * margin, 1e-12) / _QMAX
    w2q, sw2 = _quant_weight_per_channel(folded["w2"])
    w3q, sw3 = _quant_weight_per_channel(folded["w3"])

    def f32(v, device=None):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {
        "w1": folded["w1"].float(), "b1": folded["b1"],
        "w2q": w2q, "b2": folded["b2"], "deq2": f32(s1, dev) * sw2,
        "w3q": w3q, "b3": folded["b3"], "deq3": f32(s2, dev) * sw3,
        "inv_s1": f32(1.0 / s1), "inv_s2": f32(1.0 / s2),  # CPU scalars: read without a device sync
        "w_cls": folded["w_cls"], "b_cls": folded["b_cls"],
    }


def block1_w8a8(f8: dict, feats_tf: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Block 1 on (B, T, F) features (any strides): the f32 conv of
    operands rounded to ``compute_dtype``, ``relu(y + b1)``, int8
    quantization and the int8 time pool -> (B, T // 2, F, C) int8, NHWC."""
    return kw8.block1_w8a8(feats_tf, f8["w1"], f8["b1"], f8["inv_s1"], compute_dtype)


def _w8a8_chain(f8: dict, feats_tf: torch.Tensor, apply_sigmoid: bool, dt: torch.dtype) -> torch.Tensor:
    """The chain body on (B, T, F) features: block 1, the two int8 blocks
    (block 3 takes the mean over time), the head."""
    q = block1_w8a8(f8, feats_tf, dt)
    q = kw8.conv_block_w8a8(q, f8["w2q"], f8["deq2"], f8["b2"], f8["inv_s2"])
    hm = kw8.conv_block_w8a8(q, f8["w3q"], f8["deq3"], f8["b3"], time_mean=True)
    return cnn2d_head_from_mean(hm, f8, apply_sigmoid, dt)


def cnn2d_w8a8_scores(
    f8: dict, feats_stored: torch.Tensor, apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Stored-orientation (B, F, T) features -> (B,) scores through the
    w8a8 chain."""
    return _w8a8_chain(f8, feats_stored.to(compute_dtype).transpose(1, 2), apply_sigmoid, compute_dtype)


def cnn2d_w8a8_scores_tf(
    f8: dict, feats_tf: torch.Tensor, apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """(B, T, F) features -> (B,) scores through the w8a8 chain (the GEMM
    front-end's orientation)."""
    return _w8a8_chain(f8, feats_tf, apply_sigmoid, compute_dtype)


def cnn2d_w8a8_scores_q8(
    f8: dict,
    q: torch.Tensor,
    scales: torch.Tensor,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8-quantized ingest rows (``fastcast.quant_i8``) -> (B,) scores
    through the w8a8 chain: the dequantize before block 1, then the int8
    blocks."""
    feats = dequant8(q, scales, compute_dtype)
    score = cnn2d_w8a8_scores if swap_tf else cnn2d_w8a8_scores_tf
    return score(f8, feats, apply_sigmoid, compute_dtype)


def predict_scores_w8a8(
    state_dict: dict,
    ds,
    device: torch.device,
    batch_size: int = 512,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    stats=None,
    calib_batches: int = 1,
    margin: float = 1.0,
    ingest_int8: bool = False,
) -> np.ndarray:
    """Score a whole dataset through the w8a8 chain on ``device``; (N,)
    float32 in dataset order. Calibrates on the first ``batch_size *
    calib_batches`` rows, so a run repeats. ``ingest_int8`` composes: rows
    upload quantized (:func:`~dfac_tpu_torch.models.fast_infer.ingest_q8`)
    and blocks 2 and 3 still compute in int8."""
    n_cal = min(max(batch_size * calib_batches, 1), len(ds.features))
    calib = np.asarray(ds.features[:n_cal], np.float32)
    sd = {k: v.to(device) for k, v in state_dict.items()}
    f8 = fold_cnn2d_w8a8(sd, calib, swap_tf=swap_tf, margin=margin)
    chain = cnn2d_w8a8_scores if swap_tf else cnn2d_w8a8_scores_tf
    return score_dataset(
        lambda feats: chain(f8, feats, apply_sigmoid, compute_dtype),
        lambda q, s: cnn2d_w8a8_scores_q8(f8, q, s, swap_tf, apply_sigmoid, compute_dtype),
        ds, device, batch_size, compute_dtype, stats, ingest_int8,
    )
