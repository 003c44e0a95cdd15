"""Serving chains with folded BatchNorm: CNN2D, CNN1D, the CAE scorer and
the detector.

Counterpart of :mod:`dfac_tpu.models.fast_infer` (its CNN2D, CNN1D, CAE
and detector parts). CNN2D:

* **BatchNorm folding** — at eval BN is affine, so it folds into the conv
  kernel and bias (``W' = W * inv``, ``b' = (b - mean) * inv + shift``,
  ``inv = scale / sqrt(var + eps)``).
* **Fused blocks** — every block is conv + bias + ReLU (+ time pool) in
  one call of :func:`dfac_tpu_torch.ops.conv_block.fused_conv_block`, so
  on CUDA all three run through the hand-written kernel and the pre-pool
  activation never reaches device memory. The JAX package's depthwise-conv
  pooling was a TPU layout workaround; the pool here lives in the
  kernel's epilogue.
* bf16 activations with f32 accumulation by default.

CNN2D's folded weights keep the JAX layouts (HWIO kernels, ``(128 * F,
1)`` classifier) so the tests compare like with like; the fused kernel
takes HWIO.

CNN1D, the CAE and the detector run through XLA convolutions in the JAX
package, so here they run through cuDNN (``F.conv1d``, ``F.conv2d``,
``F.conv_transpose2d``) and ATen's pools, and their folded kernels are in
torch's layouts (conv1d ``(O, I, k)``, conv ``(O, I, kh, kw)``,
transposed conv ``(I, O, kh, kw)``) so that no call permutes them.
**Where the bf16 rounding happens:** the JAX chains add the f32 bias to
the f32 accumulator and round once; a cuDNN bf16 convolution rounds its
output to bf16 first, and the bias is added in f32 to that (the
convolution runs without bias, the bias add on the upcast), so the bf16
chains here round twice. That stays inside the JAX package's own bf16
tolerances (CNN1D scores atol 2e-2, CAE MSE rtol 0.1;
``tests/test_fast_infer.py``; the detector's logits atol 2e-2). ATen's
bf16 average pool sums in f32 and rounds once, as JAX's depthwise-conv
pool does. f32 chains run with TF32 off
(:func:`~dfac_tpu_torch.models.common.f32_convs`), as JAX's f32 convs are
exact.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.models.cae import check_geometry, decoder_output_paddings, fit_time
from dfac_tpu_torch.models.common import BN_EPS, f32_convs
from dfac_tpu_torch.obs.profiling import close_span, maybe_open
from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores

# A batch of a memory-mapped store is a read-only view, and ``ingest`` only
# reads the tensor over it; silence torch's warning for this module alone,
# once, rather than swap the process-wide filters on every batch.
warnings.filterwarnings(
    "ignore", message="The given NumPy array is not writable", category=UserWarning, module=__name__
)


def _fold_bn(sd: dict, conv: str, bn: str, out_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``W' = W * inv`` (``inv`` broadcast on the kernel's output-channel
    dim ``out_dim``) and ``b' = (b - mean) * inv + shift``, ``inv = scale *
    rsqrt(var + eps)``, in the kernel's own layout."""
    inv = sd[f"{bn}.weight"] * torch.rsqrt(sd[f"{bn}.running_var"] + BN_EPS)
    w = sd[f"{conv}.weight"]
    shape = [1] * w.dim()
    shape[out_dim] = -1
    bias = (sd[f"{conv}.bias"] - sd[f"{bn}.running_mean"]) * inv + sd[f"{bn}.bias"]
    return (w * inv.reshape(shape)).contiguous(), bias


def _f32(state_dict: dict) -> dict:
    return {k: v.detach().float() for k, v in state_dict.items() if v.is_floating_point()}


def on_device(folded: dict, device: torch.device, dt: torch.dtype) -> dict:
    """``folded`` on ``device`` with its kernels (``w*``, ``*_w*``) cast to
    ``dt`` once, so that a chain's casts of them are no-ops; biases stay f32."""
    return {k: v.to(device, dt if k.startswith("w") or "_w" in k else torch.float32) for k, v in folded.items()}


def fold_cnn2d(state_dict: dict) -> dict:
    """Fold BN stats into the conv kernels/biases of a CNN2D ``state_dict``
    (the port's names); returns ``{w1..w3 (HWIO), b1..b3, w_cls, b_cls}``
    as f32 tensors on the state_dict's device."""
    sd = _f32(state_dict)
    folded = {}
    for i, (ci, bi) in enumerate([(0, 1), (5, 6), (10, 11)], 1):
        w, folded[f"b{i}"] = _fold_bn(sd, f"conv.{ci}", f"conv.{bi}", 0)
        folded[f"w{i}"] = w.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    folded["w_cls"] = sd["classifier.weight"].t().contiguous()
    folded["b_cls"] = sd["classifier.bias"].clone()
    return folded


def cnn2d_fast_scores_tf(
    folded: dict,
    feats_tf: torch.Tensor,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Swapped-orientation (B, T, F) features -> (B,) scores: the
    CNN2D-native grid, which the GEMM front-end's (B, T, 180) output feeds
    without a transpose."""
    return cnn2d_fused_scores(folded, feats_tf, apply_sigmoid, compute_dtype)


def cnn2d_fast_scores(
    folded: dict,
    feats_stored: torch.Tensor,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Stored-orientation (B, F, T) features -> (B,) scores, i.e.
    ``sigmoid(CNN2D(transpose(feats)))`` with BN folded. The kernel pools
    over H, so the grid turns to (T, F) once, at entry."""
    feats_tf = feats_stored.to(compute_dtype).transpose(1, 2).contiguous()
    return cnn2d_fused_scores(folded, feats_tf, apply_sigmoid, compute_dtype)


def ingest(feats_np: np.ndarray, compute_dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host -> device upload of a feature batch.

    The chain's first op casts to ``compute_dtype``, so the cast happens on
    the host (bit-identical, half the bytes in bf16); for a CUDA device the
    batch is staged in pinned memory and copied with ``non_blocking``, so
    the upload of batch k+1 overlaps the scoring of batch k. A batch of a
    memory-mapped store is read-only; the tensor over it is only read."""
    return _upload(torch.from_numpy(np.ascontiguousarray(feats_np)).to(compute_dtype), device)


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def ingest_q8(feats_np: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 host -> device upload (``--ingest-int8``): the rows are
    quantized per (utterance, group of the last axis) on the host
    (:func:`dfac_tpu_torch.io.fastcast.quant_i8`), and ``(q, scales)`` go
    up as :func:`ingest` sends a batch, from pinned memory with
    ``non_blocking``: half the link bytes of bf16."""
    from dfac_tpu_torch.io.fastcast import quant_i8

    q, scales = quant_i8(feats_np)
    return _upload(q, device), _upload(scales, device)


def dequant8(q: torch.Tensor, scales: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """int8 rows and per-group scales -> ``dt`` features on the device: an
    f32 multiply broadcast over the group (last) axis, then one cast."""
    return (q.float() * scales[..., None].float()).to(dt)


def cnn2d_fast_scores_q8(
    folded: dict,
    q: torch.Tensor,
    scales: torch.Tensor,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8-quantized features -> (B,) scores through the folded chain.
    ``swap_tf=True``: rows stored (B, F, T), one scale per (utterance,
    feature dim), turned to (T, F) once at entry as in
    :func:`cnn2d_fast_scores`; False: (B, T, F) rows, one scale per frame.
    The dequantize is one eager pass before K2's block 1."""
    feats = dequant8(q, scales, compute_dtype)
    score = cnn2d_fast_scores if swap_tf else cnn2d_fast_scores_tf
    return score(folded, feats, apply_sigmoid, compute_dtype)


def predict_scores_fast(
    state_dict: dict,
    ds,
    device: torch.device,
    batch_size: int = 512,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    stats=None,
    ingest_int8: bool = False,
) -> np.ndarray:
    """Score a whole :class:`~dfac_tpu_torch.data.pipeline.ArrayDataset`
    through the folded chain on ``device``; (N,) float32 in dataset order.

    ``swap_tf`` follows the reference predict CLI (``src/predict.py:100-111``):
    True means the features are stored (F, T) and the model sees the
    transposed grid. ``ingest_int8`` uploads int8 rows and their scales
    (:func:`ingest_q8`) and dequantizes on the device; scores shift by the
    quantization step.

    While a ``torch.profiler`` session collects, the call is a ``score``
    span (``rows``, ``rows_padded``) and the fold with the weights' upload
    a ``score.fold`` span inside it; the batches' spans are
    :func:`~dfac_tpu_torch.train.evaluate.collect_masked_scores`'s."""
    root = maybe_open("score", root=True)
    fold = maybe_open("score.fold")
    folded = {k: v.to(device) for k, v in fold_cnn2d(state_dict).items()}
    close_span(fold)
    chain = cnn2d_fast_scores if swap_tf else cnn2d_fast_scores_tf
    scores = score_dataset(
        lambda feats: chain(folded, feats, apply_sigmoid, compute_dtype),
        lambda q, s: cnn2d_fast_scores_q8(folded, q, s, swap_tf, apply_sigmoid, compute_dtype),
        ds, device, batch_size, compute_dtype, stats, ingest_int8, root,
    )
    close_span(root)
    return scores


def score_dataset(score, score_q8, ds, device, batch_size, compute_dtype, stats=None, ingest_int8=False, span=None):
    """Run a fast chain over a dataset, batch by batch, with host ingest in
    the prefetch thread: ``score(feats)`` on :func:`ingest`'s batches, or
    with ``ingest_int8`` ``score_q8(q, scales)`` on :func:`ingest_q8`'s;
    (N,) float32 in dataset order. ``span``: the caller's open ``score``
    span, which gets the call's counts."""
    from dfac_tpu_torch.train.evaluate import collect_masked_scores

    if ingest_int8:
        run, prepare = (lambda qs: score_q8(*qs)), (lambda b: ingest_q8(b.features, device))
    else:
        run, prepare = score, (lambda b: ingest(b.features, compute_dtype, device))
    with torch.inference_mode():
        return collect_masked_scores(run, ds, batch_size, prepare_batch=prepare, stats=stats, span=span)


def fold_cnn1d(state_dict: dict) -> dict:
    """Fold BatchNorm1d into the CNN1D conv kernels and biases (reference
    eval path ``src/model_cnn1d.py:37-46``); returns ``{w1..w3 (O, I, k),
    b1..b3, w_cls (128, 1), b_cls}`` as f32 tensors on the state_dict's
    device."""
    sd = _f32(state_dict)
    folded = {}
    for i, (ci, bi) in enumerate([(0, 1), (4, 5), (8, 9)], 1):
        folded[f"w{i}"], folded[f"b{i}"] = _fold_bn(sd, f"conv.{ci}", f"conv.{bi}", 0)
    folded["w_cls"] = sd["classifier.weight"].t().contiguous()
    folded["b_cls"] = sd["classifier.bias"].clone()
    return folded


def _cnn1d_chain_scores(folded: dict, h: torch.Tensor, apply_sigmoid: bool, dt: torch.dtype) -> torch.Tensor:
    """The folded CNN1D chain body: ``h`` is (B, F, T) in ``dt``."""
    with f32_convs():
        for i in (1, 2, 3):
            y = F.conv1d(h, folded[f"w{i}"].to(dt), padding=1)
            h = torch.relu(y.float() + folded[f"b{i}"][:, None]).to(dt)
    hm = h.float().mean(dim=2)  # (B, C), the mean over time in f32
    logits = (hm.to(dt) @ folded["w_cls"].to(dt)).float()[:, 0] + folded["b_cls"]
    return torch.sigmoid(logits) if apply_sigmoid else logits


def cnn1d_fast_scores(
    folded: dict,
    feats: torch.Tensor,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """CNN1D serving chain with BN folded: features -> (B,) scores, i.e.
    ``sigmoid(CNN1D(swap(feats)))`` in eval mode: conv -> bias -> ReLU x3,
    the mean over time, the classifier. ``swap_tf=True`` means ``feats`` is
    stored-orientation (B, F, T), the 180 feature dims the conv channels:
    that is ``F.conv1d``'s own (B, C, T), so nothing is transposed."""
    h = feats if swap_tf else feats.transpose(1, 2)
    return _cnn1d_chain_scores(folded, h.to(compute_dtype), apply_sigmoid, compute_dtype)


def cnn1d_fast_scores_q8(
    folded: dict,
    q: torch.Tensor,
    scales: torch.Tensor,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8-quantized features -> (B,) scores through the folded CNN1D
    chain: the dequantize in the quantized orientation, then the chain."""
    return cnn1d_fast_scores(folded, dequant8(q, scales, compute_dtype), swap_tf, apply_sigmoid, compute_dtype)


def predict_scores_fast_cnn1d(
    state_dict: dict,
    ds,
    device: torch.device,
    batch_size: int = 512,
    swap_tf: bool = True,
    apply_sigmoid: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    stats=None,
    ingest_int8: bool = False,
) -> np.ndarray:
    """Score a whole dataset through the folded CNN1D chain on ``device``;
    (N,) float32 in dataset order (batching, ingest and ``ingest_int8`` as
    :func:`predict_scores_fast`)."""
    folded = on_device(fold_cnn1d(state_dict), device, compute_dtype)
    return score_dataset(
        lambda feats: cnn1d_fast_scores(folded, feats, swap_tf, apply_sigmoid, compute_dtype),
        lambda q, s: cnn1d_fast_scores_q8(folded, q, s, swap_tf, apply_sigmoid, compute_dtype),
        ds, device, batch_size, compute_dtype, stats, ingest_int8,
    )


def fold_cae(state_dict: dict) -> dict:
    """Fold the ConvAutoencoder's eval-mode BatchNorms into its kernels and
    biases: ``{enc_w1..4 (O, I, 3, 3), enc_b1..4, dec_w1..4 (I, O, 2, 2),
    dec_b1..4}`` as f32 tensors.

    Encoder blocks fold as the classifiers' convs. Decoder blocks 1-3 fold
    into the transposed conv (BN scales its output channels, dim 1 of
    ``(I, O, kh, kw)``); an ``output_padding`` row carries only the bias
    before BN, and the folded bias ``(b - mean) * inv + shift`` is BN of
    that bias, so the fold stays exact there. Block 4 has no BN and passes
    through (reference ``src/model_cae.py:61-81``)."""
    sd = _f32(state_dict)
    folded = {}
    for i, (ci, bi) in enumerate([(0, 1), (4, 5), (8, 9), (12, 13)], 1):
        folded[f"enc_w{i}"], folded[f"enc_b{i}"] = _fold_bn(sd, f"encoder.{ci}", f"encoder.{bi}", 0)
    for i, ti in enumerate([0, 3, 6], 1):
        folded[f"dec_w{i}"], folded[f"dec_b{i}"] = _fold_bn(sd, f"decoder.{ti}", f"decoder.{ti + 1}", 1)
    folded["dec_w4"] = sd["decoder.9.weight"].clone()
    folded["dec_b4"] = sd["decoder.9.bias"].clone()
    return folded


def cae_fast_mse(
    folded: dict,
    feats: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    swap_tf: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Normalize -> folded encoder and decoder -> per-sample MSE: the CAE
    leg of the hybrid submission path (reference
    ``src/predict_hybrid.py:66-78``); (B,) float32 MSE over (T, F).

    The normalization and the MSE's target stay in f32 from the raw
    input; only the convolutions run in ``compute_dtype``. The floor-mode
    2 x 2 pools and the decoder's ``output_padding`` replay
    :class:`~dfac_tpu_torch.models.cae.ConvAutoencoder`'s shape rule."""
    dt = compute_dtype
    x = feats.transpose(1, 2) if swap_tf else feats  # (B, T, F)
    check_geometry(x.shape[1], x.shape[2], "cae_fast_mse")
    x = (x.float() - mean) / std
    h = x.unsqueeze(1).to(dt)
    t_sizes, f_sizes = [], []
    with f32_convs():
        for i in (1, 2, 3, 4):
            y = F.conv2d(h, folded[f"enc_w{i}"].to(dt), padding=1)
            h = torch.relu(y.float() + folded[f"enc_b{i}"][:, None, None]).to(dt)
            t_sizes.append(h.shape[2])
            f_sizes.append(h.shape[3])
            h = F.avg_pool2d(h, 2)
        for i, pad in enumerate(zip(*decoder_output_paddings(t_sizes, f_sizes)), 1):
            # no bias in the conv: an output_padding row stays 0 and gets the bias alone below
            y = F.conv_transpose2d(h, folded[f"dec_w{i}"].to(dt), stride=2, output_padding=pad)
            h = y.float() + folded[f"dec_b{i}"][:, None, None]
            h = (torch.relu(h) if i < 4 else h).to(dt)
    recon = fit_time(h, x.shape[1])[:, 0].float()
    return torch.mean(torch.square(recon - x), dim=(1, 2))


def cae_mse_scores_fast(
    state_dict: dict,
    ds,
    normalizer,
    device: torch.device,
    batch_size: int = 128,
    swap_tf: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    stats=None,
) -> np.ndarray:
    """Per-utterance CAE MSE through the folded chain on ``device`` (the
    fast counterpart of :func:`dfac_tpu_torch.train.cae_loop.cae_mse_scores`);
    (N,) float32 in dataset order. ``normalizer`` is a fitted
    :class:`~dfac_tpu_torch.data.normalizer.FeatureNormalizer`; ``stats``
    as :func:`predict_scores_fast`'s.

    The upload is f32, not :func:`ingest`'s ``compute_dtype`` cast: the
    chain forms its MSE target from the raw input in f32, and a bf16
    upload would shift every score."""
    from dfac_tpu_torch.train.evaluate import collect_masked_scores

    folded = on_device(fold_cae(state_dict), device, compute_dtype)
    mean = torch.as_tensor(normalizer.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(normalizer.std, dtype=torch.float32, device=device)
    with torch.inference_mode():
        return collect_masked_scores(
            lambda feats: cae_fast_mse(folded, feats, mean, std, swap_tf, compute_dtype),
            ds, batch_size,
            prepare_batch=lambda b: ingest(b.features, torch.float32, device),
            stats=stats,
        )


def fold_detector(state_dict: dict) -> dict:
    """Fold the detector's three BatchNorm1d into its encoder convs
    (reference eval chain ``src/dlqueen_model.py:131-173``): ``{w1..w3 (O,
    I, k), b1..b3, fc1_w (2H, H), fc1_b, fc2_w (H, 1), fc2_b}`` as f32
    tensors. ``state_dict`` holds the eval variables (the EMA parameters
    where the trainer kept an EMA)."""
    sd = _f32(state_dict)
    folded = {}
    for i, (ci, bi) in enumerate([(0, 1), (4, 5), (8, 9)], 1):
        folded[f"w{i}"], folded[f"b{i}"] = _fold_bn(sd, f"enc.net.{ci}", f"enc.net.{bi}", 0)
    for j, li in ((1, 0), (2, 3)):
        folded[f"fc{j}_w"] = sd[f"head.{li}.weight"].t().contiguous()
        folded[f"fc{j}_b"] = sd[f"head.{li}.bias"].clone()
    return folded


def detector_fast_scores(
    folded: dict,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    swap_tf: bool = True,
    apply_sigmoid: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The detector's serving chain with BN folded: features -> (B,)
    logits (or sigmoid scores), i.e. ``DeepfakeDetector`` in eval mode:
    conv -> folded bias -> exact GELU x3, the masked mean and std over
    time, fc1 -> GELU -> fc2. ``swap_tf=True`` means ``feats`` is
    stored-orientation (B, C, T), ``F.conv1d``'s own layout. The convs run
    in ``compute_dtype`` with f32 bias and GELU; the pool and the head's
    GELU run in f32, as the JAX chain does."""
    from dfac_tpu_torch.models.detector import stats_pool

    dt = compute_dtype
    h = (feats if swap_tf else feats.transpose(1, 2)).to(dt)  # (B, C, T)
    with f32_convs():
        for i in (1, 2, 3):
            w = folded[f"w{i}"].to(dt)
            y = F.conv1d(h, w, padding=w.shape[2] // 2)
            h = F.gelu(y.float() + folded[f"b{i}"][:, None]).to(dt)
    z = stats_pool(h.float().transpose(1, 2), lengths)  # (B, 2H), f32
    z = F.gelu((z.to(dt) @ folded["fc1_w"].to(dt)).float() + folded["fc1_b"])
    logits = (z.to(dt) @ folded["fc2_w"].to(dt)).float()[:, 0] + folded["fc2_b"]
    return torch.sigmoid(logits) if apply_sigmoid else logits


def detector_scores_fast(
    state_dict: dict,
    ds,
    lengths: np.ndarray,
    device: torch.device,
    batch_size: int = 128,
    swap_tf: bool = True,
    apply_sigmoid: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> np.ndarray:
    """Score a whole dataset through the folded detector chain on
    ``device``; (N,) float32 in dataset order (the fast counterpart of
    :func:`dfac_tpu_torch.train.detector_loop.detector_scores`; batching
    and ingest as :func:`predict_scores_fast`). Pad rows borrow row 0's
    length; the weight mask drops their scores."""
    from dfac_tpu_torch.train.evaluate import collect_masked_scores

    folded = on_device(fold_detector(state_dict), device, compute_dtype)
    lengths = np.asarray(lengths)

    def prepare(b):
        lens = lengths[np.maximum(b.index, 0)]
        return ingest(b.features, compute_dtype, device), torch.from_numpy(lens).to(device)

    with torch.inference_mode():
        return collect_masked_scores(
            lambda fl: detector_fast_scores(folded, fl[0], fl[1], swap_tf, apply_sigmoid, compute_dtype),
            ds, batch_size, prepare_batch=prepare,
        )
