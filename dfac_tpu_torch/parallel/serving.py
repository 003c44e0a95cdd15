"""Sharded serving: the scoring chains over the ranks of a process group.

Counterpart of :mod:`dfac_tpu.parallel.serving`. The JAX package
``shard_map``s each per-batch scorer over the mesh's ``'data'`` axis; here
each rank is a process (:mod:`~dfac_tpu_torch.parallel.data_parallel`,
:mod:`~dfac_tpu_torch.parallel.multihost`) and scores its rows ``[r * B /
N, (r + 1) * B / N)`` of each global batch (:func:`rank_rows`) through the
port's single-device chain. A row's score depends on that row alone, so a
sharded scorer gives the single-device chain's scores; no collective runs
in the forward.

Every scorer takes this rank's rows and returns this rank's results, as a
``shard_map`` body returns its shard:
:func:`~dfac_tpu_torch.parallel.multihost.gather_rows` puts every rank's
results back in corpus order. Two routes, as in JAX:

* **fast** (CNN2D, the production chain): the waveform scorers run K1
  (:func:`~dfac_tpu_torch.ops.gemm_frontend.gemm_lfcc_features_tf`,
  ``frontend="gemm"``; ``"fft"`` is the plain rFFT composition) and the
  three K2 blocks (:func:`~dfac_tpu_torch.models.fast_infer.cnn2d_fast_scores_tf`);
  the feature scorer runs K2 (or the folded CNN1D chain), after the int8
  dequantize with ``ingest_int8``; the hybrid scorer runs the K2 bf16 leg
  (or CNN1D's) and the CAE's :func:`~dfac_tpu_torch.models.fast_infer.cae_fast_mse`;
* **the eval model** (any model of the registry): the e2e scorers.

The corpus forms take the rank's rows of every batch, ``(n_batches, B /
N, samples)``, and loop over the batches on the rank: a torch program has
no one-dispatch scan to copy, and the outputs are the same.

:func:`predict_scores_sharded` and :func:`hybrid_scores_sharded` are the
``predict`` and ``predict_hybrid`` CLIs' rank-level corpus loops: each rank
reads, casts or quantizes and uploads only its rows of every padded batch
(a memory-mapped store pages in only those rows), and the scores are
gathered on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from dfac_tpu_torch.features.lfcc import LFCCConfig, lfcc_features
from dfac_tpu_torch.models import fast_infer as fi
from dfac_tpu_torch.models.common import f32_convs
from dfac_tpu_torch.parallel.multihost import gather_rows, local_row_range
from dfac_tpu_torch.train.evaluate import collect_masked_scores

FOLDED_MODELS = ("cnn2d", "cnn1d")


def rank_rows(x, ranks, axis: int = 0):
    """This rank's rows of a global batch (a numpy array or a tensor), along ``axis``."""
    lo, hi = local_row_range(ranks.world, ranks.rank, x.shape[axis])
    return x[(slice(None),) * axis + (slice(lo, hi),)]


def _features_tf(waves: torch.Tensor, cfg: LFCCConfig, frontend: str, compute_dtype=torch.float32):
    """(B, samples) waveforms -> (B, T, 180) features: K1 (``gemm``) or the plain rFFT composition (``fft``)."""
    if frontend == "gemm":
        from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_features_tf

        return gemm_lfcc_features_tf(waves, cfg, compute_dtype=compute_dtype)
    if frontend != "fft":
        raise ValueError(f"frontend must be 'gemm' or 'fft', got {frontend!r}")
    return lfcc_features(waves, cfg).transpose(-1, -2)


def _corpus(score_batch):
    """The corpus form of a per-batch scorer: ``(consts..., corpus (n_batches, rows, ...))``
    -> this rank's scores of every batch in turn, ``(n_batches * rows,)``."""

    def score(*args):
        *consts, corpus = args
        return torch.cat([score_batch(*consts, batch) for batch in corpus])

    return score


def make_sharded_fast_scorer(cfg: LFCCConfig = LFCCConfig(), frontend: str = "gemm", apply_sigmoid: bool = True,
                             compute_dtype: torch.dtype = torch.bfloat16):
    """``(folded, waves (rows, samples)) -> (rows,)`` scores through the
    folded chain: K1, then K2's three blocks. ``folded`` comes from
    :func:`~dfac_tpu_torch.models.fast_infer.fold_cnn2d`, on the waves' device."""

    @torch.inference_mode()
    def score(folded, waves):
        feats_tf = _features_tf(waves, cfg, frontend, compute_dtype)
        return fi.cnn2d_fast_scores_tf(folded, feats_tf, apply_sigmoid, compute_dtype)

    return score


def make_sharded_fast_corpus_scorer(cfg: LFCCConfig = LFCCConfig(), frontend: str = "gemm",
                                    apply_sigmoid: bool = True, compute_dtype: torch.dtype = torch.bfloat16):
    """The corpus form of :func:`make_sharded_fast_scorer`: ``(folded,
    waves (n_batches, rows, samples)) -> (n_batches * rows,)``."""
    return _corpus(make_sharded_fast_scorer(cfg, frontend, apply_sigmoid, compute_dtype))


def make_sharded_e2e_scorer(model: torch.nn.Module, cfg: LFCCConfig = LFCCConfig(), frontend: str = "gemm",
                            apply_sigmoid: bool = True):
    """``waves (rows, samples) -> (rows,)`` scores through the front-end
    (f32) and ``model`` in eval mode (any model of the registry, on the
    waves' device; convs in full f32)."""

    @torch.inference_mode()
    def score(waves):
        model.eval()
        with f32_convs():
            out = model(_features_tf(waves, cfg, frontend).contiguous())
        logits = (out[0] if isinstance(out, tuple) else out).reshape(-1)
        return torch.sigmoid(logits) if apply_sigmoid else logits

    return score


def make_sharded_corpus_scorer(model: torch.nn.Module, cfg: LFCCConfig = LFCCConfig(), frontend: str = "gemm",
                               apply_sigmoid: bool = True):
    """The corpus form of :func:`make_sharded_e2e_scorer`: ``waves
    (n_batches, rows, samples) -> (n_batches * rows,)``."""
    return _corpus(make_sharded_e2e_scorer(model, cfg, frontend, apply_sigmoid))


def _check_model(model: str, what: str) -> None:
    if model not in FOLDED_MODELS:
        # a typo must not fall through to the cnn2d branch and feed cnn1d kernels to the 2-D chain
        raise ValueError(f"no folded {what} for model {model!r} (cnn2d | cnn1d)")


def _supervised(model: str, swap_tf: bool, apply_sigmoid: bool, compute_dtype):
    """The folded supervised chain ``(folded, feats) -> (rows,)``: CNN2D through K2, or CNN1D."""
    if model == "cnn1d":
        return lambda folded, feats: fi.cnn1d_fast_scores(folded, feats, swap_tf, apply_sigmoid, compute_dtype)
    chain = fi.cnn2d_fast_scores if swap_tf else fi.cnn2d_fast_scores_tf
    return lambda folded, feats: chain(folded, feats, apply_sigmoid, compute_dtype)


def make_sharded_hybrid_scorer(swap_tf: bool = True, apply_sigmoid: bool = True,
                               compute_dtype: torch.dtype = torch.bfloat16, model: str = "cnn2d"):
    """Both submission legs from one feature tensor: ``(folded_sup,
    folded_cae, mean, std, feats (rows, F, T)) -> ((rows,) supervised
    scores, (rows,) CAE MSE)``; the fusion stays on the host, over the
    gathered corpus (it needs corpus-wide extrema)."""
    _check_model(model, "hybrid scorer")
    supervised = _supervised(model, swap_tf, apply_sigmoid, compute_dtype)

    @torch.inference_mode()
    def score(folded_sup, folded_cae, mean, std, feats):
        return supervised(folded_sup, feats), fi.cae_fast_mse(folded_cae, feats, mean, std, swap_tf, compute_dtype)

    return score


def make_sharded_cnn2d_feature_scorer(swap_tf: bool = True, apply_sigmoid: bool = True,
                                      compute_dtype: torch.dtype = torch.bfloat16, model: str = "cnn2d",
                                      ingest_int8: bool = False):
    """The ``predict --fast`` chain over precomputed features: ``(folded,
    feats (rows, F, T), or (rows, T, F) with swap_tf=False) -> (rows,)``,
    for cnn2d (K2) or cnn1d folded weights. With ``ingest_int8`` it takes
    ``(folded, q, scales)`` of :func:`dfac_tpu_torch.io.fastcast.quant_i8`
    and dequantizes on the device."""
    _check_model(model, "sharded scorer")
    if ingest_int8:
        q8 = fi.cnn1d_fast_scores_q8 if model == "cnn1d" else fi.cnn2d_fast_scores_q8
        return torch.inference_mode()(
            lambda folded, q, scales: q8(folded, q, scales, swap_tf, apply_sigmoid, compute_dtype))
    return torch.inference_mode()(_supervised(model, swap_tf, apply_sigmoid, compute_dtype))


def folded_on(state_dict: dict, model: str, device: torch.device, compute_dtype) -> dict:
    """The folded weights the fast chains take, on ``device`` (as
    :func:`~dfac_tpu_torch.models.fast_infer.predict_scores_fast` and its
    CNN1D counterpart place them)."""
    if model == "cnn1d":
        return fi.on_device(fi.fold_cnn1d(state_dict), device, compute_dtype)
    return {k: v.to(device) for k, v in fi.fold_cnn2d(state_dict).items()}


def _rank_feed(ranks, batch_size: int):
    """``(lo, hi, gather)``: this rank's rows of each padded batch and the gather of its results."""
    lo, hi = local_row_range(ranks.world, ranks.rank, batch_size)
    return lo, hi, lambda t: gather_rows(t, ranks, hi - lo)


def predict_scores_sharded(state_dict: dict, ds, device: torch.device, ranks, batch_size: int = 128,
                           swap_tf: bool = True, apply_sigmoid: bool = True,
                           compute_dtype: torch.dtype = torch.bfloat16, model: str = "cnn2d",
                           ingest_int8: bool = False, stats=None) -> np.ndarray:
    """``predict --fast --data-parallel N`` / ``--multihost`` on one rank:
    the corpus's (N,) scores, on every rank. The rank uploads its rows of
    each padded batch, cast to ``compute_dtype`` on the host, or quantized
    there with ``ingest_int8``."""
    lo, hi, gather = _rank_feed(ranks, batch_size)
    folded = folded_on(state_dict, model, device, compute_dtype)
    scorer = make_sharded_cnn2d_feature_scorer(swap_tf, apply_sigmoid, compute_dtype, model, ingest_int8)
    if ingest_int8:
        run, prepare = (lambda qs: scorer(folded, *qs)), (lambda b: fi.ingest_q8(b.features[lo:hi], device))
    else:
        run, prepare = (lambda f: scorer(folded, f)), (lambda b: fi.ingest(b.features[lo:hi], compute_dtype, device))
    return collect_masked_scores(run, ds, batch_size, prepare_batch=prepare, stats=stats, gather=gather)


def hybrid_scores_sharded(sup_state: dict, cae_state: dict, normalizer, ds, device: torch.device, ranks,
                          batch_size: int = 128, model: str = "cnn2d", stats=None) -> tuple[np.ndarray, np.ndarray]:
    """``predict_hybrid --fast --data-parallel N`` / ``--multihost`` on one
    rank: the corpus's supervised scores and CAE MSE, both legs in bf16, on
    every rank. The upload is f32, not a bf16 cast: both legs read the one
    tensor, and the CAE forms its MSE target from the raw input in f32."""
    dt = torch.bfloat16
    lo, hi, gather = _rank_feed(ranks, batch_size)
    folded_sup = folded_on(sup_state, model, device, dt)
    folded_cae = fi.on_device(fi.fold_cae(cae_state), device, dt)
    mean, std = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (normalizer.mean, normalizer.std))
    scorer = make_sharded_hybrid_scorer(model=model)
    return collect_masked_scores(
        lambda f: scorer(folded_sup, folded_cae, mean, std, f), ds, batch_size,
        prepare_batch=lambda b: fi.ingest(b.features[lo:hi], torch.float32, device),
        stats=stats, n_outputs=2, gather=gather,
    )
