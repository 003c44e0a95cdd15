"""Batched scoring and evaluation over a corpus.

Counterpart of :mod:`dfac_tpu.train.evaluate` (parity target reference
``src/evaluation.py:51-104``): run a classifier over a labeled split and
return ``{avg_loss, eer, threshold}`` with the raw scores and labels.
Scores and the loss sum stay on the device until one fetch at the end;
the EER's sort and crossing search run there too
(:func:`dfac_tpu_torch.ops.eer.eer_device`), with the two final
divisions on the host in float64.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.data.pipeline import ArrayDataset, batch_iterator
from dfac_tpu_torch.io.prefetch import prefetched
from dfac_tpu_torch.models.common import f32_convs
from dfac_tpu_torch.obs.profiling import close_span, maybe_open
from dfac_tpu_torch.ops.eer import eer_device
from dfac_tpu_torch.train.optim import smooth_labels


def collect_masked_scores(
    score_batch: Callable,
    ds: ArrayDataset,
    batch_size: int,
    prepare_batch: Callable | None = None,
    stats=None,
    n_outputs: int = 1,
    gather: Callable | None = None,
    span=None,
):
    """Run ``score_batch(batch) -> (B,) device scores`` over every padded
    batch, keep the results on the device, then fetch them in ONE
    synchronising copy and drop the pad rows by the weight mask.

    ``prepare_batch`` (optional) is the host stage of ingest (cast, pinned
    staging, ``non_blocking`` upload); it runs in a background thread
    (:func:`~dfac_tpu_torch.io.prefetch.prefetched`, two batches ahead),
    so batch k+1 is assembled while batch k is scored. ``stats`` (optional
    :class:`~dfac_tpu_torch.io.prefetch.PrefetchStats`) records host-wait
    vs device-wait time; the final fetch's drain counts as device wait.

    With ``n_outputs > 1`` the scorer returns a tuple of per-row tensors
    (the hybrid scorer's supervised scores and CAE MSE) and the result is
    the tuple of masked concatenations. ``gather`` (optional) turns the
    concatenated device scores into the host array (default: a copy); a
    sharded caller, whose scorer returns this rank's rows of every batch,
    passes :func:`~dfac_tpu_torch.parallel.multihost.gather_rows`, which
    puts every rank's rows back in corpus order.

    While a ``torch.profiler`` session collects, the fetch is a
    ``score.fetch`` span (:mod:`dfac_tpu_torch.obs.profiling`); ``span``
    (optional, the caller's open span) gets the call's ``rows`` and
    ``rows_padded``. The launches get no span of their own: on the card
    one around each ``score_batch`` left the device idle longer there."""
    to_host = gather if gather is not None else (lambda t: t.cpu().numpy())

    def produce():
        for batch in batch_iterator(ds, batch_size):
            prepared = prepare_batch(batch) if prepare_batch is not None else batch
            yield prepared, batch.weights > 0

    chunks, masks = [], []
    for prepared, mask in prefetched(produce(), depth=2, stats=stats):
        out = score_batch(prepared)
        chunks.append(out if n_outputs > 1 else (out,))
        masks.append(mask)
    if not chunks:
        empty = np.zeros((0,), np.float32)
        return empty if n_outputs == 1 else (empty,) * n_outputs
    keep = np.concatenate(masks)
    t0 = time.perf_counter()
    sp = maybe_open("score.fetch")
    out = tuple(to_host(torch.cat([c[i] for c in chunks]).float())[keep] for i in range(n_outputs))
    close_span(sp)
    if stats is not None:
        stats.device_wait_s += time.perf_counter() - t0
    if span is not None:
        rows = int(keep.sum())
        span.counts.update(rows=rows, rows_padded=len(keep) - rows)
    return out if n_outputs > 1 else out[0]


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def eval_step(model, feats, labels, swap_tf: bool, apply_sigmoid: bool, label_smoothing: float):
    """One eval-mode batch: ``(scores, per-row BCE)``, both (B,) on the
    device. ``feats`` is stored-orientation (B, F, T) with ``swap_tf``."""
    x = feats.transpose(1, 2).contiguous() if swap_tf else feats
    logits = model(x).reshape(-1)
    per = F.binary_cross_entropy_with_logits(logits, smooth_labels(labels, label_smoothing), reduction="none")
    return (torch.sigmoid(logits) if apply_sigmoid else logits), per


def _uploads(features, batch_size: int, device: torch.device):
    """Device batches of ``features``: slices of a tensor already on the
    device, or f32 uploads of a numpy corpus made in a prefetch thread."""
    from dfac_tpu_torch.models.fast_infer import ingest

    n = len(features)
    if isinstance(features, torch.Tensor):
        return (features[s : s + batch_size] for s in range(0, n, batch_size))
    return prefetched(
        (ingest(features[s : s + batch_size], torch.float32, device) for s in range(0, n, batch_size)), depth=2
    )


def evaluate_classifier(
    model: torch.nn.Module,
    ds: ArrayDataset,
    batch_size: int = 128,
    swap_tf: bool = True,
    apply_sigmoid: bool = False,
    label_smoothing: float = 0.0,
    with_loss: bool = True,
    features: torch.Tensor | None = None,
) -> tuple[dict, np.ndarray, np.ndarray]:
    """Returns ``(metrics, scores, labels)`` like the reference ``evaluate``.

    Runs in eval mode on the model's device, convs in full f32 (BatchNorm
    on its running statistics, so a batch's rows are independent and the
    tail runs at its true size). ``features`` (optional) is ``ds.features`` already on that
    device: the trainer's resident path uploads the dev split once. While a
    ``torch.profiler`` session collects, the EER, the loss's fetch and the
    scores' copy to the host are an ``eval.fetch`` span."""
    if ds.labels is None:
        raise ValueError("evaluate_classifier needs a labeled dataset")
    device = model_device(model)
    was_training = model.training
    model.eval()
    labels = torch.as_tensor(np.asarray(ds.labels), device=device)
    labels_f = labels.float()
    chunks, loss_sum = [], torch.zeros((), device=device)
    with torch.inference_mode(), f32_convs():
        src = features if features is not None else ds.features
        for start, feats in zip(range(0, len(ds), batch_size), _uploads(src, batch_size, device)):
            scores, per = eval_step(model, feats, labels_f[start : start + batch_size], swap_tf, apply_sigmoid,
                                    label_smoothing)
            chunks.append(scores)
            loss_sum += per.sum()
        scores = torch.cat(chunks) if chunks else torch.zeros(0, device=device)
        sp = maybe_open("eval.fetch")
        eer, threshold = eer_device(scores, labels) if len(scores) else (None, None)
        loss_sum = float(loss_sum)
        scores = scores.cpu().numpy()
        close_span(sp)
    model.train(was_training)
    n = len(ds)
    metrics = {
        "avg_loss": loss_sum / n if (with_loss and n) else None,
        "eer": eer,
        "threshold": threshold,
    }
    return metrics, scores, np.asarray(ds.labels)


def predict_scores(
    model: torch.nn.Module,
    ds: ArrayDataset,
    batch_size: int = 128,
    swap_tf: bool = True,
    apply_sigmoid: bool = False,
    stats=None,
    ranks=None,
) -> np.ndarray:
    """Score every utterance with the eval model on its device (convs in
    full f32); (N,) float32 in dataset order (:func:`collect_masked_scores`: padded
    batches, f32 uploads from pinned memory in a prefetch thread, one
    fetch at the end).

    With ``ranks`` (a :class:`~dfac_tpu_torch.parallel.data_parallel.Ranks`;
    the JAX package's ``mesh``) each rank uploads and scores its rows of
    every batch, and the scores are gathered on every rank; ``batch_size``
    must divide over the ranks."""
    from dfac_tpu_torch.models.fast_infer import ingest

    device = model_device(model)
    lo, hi, gather = 0, batch_size, None
    if ranks is not None:
        from dfac_tpu_torch.parallel.multihost import gather_rows, local_row_range

        lo, hi = local_row_range(ranks.world, ranks.rank, batch_size)
        gather = lambda t: gather_rows(t, ranks, hi - lo)  # noqa: E731
    was_training = model.training
    model.eval()
    zeros = torch.zeros(hi - lo, device=device)
    with torch.inference_mode(), f32_convs():
        scores = collect_masked_scores(
            lambda feats: eval_step(model, feats, zeros[: len(feats)], swap_tf, apply_sigmoid, 0.0)[0],
            ds, batch_size,
            prepare_batch=lambda b: ingest(b.features[lo:hi], torch.float32, device),
            stats=stats, gather=gather,
        )
    model.train(was_training)
    return scores
