"""Batched scoring over a corpus (the serving half of :mod:`dfac_tpu.train.evaluate`)."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from dfac_tpu_torch.data.pipeline import ArrayDataset, batch_iterator
from dfac_tpu_torch.io.prefetch import prefetched


def collect_masked_scores(
    score_batch: Callable,
    ds: ArrayDataset,
    batch_size: int,
    prepare_batch: Callable | None = None,
    stats=None,
) -> np.ndarray:
    """Run ``score_batch(batch) -> (B,) device scores`` over every padded
    batch, keep the results on the device, then fetch them in ONE
    synchronising copy and drop the pad rows by the weight mask.

    ``prepare_batch`` (optional) is the host stage of ingest (cast, pinned
    staging, ``non_blocking`` upload); it runs in a background thread
    (:func:`~dfac_tpu_torch.io.prefetch.prefetched`, two batches ahead),
    so batch k+1 is assembled while batch k is scored. ``stats`` (optional
    :class:`~dfac_tpu_torch.io.prefetch.PrefetchStats`) records host-wait
    vs device-wait time; the final fetch's drain counts as device wait."""

    def produce():
        for batch in batch_iterator(ds, batch_size):
            prepared = prepare_batch(batch) if prepare_batch is not None else batch
            yield prepared, batch.weights > 0

    chunks, masks = [], []
    for prepared, mask in prefetched(produce(), depth=2, stats=stats):
        chunks.append(score_batch(prepared))
        masks.append(mask)
    if not chunks:
        return np.zeros((0,), np.float32)
    keep = np.concatenate(masks)
    t0 = time.perf_counter()
    out = torch.cat(chunks).float().cpu().numpy()[keep]
    if stats is not None:
        stats.device_wait_s += time.perf_counter() - t0
    return out
