"""Serving-chain throughput on the card: the helpers ``chip_smoke.py``
phases 14 and 16 time their chains with.

Two CNN2D chains, each over a CNN2D folded for the fused path
(:func:`random_cnn2d` makes one from a seed):

* :func:`slice_runner`: waveforms -> K1 in bf16 -> delta and delta-delta
  -> three K2 blocks in bf16 -> scores;
* :func:`f32_runner`: feature tensors (frames x features) ->
  three K2 blocks in f32 -> scores, the chain ``predict --fast`` runs by
  default (without ``--bf16``);

and :func:`runner` for any chain given as a function of one batch (phase
16: CNN1D, the CAE scorer, the two hybrid legs).

:func:`rates` runs a chain once to warm up, then ``REPS`` times; a run's
rate is utterances over host seconds ending in ``torch.cuda.synchronize()``.
:func:`summary` gives the median, min and max.
"""

from __future__ import annotations

import statistics
import time

SEED = 0
REPS = 7


def rates(run, n_utts: int, reps: int = REPS) -> list[float]:
    """utt/s of ``reps`` timed runs of ``run`` (which ends in a synchronize), after one warm-up."""
    run()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        out.append(n_utts / (time.perf_counter() - t0))
    return out


def summary(name: str, r: list[float]) -> str:
    return f"{name} {statistics.median(r):.1f} utt/s (median of {len(r)}; min {min(r):.1f}, max {max(r):.1f})"


def slice_runner(folded: dict, waves, cfg):
    """Scores of every batch of ``waves`` (n, B, samples) through the bf16 slice."""
    import torch

    from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores
    from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_features_tf

    def run():
        with torch.inference_mode():
            out = [cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv, cfg, torch.bfloat16)) for wv in waves]
        torch.cuda.synchronize()
        return out

    return run


def f32_runner(folded: dict, feats):
    """Scores of every batch of ``feats`` (n, B, frames, features) through the f32 chain."""
    import torch

    from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores

    def run():
        with torch.inference_mode():
            out = [cnn2d_fused_scores(folded, f, compute_dtype=torch.float32) for f in feats]
        torch.cuda.synchronize()
        return out

    return run


def runner(score, batches):
    """Scores of every batch of ``batches`` through ``score(batch)``; ends
    in a synchronize on a CUDA device."""
    import torch

    def run():
        with torch.inference_mode():
            out = [score(b) for b in batches]
        if batches[0].is_cuda:
            torch.cuda.synchronize()
        return out

    return run


def seed_batchnorm(model, gen):
    """Non-trivial BatchNorm statistics and affine parameters drawn from
    ``gen`` for every BatchNorm of ``model`` (1d and 2d), as :func:`random_cnn2d`."""
    import torch

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.uniform_(-0.2, 0.2, generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.uniform_(-0.1, 0.1, generator=gen)
    return model


def random_cnn2d(cfg, dev, gen):
    """A full-width CNN2D in eval mode, weights from ``SEED``, BatchNorm statistics drawn from ``gen``."""
    import torch

    from dfac_tpu_torch.models import build_model

    torch.manual_seed(SEED)
    model = build_model("cnn2d", in_features=cfg.feature_dim, base_channels=32).to(dev).eval()
    return seed_batchnorm(model, gen)
