"""``--fused-fit``: a whole training run over a device-resident corpus.

Counterpart of :mod:`dfac_tpu.train.fused_fit` and of the CAE's and the
detector's fused programs (``make_fused_cae_fit``,
``make_fused_detector_fit``). The JAX package compiles a run into one
program, a ``lax.scan`` over epochs with ``lax.cond`` making stopped epochs
no-ops, because a TPU host round trip per epoch costs a dispatch of the
whole step program. On the card the host already launches each step, and
the per-epoch resident trainer reads the device once an epoch (the loss
sum and the dev metrics) while the next epoch has nothing queued yet; that
read costs at most the refill of an empty launch queue (on an H100 a run
that kept its decisions on the device showed no resolved gain over it,
``PERF.md`` §6). So a fused run is the trainer's own ``fit`` with
``device_resident`` on and the live display off (:func:`fused_run`): the
same epochs, best rule, plateau, early stop and freeze tail, by
construction. Each trainer's ``fit_fused`` adds what the
JAX fused entry point does besides: the freeze tail's ``TypeError`` for a
model without one is raised before the first epoch (the JAX program traces
its frozen epoch body up front), and the supervised trainer's run writes
no checkpoint (its CLI writes the best and last at the end).

Under ``multihost`` a fused run is the multi-host resident ``fit``: every
rank holds the whole corpus and gathers its rows of each batch on the card
(JAX's GSPMD fused program over a replicated corpus); the single-process
data-parallel trainer stays refused, as in JAX.

Designed differences from the JAX package (``ROADMAP.md`` §3.3): the JAX
fused CNN2D and CAE runs shuffle on the device with
``jax.random.permutation``; the port's walk the host order, as its resident
epochs do, so a fused run is held to the JAX host-fed ``fit``. The JAX best
rule compares ``eer_counts``' first exact minimum; the port compares
``calculate_eer``'s pick (§3.4).
"""

from __future__ import annotations

import contextlib
import dataclasses

from dfac_tpu_torch.models.common import frozen_batchnorm
from dfac_tpu_torch.obs.noop import NoOpVisualizer


# the JAX fused entry points' refusals, by trainer class: a multi-host trainer without device_resident
# (``dfac_tpu/train/fused_fit.py:285-289``, ``cae_loop.py:987-992``, ``detector_loop.py:816-821``) and a
# single-process data-parallel run (``fused_fit.py:290-298``, ``cae_loop.py:994-1000``, ``detector_loop.py:822-828``)
MULTIHOST_NEEDS_RESIDENT = {
    "Trainer": (
        "multihost fused fit requires device_resident=True in TrainConfig "
        "(the trainer then builds the GSPMD model/step; dfac-train's "
        "--fused-fit flag sets it automatically)"
    ),
    "CAETrainer": (
        "multihost fused CAE fit requires device_resident=True in "
        "CAEConfig (the trainer then builds the GSPMD model; "
        "dfac-train-cae's --fused-fit flag sets it automatically)"
    ),
    "DetectorTrainer": (
        "multihost fused detector fit requires device_resident=True "
        "in DetectorConfig (the trainer then builds the GSPMD model; "
        "the train_detector CLI's --fused-fit flag sets it)"
    ),
}
DATA_PARALLEL_REFUSALS = {
    "Trainer": (
        "fit_fused with data_parallel is the MULTIHOST GSPMD path "
        "(--multihost --fused-fit): the single-process trainer's "
        "shard_map-DP model syncs BatchNorm with an axis_name that is "
        "unbound outside shard_map. For single-process multi-chip fused "
        "training drop data_parallel (or see "
        "__graft_entry__.dryrun_multichip for the raw GSPMD program)"
    ),
    "CAETrainer": (
        "fit_fused with data_parallel is the MULTIHOST GSPMD path "
        "(--multihost --fused-fit); for single-process multi-chip "
        "CAE training use fit() with data_parallel (the shard_map "
        "DP step)"
    ),
    "DetectorTrainer": (
        "fit_fused with data_parallel is the MULTIHOST GSPMD path "
        "(--multihost --fused-fit); for single-process multi-chip "
        "detector training use fit() with data_parallel (the "
        "shard_map DP step)"
    ),
}


def check_fused(trainer) -> None:
    """Raise the JAX package's ``ValueError`` for a fused fit it refuses: a
    multi-host trainer without ``device_resident``, a single-process
    data-parallel one. (JAX's third refusal, an eval batch that does not
    divide over the devices, ``fused_fit.py:327-331``, cannot arise here:
    the port evaluates on rank 0 at ``batch_size``, which the config
    already requires to divide.)"""
    cfg, name = trainer.cfg, type(trainer).__name__
    if cfg.multihost and not cfg.device_resident:
        raise ValueError(MULTIHOST_NEEDS_RESIDENT[name])
    if trainer.ranks is not None and not cfg.multihost:
        raise ValueError(DATA_PARALLEL_REFUSALS[name])


@contextlib.contextmanager
def fused_run(trainer):
    """``trainer`` (a built model) as a fused run sees it: its config with
    ``device_resident`` on and, where it has one, a :class:`NoOpVisualizer`;
    both restored on exit. Raises
    :func:`~dfac_tpu_torch.models.common.frozen_batchnorm`'s ``TypeError``
    up front where a freeze tail is asked of a model without one, and the
    config's ``ValueError`` where it streams chunks."""
    cfg = trainer.cfg
    if cfg.bn_freeze_after_frac:
        with frozen_batchnorm(trainer.model):
            pass
    visualizer = getattr(trainer, "visualizer", None)
    trainer.cfg = dataclasses.replace(cfg, device_resident=True)
    if visualizer is not None:
        trainer.visualizer = NoOpVisualizer()
    try:
        yield
    finally:
        trainer.cfg = cfg
        if visualizer is not None:
            trainer.visualizer = visualizer
