"""Supervised training loop (every classifier of the registry, on one device or data-parallel).

Counterpart of :mod:`dfac_tpu.train.loop`; parity target reference
``src/train.py`` (call stack SURVEY.md §3.1). The step — swap,
augmentation, forward in train mode, label-smoothed weighted BCE,
backward, AdamW, BatchNorm running statistics — runs on the device
through autograd (cuDNN convs on CUDA, in full f32 as the JAX package's
``Precision.HIGHEST``: :func:`~dfac_tpu_torch.models.common.f32_convs`);
the host loop orchestrates
batches, evaluation, the best-checkpoint rule, LR plateau scheduling,
early stopping and visualizer events. The JAX package's hand-scheduled
backward (``ops/train_chain.py``) computes the same math and is not
ported.

Reference semantics kept:

* best-checkpoint rule (``src/train.py:484-518``): dev EER strictly lower
  wins; on an EER tie within 1e-4, both train loss and dev loss must
  improve by > 1e-6;
* early stop counts epochs without *EER* improvement only (``:556-561``);
* ReduceLROnPlateau monitors dev_eer or dev_loss (``:520-525``);
* loss averaging weights each batch by its true sample count (``:78-80``);
* the final partial batch trains at its true size, so its BatchNorm
  statistics cover real rows only.

Every feed walks one order, ``np.random.default_rng(seed * 100003 +
epoch).shuffle`` of the row ids, the JAX package's host loop's: host-fed
(a prefetch thread gathers each batch and uploads it from pinned memory),
``device_resident`` (the corpus uploaded once, each batch gathered on the
card) or chunked (``resident_chunk_batches``: chunks of G batches
streamed through pinned memory, compressed with ``chunk_ingest``;
:mod:`~dfac_tpu_torch.train.chunked`). The epoch's loss is summed on the
device and fetched once. :meth:`Trainer.fit_fused` is the resident fit
with no display and no checkpoint (:mod:`~dfac_tpu_torch.train.fused_fit`).
``bn_freeze_after_frac`` trains the epochs after ``round(epochs * frac)``
with BatchNorm frozen (:func:`~dfac_tpu_torch.models.common.frozen_batchnorm`),
in every feed.

``data_parallel`` N > 1 (the JAX package's shard_map step, here one
process per device: :mod:`~dfac_tpu_torch.parallel.data_parallel`) trains on
N ranks: ``batch_size`` is the global batch, each rank feeds its rows of
every batch of the shared order (host-fed or chunked; ``device_resident``
falls back to host-fed, as in JAX), BatchNorm syncs its statistics across
the ranks, the gradients of the global sum are divided once by the global
count, and rank 0 evaluates and broadcasts what the best rule, the
plateau scheduler and early stopping read; only rank 0 displays and writes
checkpoints. A tail that does not divide over the ranks is refused before
the epoch (``check_dp_tail``), and ``fit_fused`` is refused, with the JAX
package's messages. ``multihost`` (the ranks of a cluster of processes,
:mod:`~dfac_tpu_torch.parallel.multihost`) trains the same way; there
``device_resident`` and ``fit_fused`` hold the whole corpus on every rank,
each gathering its rows of every batch of the shared order on the card
(the counterpart of JAX's replicated-corpus GSPMD path, which draws its
permutation on the device instead), and ``--resume`` is read by the
coordinator and broadcast.

Dropout draws (bytes and channel masks) and augmentation draws come from
one ``torch.Generator`` on the device, seeded from ``seed`` (each rank
from ``(seed, rank)``, rank 0 from ``seed``).

The model is built for the width of the model-view input (F with
``swap_tf``, T without) of the first training batch, as the JAX
``Trainer.init_state(example_batch)`` initialises from a sample batch;
``compute_dtype="bfloat16"`` trains the families that take it (CNN2D,
CNN1D, ``cnn1d_variant``) in bf16 with f32 parameters
(:mod:`~dfac_tpu_torch.models.common`), as the JAX package's ``--bf16``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.data.augment import AugmentConfig, build_augment_fn
from dfac_tpu_torch.data.pipeline import ArrayDataset, num_batches
from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.io.prefetch import prefetched
from dfac_tpu_torch.models import MODEL_REGISTRY, build_model, model_width, width_overrides
from dfac_tpu_torch.models.common import f32_convs, frozen_batchnorm, set_batchnorm_group, set_dropout_generator
from dfac_tpu_torch.obs.base import BatchMetrics, EpochMetrics, TrainingConfig, TrainingVisualizer
from dfac_tpu_torch.obs.noop import NoOpVisualizer
from dfac_tpu_torch.obs.profiling import close_span, drop_span, maybe_open
from dfac_tpu_torch.parallel.data_parallel import maybe_ranks, on_rank_zero, rank_seed
from dfac_tpu_torch.train import checkpoint as ckpt_lib
from dfac_tpu_torch.train.chunked import ChunkFeed, check_config, rank_order
from dfac_tpu_torch.train.evaluate import evaluate_classifier
from dfac_tpu_torch.train.optim import PlateauScheduler, build_optimizer, set_lr, smooth_labels
from dfac_tpu_torch.utils.convert import adam_state_from_optax, jax_from_state_dict, state_dict_from_jax

@dataclasses.dataclass
class TrainConfig:
    """The reference train.py flag surface (``src/train.py:94-246``) that
    the port trains: every registry classifier on one device or
    data-parallel (one host or ``multihost``), f32 or
    ``compute_dtype="bfloat16"``, host-fed, resident or chunked, with the
    BatchNorm freeze tail (the JAX package's orbax field is not ported;
    see ROADMAP.md).
    ``in_features`` is the input width of a model built without a sample
    batch."""

    model: str = "cnn2d"
    batch_size: int = 32
    epochs: int = 10
    lr: float = 1e-3
    weight_decay: float = 0.0
    early_stop: int = 0
    lr_scheduler: str = "none"  # none | plateau
    lr_scheduler_metric: str = "dev_eer"  # dev_eer | dev_loss
    lr_scheduler_factor: float = 0.5
    lr_scheduler_patience: int = 2
    lr_scheduler_threshold: float = 1e-4
    lr_scheduler_min_lr: float = 1e-6
    in_features: int = 180
    hidden_dim: int = 128
    dropout: float = 0.2
    seed: int = 0
    label_smoothing: float = 0.0
    swap_tf: bool = True
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    compute_dtype: str | None = None  # None (f32) | "bfloat16"
    device_resident: bool = False  # upload the corpus once; gather batches on the card
    # stream the epoch in chunks of N batches through pinned memory, the
    # upload overlapped with the steps (corpora larger than the card); 0 = off
    resident_chunk_batches: int = 0
    # the chunked upload's compression: f32 (exact) | bf16 (half the bytes,
    # features bf16-rounded) | int8 (a quarter, per-(row, feature-dim)
    # scales, dequantized on the card before the step)
    chunk_ingest: str = "f32"
    # the BatchNorm freeze tail: epochs after round(epochs * frac) train with
    # BatchNorm on its running statistics, which stay as they are; 0 disables
    bn_freeze_after_frac: float = 0.0
    data_parallel: int = 0  # ranks of the process group the trainer runs on (0/1 = one device)
    # the ranks are those of a multi-host cluster (parallel/multihost.py): data_parallel is the
    # global rank count, device_resident keeps the whole corpus on every rank
    multihost: bool = False

    def __post_init__(self):
        if not (0.0 <= self.label_smoothing < 0.5):
            raise ValueError("label_smoothing must be in [0, 0.5)")
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError("compute_dtype must be None (f32) or 'bfloat16'")
        check_data_parallel(self)
        check_config(self, " (the resident and host-loop paths have their own ingest handling)")


def check_data_parallel(cfg, what: str = "training") -> None:
    """The JAX configs' checks of ``data_parallel``: against the global
    batch, and above one rank under ``multihost`` (``what`` names the
    trainer's mode in that message, as each JAX config does)."""
    if cfg.data_parallel > 1 and cfg.batch_size % cfg.data_parallel != 0:
        raise ValueError("batch_size must divide evenly over data_parallel shards")
    if cfg.multihost and cfg.data_parallel <= 1:
        raise ValueError(
            f"multihost {what} is data-parallel over the pod — set data_parallel to the GLOBAL device count"
            + (" (all hosts' chips)" if what == "training" else "")
        )


def mode(cfg, what: str) -> str:
    """``what`` as the JAX trainers name a mode in ``check_dp_tail``'s message, "multihost ..." under ``multihost``."""
    return f"multihost {what}" if cfg.multihost else what


def bn_frozen_at(epoch: int, epochs: int, frac: float) -> bool:
    """True when ``epoch`` trains with frozen BatchNorm under the freeze
    tail: ``epoch > round(epochs * frac)``, Python's ``round`` (half to
    even: 2.5 -> 2), as every JAX trainer and fused program rounds."""
    return bool(frac) and epoch > round(epochs * frac)


def epoch_order(n: int, seed: int) -> np.ndarray:
    """The host loop's row order: ``np.random.default_rng(seed).shuffle`` of ``arange(n)``."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


def resident_batches(arrays, order: torch.Tensor, batch_size: int):
    """True-size batches of the device-resident ``arrays``: each array's
    rows ``order[start:start + batch_size]`` (``order`` on the device),
    gathered on the card."""
    for start in range(0, order.numel(), batch_size):
        idx = order[start : start + batch_size]
        yield tuple(a.index_select(0, idx) for a in arrays)


def resident_arrays(ds: ArrayDataset, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``ds``'s features and labels (zeros where it has none) as f32 on ``device``."""
    labels = ds.labels if ds.labels is not None else np.zeros(len(ds))
    return (torch.as_tensor(np.asarray(ds.features, np.float32), device=device),
            torch.as_tensor(np.asarray(labels, np.float32), device=device))


def shuffled_batches(ds: ArrayDataset, batch_size: int, order: np.ndarray, device: torch.device, resident=None):
    """An epoch's true-size ``(features, labels, weights)`` batches on
    ``device``, the rows ``order`` names (:func:`epoch_order`, or a rank's
    rows of it) ``batch_size`` at a time: gathered on the card from
    ``resident`` (:func:`resident_arrays` of ``ds``), or gathered on the
    host and uploaded (pinned, ``non_blocking``) by the prefetch thread."""
    if resident is not None:
        ones = torch.ones(batch_size, device=device)
        for feats, labels in resident_batches(resident, torch.from_numpy(order).to(device), batch_size):
            yield feats, labels, ones[: len(feats)]
        return
    from dfac_tpu_torch.models.fast_infer import ingest

    labels = ds.labels if ds.labels is not None else np.zeros(len(ds), np.int32)

    def host():
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            yield tuple(ingest(a, torch.float32, device)
                        for a in (ds.features[idx], labels[idx].astype(np.float32), np.ones(len(idx), np.float32)))

    yield from prefetched(host(), depth=2)


def run_epoch(step, batches, device: torch.device, batch_ctx=None) -> float | None:
    """``step(features, labels, weights) -> (loss * count, count)`` over
    ``batches``; the weighted mean loss, or None for no rows. The sums stay
    on the device and are fetched once, unless a live display asks for
    batch updates (a float per step would sync the card every batch).

    While a ``torch.profiler`` session collects, each step is a
    ``train.step`` span (``rows``) from the pull of its batch (a resident
    feed's gather, a host feed's wait) to its last launch, and the closing
    fetch a ``train.fetch`` span."""
    live_ui = batch_ctx is not None and getattr(batch_ctx, "wants_updates", True)
    total_loss = torch.zeros((), device=device)
    total_count = torch.zeros((), device=device)
    sp = maybe_open("train.step")  # opened before the pull
    for i, (feats, labels, weights) in enumerate(batches):
        loss_sum, count = step(feats, labels, weights)
        total_loss += loss_sum
        total_count += count
        if sp is not None:  # no count's allocation without a profiler
            close_span(sp, rows=len(feats))
        if live_ui:
            tc = float(total_count)
            if tc > 0:
                batch_ctx.update_batch(
                    BatchMetrics(batch_idx=i, running_loss=float(total_loss) / tc, batch_size=int(count))
                )
        sp = maybe_open("train.step")
    drop_span(sp)  # the pull that found no batch
    sp = maybe_open("train.fetch")
    tc = float(total_count)
    loss = (float(total_loss) / tc) if tc else None
    close_span(sp)
    return loss


def weighted_step(per: torch.Tensor, weights: torch.Tensor, optimizer: torch.optim.Optimizer, params,
                  ranks=None):
    """Backward of the weighted mean of the per-example losses ``per`` and
    one ``optimizer`` step; returns ``(loss * count, count)`` as device
    scalars. Data-parallel (``ranks``), the batch is this rank's rows
    (weights all ones) and both are the global batch's: backward on the
    local weighted sum, the gradients of ``params`` summed across the ranks
    and divided by the global count
    (:meth:`~dfac_tpu_torch.parallel.data_parallel.Ranks.reduce_grads_`),
    then the step every rank takes alike."""
    optimizer.zero_grad(set_to_none=True)
    if ranks is None:
        count = weights.sum()
        loss = (per * weights).sum() / count.clamp_min(1.0)
        loss.backward()
        optimizer.step()
        return loss.detach() * count, count
    count = float(weights.numel() * ranks.world)
    local_sum = (per * weights).sum()
    local_sum.backward()
    loss_sum = ranks.reduce_grads_(params, local_sum, count)
    optimizer.step()
    return loss_sum, count


def _model_kwargs(cfg: TrainConfig) -> dict:
    """The constructor overrides the JAX trainer passes every family
    (``dfac_tpu/train/loop.py:145-154``); :func:`build_model` keeps those
    the family takes."""
    kw = {**width_overrides(cfg.in_features), "dropout": cfg.dropout, "hidden_dim": cfg.hidden_dim}
    if cfg.compute_dtype:
        kw["compute_dtype"] = getattr(torch, cfg.compute_dtype)
    return kw


class Trainer:
    """Host-side orchestration of the supervised training loop."""

    def __init__(
        self,
        cfg: TrainConfig,
        visualizer: TrainingVisualizer | None = None,
        device=None,
        model: torch.nn.Module | None = None,
        group=None,
    ):
        """``device``: a ``torch.device`` or its name (default ``cuda``, no
        fallback). ``model`` (optional): the module to train in place of
        ``build_model(cfg.model, ...)`` (another width, as in the tests);
        :meth:`init_state` resets or loads its parameters. ``group``: the
        process group of a data-parallel run (the default group where
        ``data_parallel > 1``; a one-rank group runs the data-parallel path
        on one device)."""
        self.cfg = cfg
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.ranks = maybe_ranks(cfg.data_parallel, group)
        main = self.ranks is None or self.ranks.is_main
        self.visualizer = (visualizer if main else None) or NoOpVisualizer()
        self.augment_fn = build_augment_fn(cfg.augment)
        self.scheduler = (
            PlateauScheduler(
                factor=cfg.lr_scheduler_factor,
                patience=cfg.lr_scheduler_patience,
                threshold=cfg.lr_scheduler_threshold,
                min_lr=cfg.lr_scheduler_min_lr,
            )
            if cfg.lr_scheduler == "plateau"
            else None
        )
        # dropout bytes and augmentation draws (one stream on the device; each rank its own)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rank_seed(cfg.seed, self.ranks.rank) if self.ranks else cfg.seed)
        self._module = model
        self.model: torch.nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.history: list[EpochMetrics] = []
        self._lr = cfg.lr
        self._best_state: dict | None = None
        self._resident: tuple | None = None  # (dataset, features, labels) on the device
        self._dev_resident: tuple | None = None  # (dataset, features)
        self.chunk_feed = ChunkFeed(cfg, self.device, __name__, self.ranks)  # resident_chunk_batches' feed

    # -- state ------------------------------------------------------------
    def init_state(self, state_dict: dict | None = None, example_batch=None) -> torch.nn.Module:
        """Build the model with torch's default init drawn from ``seed``
        (the process's global generator is left as it was), or load
        ``state_dict``; then a fresh optimizer. The model's input width is
        ``example_batch``'s (stored-orientation features, (N, F, T)), else
        ``state_dict``'s weights', else ``cfg.in_features``."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            if self._module is None:
                kw = _model_kwargs(cfg)
                if example_batch is not None:
                    kw.update(width_overrides(model_width(np.shape(example_batch), cfg.swap_tf)))
                elif state_dict is not None:
                    kw.update(MODEL_REGISTRY[cfg.model].widths(state_dict))
                model = build_model(cfg.model, **kw)
            else:  # the draws of construction, in construction order
                model = self._module
                for m in model.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters()
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device)
        set_dropout_generator(self.model, self.generator)
        if self.ranks is not None:
            set_batchnorm_group(self.model, self.ranks.group)
        self.optimizer = build_optimizer(cfg.model, self.model.parameters(), self._lr, cfg.weight_decay)
        return self.model

    def variables(self) -> dict:
        """The current ``state_dict`` (parameters and BN running stats)."""
        return self.model.state_dict()

    def best_variables(self) -> dict:
        """The best epoch's ``state_dict``, parameters and BatchNorm
        statistics of that epoch (a copy taken when it was best, by
        :meth:`fit` or :meth:`fit_fused`; the current one before any epoch
        was)."""
        return self._best_state if self._best_state is not None else self.variables()

    def _bn_frozen_at(self, epoch: int) -> bool:
        """True when ``epoch`` trains with frozen BatchNorm (:func:`bn_frozen_at`)."""
        return bn_frozen_at(epoch, self.cfg.epochs, self.cfg.bn_freeze_after_frac)

    def fit_fused(self, train_ds: ArrayDataset, dev_ds: ArrayDataset, resume_from: str | None = None) -> dict:
        """``--fused-fit`` (:mod:`~dfac_tpu_torch.train.fused_fit`): :meth:`fit`
        over the device-resident corpus with no display and no checkpoint
        written, the freeze tail's ``TypeError`` raised before the first
        epoch. Returns :meth:`fit`'s result and ``best_variables``: the
        ``state_dict`` of this run's best epoch, or None where no epoch of
        this run was best (a resumed run's earlier best stands). A
        single-process data-parallel trainer raises the JAX package's
        ``ValueError``; a multi-host one runs the resident fit on every rank."""
        from dfac_tpu_torch.train.fused_fit import check_fused, fused_run

        check_fused(self)
        if self.model is None:
            self.init_state(example_batch=train_ds.features[:1])
        with fused_run(self):
            result = self.fit(train_ds, dev_ds, resume_from=resume_from)
        new_best = any(m.is_best for m in result["history"])
        return {**result, "best_variables": self._best_state if new_best else None}

    # -- step -------------------------------------------------------------
    def train_step(self, feats: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor, frozen: bool = False):
        """One optimizer step on a device batch of stored-orientation
        features (with ``frozen``, BatchNorm on its running statistics);
        returns ``(loss * count, count)`` (:func:`weighted_step`)."""
        cfg = self.cfg
        x = feats.transpose(1, 2) if cfg.swap_tf else feats
        if self.augment_fn is not None:
            x = self.augment_fn(x, self.generator)
        self.model.train()
        with f32_convs(), frozen_batchnorm(self.model, frozen):
            logits = self.model(x.contiguous()).reshape(-1)
            per = F.binary_cross_entropy_with_logits(
                logits, smooth_labels(labels, cfg.label_smoothing), reduction="none"
            )
            return weighted_step(per, weights, self.optimizer, self.model.parameters(), self.ranks)

    def _resident_arrays(self, ds: ArrayDataset):
        if self._resident is None or self._resident[0] is not ds:
            self._resident = (ds, *resident_arrays(ds, self.device))
        return self._resident[1:]

    def train_epoch(self, ds: ArrayDataset, epoch: int, batch_ctx=None) -> float | None:
        """One epoch; its mean loss. While a ``torch.profiler`` session
        collects, a ``train.epoch`` span (``steps``, ``rows``) around
        :func:`run_epoch`'s spans."""
        root = maybe_open("train.epoch", root=True)
        cfg = self.cfg
        frozen = self._bn_frozen_at(epoch)
        chunked = cfg.resident_chunk_batches > 0
        order, bs = rank_order(epoch_order(len(ds), cfg.seed * 100003 + epoch), cfg.batch_size, self.ranks,
                               mode(cfg, "chunked training" if chunked else "training"))
        if chunked:  # the host loop's batches, streamed in chunks
            labels = np.asarray(ds.labels if ds.labels is not None else np.zeros(len(ds)), np.float32)
            ones = torch.ones(bs, device=self.device)
            batches = ((f, l, ones[: len(f)]) for f, l in self.chunk_feed.batches(ds.features, (labels,), order))
        else:
            resident = self._resident_arrays(ds) if self._resident_feed else None
            batches = shuffled_batches(ds, bs, order, self.device, resident)
        loss = run_epoch(lambda *b: self.train_step(*b, frozen=frozen), batches, self.device, batch_ctx)
        close_span(root, steps=-(-len(order) // bs), rows=len(order))
        return loss

    @property
    def _resident_feed(self) -> bool:
        """``device_resident`` on one device or multi-host (every rank holds
        the corpus, as JAX's GSPMD path replicates it); single-process
        data-parallel epochs are host-fed, as in JAX."""
        return self.cfg.device_resident and (self.ranks is None or self.cfg.multihost)

    # -- evaluation -------------------------------------------------------
    def evaluate(self, dev_ds: ArrayDataset) -> dict:
        """The dev split's metrics; while a ``torch.profiler`` session
        collects, an ``eval`` span (``rows``)."""
        root = maybe_open("eval", root=True)
        cfg = self.cfg
        features = None
        if self._resident_feed:
            if self._dev_resident is None or self._dev_resident[0] is not dev_ds:
                self._dev_resident = (
                    dev_ds, torch.as_tensor(np.asarray(dev_ds.features, np.float32), device=self.device)
                )
            features = self._dev_resident[1]
        metrics, _, _ = evaluate_classifier(
            self.model, dev_ds,
            batch_size=cfg.batch_size,
            swap_tf=cfg.swap_tf,
            label_smoothing=cfg.label_smoothing,
            features=features,
        )
        close_span(root, rows=len(dev_ds))
        return metrics

    # -- checkpoints ------------------------------------------------------
    def restore(self, ckpt_path: str) -> dict:
        """Resume from a checkpoint of either package: model, optimizer
        (the port's own state, or a JAX-written file's Adam moments),
        scheduler, epoch and best-tracking counters. Under ``multihost`` the
        coordinator reads the file and broadcasts it to every rank."""
        cfg = self.cfg
        if cfg.multihost:  # the file is on the coordinator's filesystem only
            from dfac_tpu_torch.parallel.multihost import broadcast_pyobj, is_coordinator

            ckpt = broadcast_pyobj(ckpt_lib.load_checkpoint(ckpt_path) if is_coordinator() else None)
        else:
            ckpt = ckpt_lib.load_checkpoint(ckpt_path)
        state_dict = state_dict_from_jax(ckpt["model_state"], cfg.model)
        if self.model is None:
            self.init_state(state_dict)
        else:
            self.model.load_state_dict(state_dict)
        if ckpt.get("torch_optimizer_state") is not None:
            self.optimizer.load_state_dict(ckpt_lib.torch_tree(ckpt["torch_optimizer_state"]))
        elif ckpt.get("optimizer_state") is not None:
            names = [n for n, _ in self.model.named_parameters()]
            opt_sd = self.optimizer.state_dict()
            opt_sd["state"] = adam_state_from_optax(ckpt["optimizer_state"], names, cfg.model)
            self.optimizer.load_state_dict(opt_sd)
        if self.scheduler is not None and ckpt.get("scheduler_state"):
            self.scheduler = PlateauScheduler.from_state_dict(ckpt["scheduler_state"])
        ts = ckpt.get("config", {}).get("_trainer_state", {})
        if ts.get("lr") is not None:
            self._lr = ts["lr"]
            set_lr(self.optimizer, self._lr)
        return {"epoch": ckpt.get("epoch", 0), "trainer_state": ts}

    def save_checkpoint_file(
        self,
        path: str,
        *,
        epoch: int,
        variables: dict | None = None,
        config_snapshot: dict | None = None,
        trainer_state: dict | None = None,
    ) -> None:
        """Write a checkpoint in the JAX package's format with the
        ``_trainer_state`` embedding. With ``variables`` (a best-epoch
        snapshot written after training moved on) the optimizer and
        scheduler states are left out: they belong to the last epoch.
        Resume from ``*_last.ckpt``; ``*_best.ckpt`` is for inference."""
        snapshot = variables is not None
        config = dict(config_snapshot or dataclasses.asdict(self.cfg))
        if trainer_state is not None:
            config["_trainer_state"] = trainer_state
        ckpt_lib.save_checkpoint(
            path,
            jax_from_state_dict(variables if snapshot else self.variables(), self.cfg.model),
            epoch=epoch,
            config=config,
            scheduler_state=None if snapshot or self.scheduler is None else self.scheduler.state_dict(),
            torch_optimizer_state=None if snapshot else self.optimizer.state_dict(),
        )

    # -- loop ---------------------------------------------------------------
    def fit(
        self,
        train_ds: ArrayDataset,
        dev_ds: ArrayDataset,
        checkpoint_dir: str | None = None,
        config_snapshot: dict | None = None,
        resume_from: str | None = None,
    ) -> dict:
        cfg = self.cfg
        start_epoch = 1
        resumed_ts: dict = {}
        if resume_from:
            restored = self.restore(resume_from)
            start_epoch = restored["epoch"] + 1
            resumed_ts = restored["trainer_state"]
        if self.model is None:
            self.init_state(example_batch=train_ds.features[:1])

        self.visualizer.on_training_start(
            TrainingConfig(
                device=str(self.device),
                model=cfg.model,
                epochs=cfg.epochs,
                batch_size=cfg.batch_size,
                learning_rate=cfg.lr,
                weight_decay=cfg.weight_decay,
                early_stop_patience=cfg.early_stop,
                in_features=cfg.in_features,
                hidden_dim=cfg.hidden_dim,
                dropout=cfg.dropout,
            )
        )

        best_eer = resumed_ts.get("best_eer")
        best_epoch = start_epoch - 1 if best_eer is not None else None  # a resumed run's best stands until beaten
        best_train_loss = resumed_ts.get("best_train_loss")
        best_dev_loss = resumed_ts.get("best_dev_loss")
        prev_metrics: EpochMetrics | None = None
        epochs_no_improve = resumed_ts.get("epochs_no_improve", 0)
        eer_tie_eps = 1e-4
        loss_improve_eps = 1e-6
        best_path = last_path = None
        if checkpoint_dir and (self.ranks is None or self.ranks.is_main):  # rank 0 writes a data-parallel run's
            os.makedirs(checkpoint_dir, exist_ok=True)
            best_path = os.path.join(checkpoint_dir, f"{cfg.model}_best.ckpt")
            last_path = os.path.join(checkpoint_dir, f"{cfg.model}_last.ckpt")

        def trainer_state() -> dict:
            return {
                "best_eer": best_eer, "best_train_loss": best_train_loss,
                "best_dev_loss": best_dev_loss,
                "epochs_no_improve": epochs_no_improve, "lr": self._lr,
            }

        for epoch in range(start_epoch, cfg.epochs + 1):
            t0 = time.perf_counter()
            with self.visualizer.on_epoch_start(epoch, num_batches(len(train_ds), cfg.batch_size)) as batch_ctx:
                train_loss = self.train_epoch(train_ds, epoch, batch_ctx)
            dev_metrics = on_rank_zero(self.ranks, lambda: self.evaluate(dev_ds))
            eer = dev_metrics["eer"]
            dev_loss = dev_metrics["avg_loss"]
            elapsed = time.perf_counter() - t0

            # best rule (reference src/train.py:484-518)
            is_best = False
            if eer is not None:
                if best_eer is None or eer < best_eer:
                    is_best = True
                    best_eer, best_train_loss, best_dev_loss = eer, train_loss, dev_loss
                    epochs_no_improve = 0
                else:
                    epochs_no_improve += 1
                    if (
                        abs(eer - best_eer) <= eer_tie_eps
                        and None not in (train_loss, dev_loss, best_train_loss, best_dev_loss)
                        and train_loss < best_train_loss - loss_improve_eps
                        and dev_loss < best_dev_loss - loss_improve_eps
                    ):
                        is_best = True
                        best_train_loss, best_dev_loss = train_loss, dev_loss
            if is_best:
                best_epoch = epoch
                # parameters change in place: keep a copy of the best epoch's
                self._best_state = {k: v.detach().clone() for k, v in self.model.state_dict().items()}

            if self.scheduler is not None:
                metric = dev_loss if cfg.lr_scheduler_metric == "dev_loss" else eer
                if metric is not None:
                    new_lr = self.scheduler.step(metric, self._lr)
                    if new_lr != self._lr:
                        self._lr = new_lr
                        set_lr(self.optimizer, new_lr)

            improved = (
                prev_metrics is not None
                and prev_metrics.dev_eer is not None
                and eer is not None
                and eer < prev_metrics.dev_eer
            )
            metrics = EpochMetrics(
                epoch=epoch,
                train_loss=train_loss,
                dev_loss=dev_loss,
                dev_eer=eer,
                is_best=is_best,
                improved=improved,
                epochs_no_improve=epochs_no_improve,
                learning_rate=self._lr,
                epoch_seconds=elapsed,
                throughput_utt_s=len(train_ds) / elapsed if elapsed > 0 else None,
            )
            self.visualizer.on_epoch_end(metrics, prev_metrics)

            if is_best and best_path:
                self._save(best_path, epoch, config_snapshot, trainer_state())
            if last_path:
                # refreshed every epoch so a crash resumes from the most
                # recent state (the reference writes its *_last only at exit)
                self._save(last_path, epoch, config_snapshot, trainer_state())
            self.history.append(metrics)
            prev_metrics = metrics

            if cfg.early_stop and epochs_no_improve >= cfg.early_stop:
                break

        self.visualizer.on_training_end(self.history)
        if last_path:
            # a resumed run with no epochs left keeps the restored epoch
            last_epoch = self.history[-1].epoch if self.history else start_epoch - 1
            self._save(last_path, last_epoch, config_snapshot, trainer_state())
        return {
            "best_eer": best_eer,
            "best_train_loss": best_train_loss,
            "best_dev_loss": best_dev_loss,
            "best_epoch": best_epoch,
            "epochs_no_improve": epochs_no_improve,
            "history": self.history,
        }

    def _save(self, path: str, epoch: int, config_snapshot: dict | None, trainer_state: dict) -> None:
        self.save_checkpoint_file(path, epoch=epoch, config_snapshot=config_snapshot, trainer_state=trainer_state)

