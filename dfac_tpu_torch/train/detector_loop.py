"""DeepfakeDetector ("dlqueen") training runtime, on one device or data-parallel.

Counterpart of :mod:`dfac_tpu.train.detector_loop`; parity target
reference ``src/dlqueen_model.py:220-448``, the alternative trainer with
its own recipe:

* class-balanced **weighted sampling with replacement** (inverse class
  frequency): each epoch draws ``rng.choice(n, n, replace=True,
  p=sample_p)`` from one ``np.random.default_rng(seed)`` made per fit,
  the JAX package's host calls in its order, so both packages train on the
  same rows;
* ``pos_weight`` BCE (neg/pos on the positive term only, torch's
  ``BCEWithLogitsLoss`` semantics);
* global-norm gradient clipping at 5.0 written as optax's
  ``clip_by_global_norm`` (``t / norm * max_norm`` where ``norm >=
  max_norm``; torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``),
  then AdamW (lr 1e-3, wd 1e-4) on every parameter;
* per-sample SpecAugment on (T, C) (width-capped count masks);
* an **EMA of the parameters** (decay 0.999, starting at the initial
  parameters, updated after every step; BatchNorm statistics are not
  averaged); the dev EER, the checkpoint and the scores use the EMA
  parameters with the live statistics (:meth:`DetectorTrainer.eval_variables`);
* best = strictly lower dev EER (of the logits, by
  :func:`~dfac_tpu_torch.ops.eer.eer_device`), patience-6 early stop;
* variable-length utterances as padded batches with a length mask.

The step runs through autograd on the device, convs in full f32 (or bf16
with ``compute_dtype``)
(:func:`~dfac_tpu_torch.models.common.f32_convs`). Batches come host-fed
(a prefetch thread gathers and uploads each), ``device_resident`` (the
corpus uploaded once, the same order gathered on the card) or chunked
(``resident_chunk_batches``, ``chunk_ingest``:
:mod:`~dfac_tpu_torch.train.chunked`); the tail batch trains at its true
size. Dropout bytes and the SpecAugment draws come from one
``torch.Generator`` on the device, seeded from ``seed``.
``bn_freeze_after_frac`` freezes BatchNorm for the epochs after
``round(epochs * frac)``: the EMA goes on averaging the parameters, and
the eval variables stay the EMA parameters with the live (now fixed)
statistics. :meth:`DetectorTrainer.fit_fused` is the resident fit
(:mod:`~dfac_tpu_torch.train.fused_fit`).

``data_parallel`` N > 1 trains on N ranks (the JAX
``make_detector_dp_train_step``; :mod:`~dfac_tpu_torch.train.loop`): every
rank walks the host's weighted draws in the same order and feeds its rows
of each batch (host-fed or chunked; ``device_resident`` falls back to
host-fed), BatchNorm syncs across the ranks, the gradients of the global
sum are divided once by the global count, then clipping, AdamW and the EMA
run alike on every rank; rank 0 computes the EMA model's dev EER,
broadcasts it and writes the checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.nn.functional as F

from dfac_tpu_torch.data.augment import dlqueen_spec_augment, draw_dlqueen_masks
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.io.prefetch import prefetched
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.models.common import f32_convs, frozen_batchnorm, set_batchnorm_group, set_dropout_generator
from dfac_tpu_torch.ops.eer import eer_device
from dfac_tpu_torch.parallel.data_parallel import maybe_ranks, on_rank_zero, rank_seed
from dfac_tpu_torch.train.chunked import ChunkFeed, check_config, rank_order
from dfac_tpu_torch.train.loop import bn_frozen_at, check_data_parallel, mode, resident_arrays, resident_batches
from dfac_tpu_torch.train.optim import BETAS, EPS


@dataclasses.dataclass
class DetectorConfig:
    """The reference dlqueen recipe's knobs (``src/dlqueen_model.py:266-300``)
    that the port trains: one device or data-parallel, f32 or
    ``compute_dtype="bfloat16"`` (JAX ``detector_loop.py:56``), host-fed,
    resident or chunked, with the BatchNorm freeze tail (the JAX package's
    multi-host and orbax fields select paths not ported yet; see
    ROADMAP.md)."""

    epochs: int = 30
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    hidden: int = 256
    dropout: float = 0.3
    encoder_dropout: float = 0.2
    specaug: bool = False
    time_mask_max: int = 30
    time_mask_n: int = 2
    freq_mask_max: int = 24
    freq_mask_n: int = 2
    ema: bool = False
    ema_decay: float = 0.999
    patience: int = 6
    seed: int = 42
    compute_dtype: str | None = None  # None (f32) | "bfloat16"
    device_resident: bool = False  # upload the corpus once; gather batches on the card
    # stream the epoch in chunks of N batches (TrainConfig's); 0 = off
    resident_chunk_batches: int = 0
    chunk_ingest: str = "f32"  # the chunked upload's compression: f32 | bf16 | int8 (TrainConfig's)
    # freeze BatchNorm for the epochs after round(epochs * frac); 0 disables.
    # The EMA goes on averaging the parameters over the fixed statistics
    bn_freeze_after_frac: float = 0.0
    data_parallel: int = 0  # ranks of the process group (TrainConfig's)
    multihost: bool = False  # the ranks of a multi-host cluster (TrainConfig's)

    def __post_init__(self):
        check_data_parallel(self, "detector training")
        check_config(self)


def compute_class_weights(labels: np.ndarray) -> tuple[float, float, float]:
    """(pos_weight, w0, w1) per reference ``src/dlqueen_model.py:253-262``."""
    pos = int((labels == 1).sum())
    neg = int((labels == 0).sum())
    return neg / max(pos, 1), 1.0 / max(neg, 1), 1.0 / max(pos, 1)


def pos_weight_bce_per(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Per-sample torch ``BCEWithLogitsLoss(pos_weight=...)`` terms."""
    return -(pos_weight * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def pos_weight_bce(logits: torch.Tensor, labels: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """Weight the positive term only, then the plain mean."""
    return torch.mean(pos_weight_bce_per(logits, labels, pos_weight))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global L2 norm
    reaches ``max_norm``, every gradient becomes ``g / norm * max_norm``.
    The choice stays on the device (no host sync); returns the norm."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def dataset_lengths(ds: ArrayDataset) -> np.ndarray:
    """The valid frame counts, every frame where the dataset has none."""
    if ds.lengths is not None:
        return np.asarray(ds.lengths)
    return np.full(len(ds), ds.features.shape[2], np.int32)


class DetectorTrainer:
    def __init__(self, cfg: DetectorConfig, in_channels: int = 180, device=None):
        """``device``: a ``torch.device`` or its name (default ``cuda``, no
        fallback). With ``data_parallel > 1`` the trainer is a rank of the
        default process group."""
        self.cfg = cfg
        self.in_channels = in_channels
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.ranks = maybe_ranks(cfg.data_parallel)
        self.generator = torch.Generator(device=self.device)  # dropout bytes and SpecAugment draws, per rank
        self.generator.manual_seed(rank_seed(cfg.seed, self.ranks.rank) if self.ranks else cfg.seed)
        self.model: torch.nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.ema: dict[str, torch.Tensor] | None = None
        self._eval_model: torch.nn.Module | None = None
        self._resident: tuple | None = None  # (dataset, features, lengths, labels) on the device
        self.chunk_feed = ChunkFeed(cfg, self.device, __name__, self.ranks)  # resident_chunk_batches' feed

    def _build(self) -> torch.nn.Module:
        cfg = self.cfg
        return build_model("detector", in_channels=self.in_channels, hidden=cfg.hidden, dropout=cfg.dropout,
                           encoder_dropout=cfg.encoder_dropout,
                           compute_dtype=getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None)

    # -- state ------------------------------------------------------------
    def init_state(self, state_dict: dict | None = None) -> torch.nn.Module:
        """Build the model with torch's default init drawn from ``seed``
        (the process's global generator is left as it was), or load
        ``state_dict``; then a fresh AdamW and, with ``ema``, the EMA at
        the initial parameters."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = self._build()
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device)
        set_dropout_generator(self.model, self.generator)
        if self.ranks is not None:
            set_batchnorm_group(self.model, self.ranks.group)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr, betas=BETAS, eps=EPS,
                                           weight_decay=cfg.weight_decay)
        self.ema = (
            {name: p.detach().clone() for name, p in self.model.named_parameters()} if cfg.ema else None
        )
        return self.model

    def eval_variables(self) -> dict:
        """The ``state_dict`` that scores: the EMA parameters (with
        ``ema``) and the live BatchNorm statistics."""
        sd = self.model.state_dict()
        return {**sd, **self.ema} if self.ema is not None else sd

    def eval_model(self) -> torch.nn.Module:
        """A module holding :meth:`eval_variables`: the model itself, or
        with ``ema`` a second module loaded with them."""
        if self.ema is None:
            return self.model
        if self._eval_model is None:
            self._eval_model = self._build().to(self.device)
        self._eval_model.load_state_dict(self.eval_variables())
        return self._eval_model

    def scores(self, ds: ArrayDataset, apply_sigmoid: bool = False) -> np.ndarray:
        return detector_scores(self.eval_model(), ds, dataset_lengths(ds), self.cfg.batch_size, apply_sigmoid)

    # -- step -------------------------------------------------------------
    def train_step(self, feats: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
                   pos_weight: float, frozen: bool = False) -> torch.Tensor:
        """One optimizer step on a device batch of stored-orientation (B,
        C, T) features (with ``frozen``, BatchNorm on its running
        statistics); returns the batch's mean loss as a device scalar.
        Data-parallel, the batch is this rank's rows: backward on their sum,
        the gradients summed across the ranks and divided by the global
        count, the loss the global batch's mean (the JAX
        ``make_detector_dp_train_step``)."""
        cfg = self.cfg
        x = feats.transpose(1, 2)  # (B, T, C)
        if cfg.specaug:
            x = dlqueen_spec_augment(x, *draw_dlqueen_masks(self.generator, x, cfg.time_mask_max, cfg.time_mask_n,
                                                             cfg.freq_mask_max, cfg.freq_mask_n))
        self.model.train()
        with f32_convs(), frozen_batchnorm(self.model, frozen):
            per = pos_weight_bce_per(self.model(x, lengths), labels, pos_weight)
            loss = per.mean() if self.ranks is None else per.sum()
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.ranks is not None:
            count = float(per.numel() * self.ranks.world)
            loss = self.ranks.reduce_grads_(self.model.parameters(), loss, count) / count
        if cfg.grad_clip > 0:
            clip_by_global_norm_([p.grad for p in self.model.parameters()], cfg.grad_clip)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    self.ema[name].mul_(cfg.ema_decay).add_(p, alpha=1.0 - cfg.ema_decay)
        return loss.detach()

    def _resident_arrays(self, ds: ArrayDataset):
        if self._resident is None or self._resident[0] is not ds:
            feats, labels = resident_arrays(ds, self.device)
            self._resident = (ds, feats, torch.as_tensor(dataset_lengths(ds), device=self.device), labels)
        return self._resident[1:]

    def _batches(self, ds: ArrayDataset, order: np.ndarray):
        """True-size batches of the rows ``order`` names: gathered on the
        card from the resident corpus, streamed in chunks, or gathered on
        the host and uploaded (pinned, ``non_blocking``) by the prefetch
        thread."""
        chunked = self.cfg.resident_chunk_batches > 0
        order, bs = rank_order(order, self.cfg.batch_size, self.ranks,
                               mode(self.cfg, "chunked detector training" if chunked else "detector training"))
        if self._resident_feed:
            yield from resident_batches(self._resident_arrays(ds), torch.from_numpy(order).to(self.device), bs)
            return
        from dfac_tpu_torch.models.fast_infer import ingest

        lengths = dataset_lengths(ds)
        labels = np.asarray(ds.labels, np.float32)
        if chunked:
            yield from self.chunk_feed.batches(ds.features, (lengths, labels), order)
            return

        def host():
            for start in range(0, len(order), bs):
                idx = order[start : start + bs]
                yield (ingest(ds.features[idx], torch.float32, self.device),
                       torch.from_numpy(lengths[idx]).to(self.device, non_blocking=True),
                       ingest(labels[idx], torch.float32, self.device))

        yield from prefetched(host(), depth=2)

    def train_epoch(self, ds: ArrayDataset, order: np.ndarray, pos_weight: float, frozen: bool = False
                    ) -> tuple[torch.Tensor, int]:
        """One epoch over the rows ``order`` names (with ``frozen``,
        BatchNorm frozen); ``(sum of the batches' mean losses on the
        device, batches)``. The loss is fetched by the caller, once an
        epoch."""
        total = torch.zeros((), device=self.device)
        n_batches = 0
        for feats, lens, labels in self._batches(ds, order):
            total += self.train_step(feats, lens, labels, pos_weight, frozen)
            n_batches += 1
        return total, n_batches

    def _bn_frozen_at(self, epoch: int) -> bool:
        return bn_frozen_at(epoch, self.cfg.epochs, self.cfg.bn_freeze_after_frac)

    @property
    def _resident_feed(self) -> bool:
        """``device_resident`` on one device or multi-host (every rank holds
        the corpus); single-process data-parallel epochs are host-fed, as in JAX."""
        return self.cfg.device_resident and (self.ranks is None or self.cfg.multihost)

    # -- loop ---------------------------------------------------------------
    def fit(self, train_ds: ArrayDataset, dev_ds: ArrayDataset, ckpt_path: str | None = None) -> dict:
        """Train for ``epochs`` (``patience`` ends it early); write
        :meth:`eval_variables` to ``ckpt_path`` on every strictly lower
        dev EER. Returns ``{best_eer, history}``."""
        from dfac_tpu_torch.train.checkpoint import save_checkpoint
        from dfac_tpu_torch.utils.convert import jax_from_state_dict

        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        labels = np.asarray(train_ds.labels)
        pos_weight, w0, w1 = compute_class_weights(labels)
        sample_p = np.where(labels == 1, w1, w0).astype(np.float64)
        sample_p /= sample_p.sum()
        if self.model is None:
            self.init_state()
        if self.cfg.device_resident and not self._resident_feed:
            logging.getLogger(__name__).warning(
                "device_resident is ignored with data_parallel=%d: the "
                "detector epoch falls back to per-batch host-fed dispatch "
                "(a host/relay round trip per step). Drop --data-parallel "
                "or --device-resident to silence this.", cfg.data_parallel,
            )
        if self.ranks is not None and not self.ranks.is_main:
            ckpt_path = None  # rank 0 writes a data-parallel run's
        n = len(train_ds)
        # inf, not 1.0: epoch 1 always counts as an improvement (and saves)
        best_eer, bad, history = float("inf"), 0, []
        for epoch in range(1, cfg.epochs + 1):
            # weighted sampling with replacement, num_samples = N (reference)
            order = rng.choice(n, size=n, replace=True, p=sample_p)
            total, n_batches = self.train_epoch(train_ds, order, pos_weight, self._bn_frozen_at(epoch))
            dev_eer = on_rank_zero(self.ranks, lambda: eer_device(self.scores(dev_ds), dev_ds.labels)[0])
            history.append({"epoch": epoch, "train_loss": float(total) / max(n_batches, 1), "dev_eer": dev_eer})
            if dev_eer < best_eer:
                best_eer, bad = dev_eer, 0
                if ckpt_path:
                    save_checkpoint(ckpt_path, jax_from_state_dict(self.eval_variables(), "detector"), epoch=epoch,
                                    config=dataclasses.asdict(cfg))
            else:
                bad += 1
                if bad >= cfg.patience:
                    break
        return {"best_eer": best_eer, "history": history}

    def fit_fused(self, train_ds: ArrayDataset, dev_ds: ArrayDataset, ckpt_path: str | None = None) -> dict:
        """``--fused-fit`` (:mod:`~dfac_tpu_torch.train.fused_fit`; JAX
        ``make_fused_detector_fit``): :meth:`fit` over the device-resident
        corpus, the freeze tail's ``TypeError`` raised before the first
        epoch; :meth:`fit`'s checkpoint and result. A data-parallel trainer
        raises the JAX package's ``ValueError``."""
        from dfac_tpu_torch.train.fused_fit import check_fused, fused_run

        check_fused(self)
        if self.model is None:
            self.init_state()
        with fused_run(self):
            return self.fit(train_ds, dev_ds, ckpt_path=ckpt_path)


def detector_scores(
    model: torch.nn.Module,
    ds: ArrayDataset,
    lengths: np.ndarray,
    batch_size: int = 128,
    apply_sigmoid: bool = False,
) -> np.ndarray:
    """Per-utterance logits (or sigmoid scores) of the eval model on its
    device, convs in full f32; (N,) float32 in dataset order. Padded
    batches (pad rows of length 1, dropped by the weight mask), f32 uploads
    in a prefetch thread, one fetch at the end
    (:func:`~dfac_tpu_torch.train.evaluate.collect_masked_scores`)."""
    from dfac_tpu_torch.models.fast_infer import ingest
    from dfac_tpu_torch.train.evaluate import collect_masked_scores, model_device

    device = model_device(model)
    lengths = np.asarray(lengths)

    def prepare(b):
        lens = np.where(b.index >= 0, lengths[np.maximum(b.index, 0)], 1)
        return ingest(b.features, torch.float32, device), torch.from_numpy(lens).to(device)

    def score(batch):
        feats, lens = batch
        logits = model(feats.transpose(1, 2), lens)
        return torch.sigmoid(logits) if apply_sigmoid else logits

    was_training = model.training
    model.eval()
    with torch.inference_mode(), f32_convs():
        out = collect_masked_scores(score, ds, batch_size, prepare_batch=prepare)
    model.train(was_training)
    return out
