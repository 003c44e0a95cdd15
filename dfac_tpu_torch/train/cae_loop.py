"""CAE (anomaly) training, scoring and evaluation.

Counterpart of :mod:`dfac_tpu.train.cae_loop`. Feature-parity targets:

* Trainer — reference ``src/train_cae.py``: bonafide-only MSE
  reconstruction training on normalized, swapped (T, F) spectrograms;
  AdamW lr=1e-4 wd=1e-4; ReduceLROnPlateau(patience=7) on the validation
  MSE; early stop 10; best = strictly lower bonafide-dev reconstruction
  MSE; artifacts ``cae_best.ckpt`` / ``cae_last.ckpt`` / ``normalizer.npz``
  in the JAX package's format (the AdamW state under the port's own key,
  ``torch_optimizer_state``). The step runs through autograd on the
  device, convs (the transposed ones' backward included) in full f32
  (:func:`~dfac_tpu_torch.models.common.f32_convs`). Batches come host-fed
  (``np.random.default_rng(seed * 100003 + epoch).shuffle`` of the
  bonafide rows, a true-size tail, gathered and uploaded by a prefetch
  thread), ``device_resident`` (the same order gathered on the card
  from a corpus uploaded once; the bonafide dev split is uploaded once
  too and each validation is one pass over it) or chunked
  (``resident_chunk_batches``, ``chunk_ingest``:
  :mod:`~dfac_tpu_torch.train.chunked`). ``bn_freeze_after_frac``
  freezes every BatchNorm (encoder and decoder) for the epochs after
  ``round(epochs * frac)``; :meth:`CAETrainer.fit_fused` is the resident
  fit with no display (:mod:`~dfac_tpu_torch.train.fused_fit`).
  ``data_parallel`` N > 1 trains on N ranks as the supervised trainer does
  (:mod:`~dfac_tpu_torch.train.loop`; the JAX ``make_cae_dp_train_step``):
  the normalizer replicated, each rank's rows of every batch (host-fed or
  chunked), BatchNorm (encoder and decoder) synced, the validation MSE on
  rank 0 broadcast, the artifacts written by rank 0.
* Evaluator — reference ``src/evaluation_cae.py``: per-sample
  reconstruction MSE over (T, F) of normalized, swapped spectrograms, and
  the **dual scoring convention** (the EER of -MSE and of +MSE, the better
  kept; on this corpus fakes reconstruct better, so +MSE is the bonafide
  score), with per-class mean MSE and the spoof/bonafide ratio.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from dfac_tpu_torch.data.normalizer import FeatureNormalizer, build_normalizer
from dfac_tpu_torch.data.pipeline import ArrayDataset, num_batches
from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.models.cae import reconstruction_mse
from dfac_tpu_torch.models.common import f32_convs, frozen_batchnorm, set_batchnorm_group
from dfac_tpu_torch.obs.base import EpochMetrics, TrainingConfig, TrainingVisualizer
from dfac_tpu_torch.obs.noop import NoOpVisualizer
from dfac_tpu_torch.ops.eer import eer_device
from dfac_tpu_torch.parallel.data_parallel import maybe_ranks, on_rank_zero
from dfac_tpu_torch.train import checkpoint as ckpt_lib
from dfac_tpu_torch.train.chunked import ChunkFeed, check_config, rank_order
from dfac_tpu_torch.train.loop import (
    bn_frozen_at,
    check_data_parallel,
    epoch_order,
    mode,
    resident_arrays,
    run_epoch,
    shuffled_batches,
    weighted_step,
)
from dfac_tpu_torch.train.optim import BETAS, EPS, PlateauScheduler, set_lr
from dfac_tpu_torch.utils.convert import jax_from_state_dict


def cae_mse_scores(
    model: torch.nn.Module,
    ds: ArrayDataset,
    normalizer: FeatureNormalizer,
    batch_size: int = 128,
    features: torch.Tensor | None = None,
) -> np.ndarray:
    """Per-utterance reconstruction MSE of the eval model on its device
    (convs in full f32), dataset order; batches and uploads as
    :func:`~dfac_tpu_torch.train.evaluate.predict_scores`. ``features``
    (optional) is ``ds.features`` already on that device: the batches are
    then its slices, the tail zero-padded to the same batch shape, and
    nothing is uploaded."""
    from dfac_tpu_torch.models.fast_infer import ingest
    from dfac_tpu_torch.train.evaluate import collect_masked_scores, model_device

    device = model_device(model)
    mean = torch.as_tensor(normalizer.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(normalizer.std, dtype=torch.float32, device=device)

    def score(feats):
        x = (feats.transpose(1, 2) - mean) / std
        recon, _ = model(x)
        return reconstruction_mse(recon, x)

    def resident_batch(b):
        idx = b.index[b.index >= 0]  # consecutive: the batches are unshuffled
        rows = features[int(idx[0]) : int(idx[-1]) + 1]
        return torch.cat([rows, rows.new_zeros((batch_size - len(rows), *rows.shape[1:]))])

    was_training = model.training
    model.eval()
    with torch.inference_mode(), f32_convs():
        mse = collect_masked_scores(
            score, ds, batch_size,
            prepare_batch=resident_batch if features is not None else (
                lambda b: ingest(b.features, torch.float32, device)),
        )
    model.train(was_training)
    return mse


def evaluate_cae(
    model: torch.nn.Module, ds: ArrayDataset, normalizer: FeatureNormalizer, batch_size: int = 128
) -> dict:
    """Dual-convention CAE evaluation (reference ``src/evaluation_cae.py:50-87``)."""
    if ds.labels is None:
        raise ValueError("evaluate_cae needs labels")
    mse = cae_mse_scores(model, ds, normalizer, batch_size)
    labels = np.asarray(ds.labels)
    eer_neg, thr_neg = eer_device(-mse, labels)
    eer_pos, thr_pos = eer_device(mse, labels)
    if eer_pos <= eer_neg:
        convention, eer, thr = "+mse", eer_pos, thr_pos
    else:
        convention, eer, thr = "-mse", eer_neg, thr_neg
    bona = mse[labels == 1]
    spoof = mse[labels == 0]
    return {
        "eer": eer,
        "threshold": thr,
        "convention": convention,
        "eer_pos_mse": eer_pos,
        "eer_neg_mse": eer_neg,
        "bonafide_mean_mse": float(bona.mean()) if len(bona) else None,
        "spoof_mean_mse": float(spoof.mean()) if len(spoof) else None,
        "spoof_bonafide_ratio": float(spoof.mean() / bona.mean()) if len(bona) and len(spoof) else None,
        "scores": mse,
    }


@dataclasses.dataclass
class CAEConfig:
    """Reference train_cae.py defaults (``src/train_cae.py:114-126``), the
    fields the port trains: f32, one device or data-parallel, host-fed,
    resident or chunked, with the BatchNorm freeze tail (the JAX package's
    multi-host and orbax fields select paths not ported yet; see
    ROADMAP.md)."""

    batch_size: int = 32
    epochs: int = 80
    lr: float = 1e-4
    weight_decay: float = 1e-4
    lr_scheduler_patience: int = 7
    lr_scheduler_factor: float = 0.5
    early_stop: int = 10
    base_channels: int = 32
    seed: int = 0
    device_resident: bool = False  # upload the bonafide corpus once; gather batches on the card
    # stream the epoch in chunks of N batches (TrainConfig's); 0 = off
    resident_chunk_batches: int = 0
    chunk_ingest: str = "f32"  # the chunked upload's compression: f32 | bf16 | int8 (TrainConfig's)
    # freeze every BatchNorm (encoder + decoder) for the epochs after
    # round(epochs * frac); 0 disables. The CAE has no dropout, so this is
    # its whole --train-fast recipe
    bn_freeze_after_frac: float = 0.0
    data_parallel: int = 0  # ranks of the process group (TrainConfig's)
    multihost: bool = False  # the ranks of a multi-host cluster (TrainConfig's)

    def __post_init__(self):
        check_data_parallel(self, "CAE training")
        check_config(self)


class CAETrainer:
    def __init__(self, cfg: CAEConfig, visualizer: TrainingVisualizer | None = None, device=None):
        """``device``: a ``torch.device`` or its name (default ``cuda``, no
        fallback). With ``data_parallel > 1`` the trainer is a rank of the
        default process group."""
        self.cfg = cfg
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.ranks = maybe_ranks(cfg.data_parallel)
        main = self.ranks is None or self.ranks.is_main
        self.visualizer = (visualizer if main else None) or NoOpVisualizer()
        self.scheduler = PlateauScheduler(factor=cfg.lr_scheduler_factor, patience=cfg.lr_scheduler_patience)
        self.model: torch.nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.normalizer: FeatureNormalizer | None = None
        self.history: list[EpochMetrics] = []
        self._lr = cfg.lr
        self._resident: dict = {}  # id(dataset) -> (dataset, features, labels on the device)
        self.chunk_feed = ChunkFeed(cfg, self.device, __name__, self.ranks)  # resident_chunk_batches' feed

    # -- state ------------------------------------------------------------
    def init_state(self, state_dict: dict | None = None) -> torch.nn.Module:
        """Build the CAE with torch's default init drawn from ``seed`` (the
        process's global generator is left as it was), or load
        ``state_dict``; then a fresh AdamW."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model("cae", base_channels=cfg.base_channels)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device)
        if self.ranks is not None:
            set_batchnorm_group(self.model, self.ranks.group)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=self._lr, betas=BETAS, eps=EPS,
                                           weight_decay=cfg.weight_decay)
        return self.model

    def use_normalizer(self, normalizer: FeatureNormalizer) -> None:
        self.normalizer = normalizer
        self._mean = torch.as_tensor(normalizer.mean, dtype=torch.float32, device=self.device)
        self._std = torch.as_tensor(normalizer.std, dtype=torch.float32, device=self.device)

    # -- step -------------------------------------------------------------
    def train_step(self, feats: torch.Tensor, weights: torch.Tensor, frozen: bool = False):
        """One optimizer step on a device batch of stored-orientation (B,
        F, T) features: swap, normalize, reconstruct (with ``frozen``, every
        BatchNorm on its running statistics), the weighted mean MSE,
        backward, AdamW. Returns ``(loss * count, count)``
        (:func:`~dfac_tpu_torch.train.loop.weighted_step`)."""
        x = (feats.transpose(1, 2) - self._mean) / self._std
        self.model.train()
        with f32_convs(), frozen_batchnorm(self.model, frozen):
            recon, _ = self.model(x)
            per = reconstruction_mse(recon, x)
            return weighted_step(per, weights, self.optimizer, self.model.parameters(), self.ranks)

    def _resident_arrays(self, ds: ArrayDataset) -> tuple[torch.Tensor, torch.Tensor]:
        """``ds``'s features and labels on the device, uploaded once per dataset."""
        entry = self._resident.get(id(ds))
        if entry is None or entry[0] is not ds:
            entry = self._resident[id(ds)] = (ds, *resident_arrays(ds, self.device))
        return entry[1:]

    def _bn_frozen_at(self, epoch: int) -> bool:
        return bn_frozen_at(epoch, self.cfg.epochs, self.cfg.bn_freeze_after_frac)

    def train_epoch(self, ds: ArrayDataset, epoch: int, batch_ctx=None) -> float | None:
        """One epoch over the bonafide rows of ``ds`` (shuffle seed ``seed
        * 100003 + epoch``, the batches of
        :func:`~dfac_tpu_torch.train.loop.shuffled_batches`, or those
        batches streamed in chunks); the weighted mean training MSE, or
        None for an empty corpus."""
        cfg = self.cfg
        frozen = self._bn_frozen_at(epoch)
        chunked = cfg.resident_chunk_batches > 0
        order, bs = rank_order(epoch_order(len(ds), cfg.seed * 100003 + epoch), cfg.batch_size, self.ranks,
                               mode(cfg, "chunked CAE training" if chunked else "CAE training"))
        if chunked:  # the host loop's batches, streamed in chunks
            ones = torch.ones(bs, device=self.device)
            batches = ((f, None, ones[: len(f)]) for (f,) in self.chunk_feed.batches(ds.features, (), order))
        else:
            resident = self._resident_arrays(ds) if self._resident_feed else None
            batches = shuffled_batches(ds, bs, order, self.device, resident)
        return run_epoch(lambda feats, _labels, weights: self.train_step(feats, weights, frozen), batches,
                         self.device, batch_ctx)

    @property
    def _resident_feed(self) -> bool:
        """``device_resident`` on one device or multi-host (every rank holds
        the corpus); single-process data-parallel epochs are host-fed, as in JAX."""
        return self.cfg.device_resident and (self.ranks is None or self.cfg.multihost)

    def validate(self, bona_dev: ArrayDataset) -> float:
        """The bonafide-dev mean reconstruction MSE (reference ``:85-105``);
        resident, one pass over the dev split uploaded once."""
        features = self._resident_arrays(bona_dev)[0] if self._resident_feed and len(bona_dev) else None
        scores = cae_mse_scores(self.model, bona_dev, self.normalizer, self.cfg.batch_size, features=features)
        return float(scores.mean()) if len(scores) else float("nan")

    def _save(self, path: str, epoch: int, scheduler_state: dict | None = None) -> None:
        ckpt_lib.save_checkpoint(
            path, jax_from_state_dict(self.model.state_dict(), "cae"), epoch=epoch,
            config=dataclasses.asdict(self.cfg), scheduler_state=scheduler_state,
            torch_optimizer_state=self.optimizer.state_dict(),
        )

    # -- loop ---------------------------------------------------------------
    def fit(
        self,
        train_ds: ArrayDataset,
        dev_ds: ArrayDataset,
        checkpoint_dir: str | None = None,
        normalizer: FeatureNormalizer | None = None,
    ) -> dict:
        """``train_ds``/``dev_ds`` are full labeled datasets; bonafide-only
        filtering and the normalizer fit happen here (reference
        ``src/train_cae.py:176-194``). Returns ``{best_val_mse, history,
        normalizer}``."""
        cfg = self.cfg
        bona_train = train_ds.filter_label(1) if train_ds.labels is not None else train_ds
        bona_dev = dev_ds.filter_label(1) if dev_ds.labels is not None else dev_ds
        self.use_normalizer(normalizer or build_normalizer(train_ds.features, train_ds.labels,
                                                           lengths=train_ds.lengths))
        if self.model is None:
            self.init_state()

        if cfg.device_resident and not self._resident_feed:
            logging.getLogger(__name__).warning(
                "device_resident is ignored with data_parallel=%d: the CAE "
                "epoch falls back to per-batch host-fed dispatch (a "
                "host/relay round trip per step). Drop --data-parallel or "
                "--device-resident to silence this.", cfg.data_parallel,
            )
        best_path = last_path = None
        if checkpoint_dir and (self.ranks is None or self.ranks.is_main):  # rank 0 writes a data-parallel run's
            os.makedirs(checkpoint_dir, exist_ok=True)
            best_path = os.path.join(checkpoint_dir, "cae_best.ckpt")
            last_path = os.path.join(checkpoint_dir, "cae_last.ckpt")
            self.normalizer.save(os.path.join(checkpoint_dir, "normalizer.npz"))

        self.visualizer.on_training_start(
            TrainingConfig(
                device=str(self.device), model="cae", epochs=cfg.epochs, batch_size=cfg.batch_size,
                learning_rate=cfg.lr, weight_decay=cfg.weight_decay, early_stop_patience=cfg.early_stop,
            )
        )
        best_val = None
        epochs_no_improve = 0
        prev: EpochMetrics | None = None
        for epoch in range(1, cfg.epochs + 1):
            t0 = time.perf_counter()
            with self.visualizer.on_epoch_start(epoch, num_batches(len(bona_train), cfg.batch_size)) as batch_ctx:
                train_loss = self.train_epoch(bona_train, epoch, batch_ctx)
            val_loss = on_rank_zero(self.ranks, lambda: self.validate(bona_dev))
            elapsed = time.perf_counter() - t0

            is_best = best_val is None or val_loss < best_val
            if is_best:
                best_val = val_loss
                epochs_no_improve = 0
                if best_path:
                    # the scheduler's state before this epoch's plateau step, as the JAX trainer saves it
                    self._save(best_path, epoch, self.scheduler.state_dict())
            else:
                epochs_no_improve += 1

            new_lr = self.scheduler.step(val_loss, self._lr)
            if new_lr != self._lr:
                self._lr = new_lr
                set_lr(self.optimizer, new_lr)

            metrics = EpochMetrics(
                epoch=epoch, train_loss=train_loss, dev_loss=val_loss, dev_eer=None,
                is_best=is_best, improved=is_best, epochs_no_improve=epochs_no_improve,
                learning_rate=self._lr, epoch_seconds=elapsed,
                throughput_utt_s=len(bona_train) / elapsed if elapsed > 0 else None,
            )
            self.visualizer.on_epoch_end(metrics, prev)
            self.history.append(metrics)
            prev = metrics
            if cfg.early_stop and epochs_no_improve >= cfg.early_stop:
                break

        self.visualizer.on_training_end(self.history)
        if last_path:
            self._save(last_path, self.history[-1].epoch if self.history else 0)
        return {"best_val_mse": best_val, "history": self.history, "normalizer": self.normalizer}

    def fit_fused(
        self,
        train_ds: ArrayDataset,
        dev_ds: ArrayDataset,
        checkpoint_dir: str | None = None,
        normalizer: FeatureNormalizer | None = None,
    ) -> dict:
        """``--fused-fit`` (:mod:`~dfac_tpu_torch.train.fused_fit`; JAX
        ``make_fused_cae_fit``): :meth:`fit` over the device-resident corpus
        with no display, the freeze tail's ``TypeError`` raised before the
        first epoch; :meth:`fit`'s artifacts and result. A data-parallel
        trainer raises the JAX package's ``ValueError``."""
        from dfac_tpu_torch.train.fused_fit import check_fused, fused_run

        check_fused(self)
        if self.model is None:
            self.init_state()
        with fused_run(self):
            return self.fit(train_ds, dev_ds, checkpoint_dir=checkpoint_dir, normalizer=normalizer)
