"""tqdm progress-bar visualizer.

Counterpart of :mod:`dfac_tpu.obs.tqdm_visualizer`; parity target reference
``src/visualizers/tqdm_visualizer.py:38-152``
— a per-epoch batch bar with running loss postfix and a one-line epoch
summary with best/improvement markers.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from dfac_tpu_torch.obs.base import (
    BatchContext,
    BatchMetrics,
    EpochMetrics,
    TrainingConfig,
    TrainingVisualizer,
)


class _TqdmBatchContext(BatchContext):
    def __init__(self, bar):
        self.bar = bar
        self._last = -1

    def update_batch(self, metrics: BatchMetrics) -> None:
        step = metrics.batch_idx - self._last
        self._last = metrics.batch_idx
        self.bar.update(step)
        self.bar.set_postfix(loss=f"{metrics.running_loss:.4f}")


class TqdmVisualizer(TrainingVisualizer):
    def __init__(self):
        from tqdm import tqdm  # noqa: F401 — import check at construction

        self._total_epochs = 0

    def on_training_start(self, config: TrainingConfig) -> None:
        self._total_epochs = config.epochs
        print(
            f"Training {config.model} on {config.device} | epochs={config.epochs} "
            f"batch_size={config.batch_size} lr={config.learning_rate:g} "
            f"wd={config.weight_decay:g} dropout={config.dropout:g}"
        )

    @contextlib.contextmanager
    def on_epoch_start(self, epoch: int, num_batches: int) -> Iterator[BatchContext]:
        from tqdm import tqdm

        bar = tqdm(total=num_batches, desc=f"Epoch {epoch}/{self._total_epochs}", leave=False)
        try:
            yield _TqdmBatchContext(bar)
        finally:
            bar.close()

    def on_epoch_end(self, metrics: EpochMetrics, prev_metrics: EpochMetrics | None) -> None:
        marks = []
        if metrics.is_best:
            marks.append("best")
        if metrics.improved:
            marks.append("eer improved")
        extra = f"  [{', '.join(marks)}]" if marks else ""
        tl = f"{metrics.train_loss:.4f}" if metrics.train_loss is not None else "n/a"
        dl = f"{metrics.dev_loss:.4f}" if metrics.dev_loss is not None else "n/a"
        de = f"{metrics.dev_eer:.4f}" if metrics.dev_eer is not None else "n/a"
        tp = f"  {metrics.throughput_utt_s:,.0f} utt/s" if metrics.throughput_utt_s else ""
        print(f"Epoch {metrics.epoch}: train_loss={tl} dev_loss={dl} dev_eer={de}{tp}{extra}")

    def on_training_end(self, history: list[EpochMetrics]) -> None:
        if not history:
            return
        best = min((m for m in history if m.dev_eer is not None), key=lambda m: m.dev_eer, default=None)
        if best is not None:
            print(f"Done: {len(history)} epochs; best dev EER {best.dev_eer:.4f} at epoch {best.epoch}")
