"""No-op visualizer for CI / benchmarking / headless runs.

Counterpart of :mod:`dfac_tpu.obs.noop`; parity target reference
``src/visualizers/noop_visualizer.py:23-49``.
"""

from __future__ import annotations

import contextlib

from dfac_tpu_torch.obs.base import (
    BatchContext,
    EpochMetrics,
    TrainingConfig,
    TrainingVisualizer,
    null_batch_context,
)


class NoOpVisualizer(TrainingVisualizer):
    def on_training_start(self, config: TrainingConfig) -> None:
        pass

    def on_epoch_start(self, epoch: int, num_batches: int) -> contextlib.AbstractContextManager[BatchContext]:
        return null_batch_context()

    def on_epoch_end(self, metrics: EpochMetrics, prev_metrics: EpochMetrics | None) -> None:
        pass

    def on_training_end(self, history: list[EpochMetrics]) -> None:
        pass
