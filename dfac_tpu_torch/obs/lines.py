"""A visualizer that prints one plain line per epoch.

The train CLI's display where neither ``rich`` nor ``tqdm`` is installed
(the JAX package's rich and tqdm visualizers are not ported yet). It asks
for no batch updates, so the training loop never syncs the device for it.
"""

from __future__ import annotations

import contextlib
import sys

from dfac_tpu_torch.obs.base import BatchContext, EpochMetrics, TrainingConfig, null_batch_context
from dfac_tpu_torch.obs.noop import NoOpVisualizer


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.6f}"


class LineVisualizer(NoOpVisualizer):
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def _print(self, text: str) -> None:
        print(text, file=self.stream, flush=True)

    def on_training_start(self, config: TrainingConfig) -> None:
        self._print(f"training {config.model} on {config.device}: {config.epochs} epochs, batch "
                    f"{config.batch_size}, lr {config.learning_rate:g}")

    def on_epoch_start(self, epoch: int, num_batches: int) -> contextlib.AbstractContextManager[BatchContext]:
        return null_batch_context()

    def on_epoch_end(self, metrics: EpochMetrics, prev_metrics: EpochMetrics | None) -> None:
        m = metrics
        self._print(
            f"epoch {m.epoch}: train_loss {_fmt(m.train_loss)} dev_loss {_fmt(m.dev_loss)} "
            f"dev_eer {_fmt(m.dev_eer)} lr {m.learning_rate:g} best {'yes' if m.is_best else 'no'} "
            f"({m.epoch_seconds:.2f}s, {m.throughput_utt_s:,.1f} utt/s)"
        )
