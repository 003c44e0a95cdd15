"""Observer-pattern training UI contract.

Counterpart of :mod:`dfac_tpu.obs.base`; parity target reference
``src/visualizers/base.py`` — dataclasses
``TrainingConfig`` / ``BatchMetrics`` / ``EpochMetrics`` and the
``TrainingVisualizer`` ABC with the strict display-only contract: hooks may
render but must never influence training state (reference ``base.py:58-72``).

Hooks:
  on_training_start(config)
  on_epoch_start(epoch, num_batches) -> context manager yielding BatchContext
  on_epoch_end(metrics, prev_metrics)
  on_training_end(history)
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
from typing import Iterator


@dataclasses.dataclass
class TrainingConfig:
    device: str = ""
    model: str = ""
    epochs: int = 0
    batch_size: int = 0
    learning_rate: float = 0.0
    weight_decay: float = 0.0
    early_stop_patience: int = 0
    in_features: int = 180
    hidden_dim: int = 128
    dropout: float = 0.2


@dataclasses.dataclass
class BatchMetrics:
    batch_idx: int
    running_loss: float
    batch_size: int


@dataclasses.dataclass
class EpochMetrics:
    epoch: int
    train_loss: float | None
    dev_loss: float | None
    dev_eer: float | None
    is_best: bool = False
    improved: bool = False
    epochs_no_improve: int = 0
    learning_rate: float | None = None
    epoch_seconds: float | None = None
    throughput_utt_s: float | None = None


class BatchContext(abc.ABC):
    """Per-epoch handle passed into the hot loop for batch-level updates.

    ``wants_updates`` lets display-less contexts opt out: computing the
    running loss forces a device->host sync per step, which dominates step
    time on remote accelerators — the hot loop skips it when nobody looks.
    """

    wants_updates: bool = True

    @abc.abstractmethod
    def update_batch(self, metrics: BatchMetrics) -> None: ...


class TrainingVisualizer(abc.ABC):
    """Display-only: implementations must not mutate training state."""

    @abc.abstractmethod
    def on_training_start(self, config: TrainingConfig) -> None: ...

    @abc.abstractmethod
    def on_epoch_start(self, epoch: int, num_batches: int) -> contextlib.AbstractContextManager[BatchContext]: ...

    @abc.abstractmethod
    def on_epoch_end(self, metrics: EpochMetrics, prev_metrics: EpochMetrics | None) -> None: ...

    @abc.abstractmethod
    def on_training_end(self, history: list[EpochMetrics]) -> None: ...


class _NullBatchContext(BatchContext):
    wants_updates = False

    def update_batch(self, metrics: BatchMetrics) -> None:
        pass


@contextlib.contextmanager
def null_batch_context() -> Iterator[BatchContext]:
    yield _NullBatchContext()
