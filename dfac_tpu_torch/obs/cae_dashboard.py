"""Dedicated CAE-training live dashboard.

Counterpart of :mod:`dfac_tpu.obs.cae_dashboard`; parity target the
reference CAE trainer's inline rich UI (``src/train_cae.py:203-348``): a
config panel, an overall epoch progress bar, a per-epoch batch bar, and a
**rolling 20-row epoch table** (Epoch / Train MSE / Val MSE / LR /
No-Improve / Best) that updates live, with a plain-print fallback
producing the reference's per-epoch line format. ``rich`` is imported by
:class:`CAEDashboard` alone, so the module imports without it;
:func:`create_cae_visualizer` keeps the reference's rich -> plain fallback
(a display choice: the trainer and its device are the same either way).
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

ROLLING_ROWS = 20


class _LiveBatchContext(BatchContext):
    def __init__(self, progress, task_id):
        self.progress = progress
        self.task_id = task_id

    def update_batch(self, metrics: BatchMetrics) -> None:
        self.progress.update(
            self.task_id,
            completed=metrics.batch_idx + 1,
            description=f"  [cyan]Train[/] mse {metrics.running_loss:.6f}",
        )


class CAEDashboard(TrainingVisualizer):
    """Rich Live layout: epoch bar + batch bar + rolling epoch table."""

    def __init__(self):
        from rich.console import Console

        self.console = Console()
        self.history: list[EpochMetrics] = []
        self._early_stop = 0
        self._live = None
        self._epoch_progress = None
        self._batch_progress = None
        self._epoch_task = None

    # -- layout pieces -----------------------------------------------------

    def _build_table(self):
        from rich.table import Table

        table = Table(title="CAE Training Progress", show_lines=False)
        table.add_column("Epoch", justify="right", style="cyan", width=6)
        table.add_column("Train MSE", justify="right", width=12)
        table.add_column("Val MSE", justify="right", width=12)
        table.add_column("LR", justify="right", width=10)
        table.add_column("No Impr", justify="right", width=8)
        table.add_column("Best", justify="center", width=5)
        for m in self.history[-ROLLING_ROWS:]:
            ni = m.epochs_no_improve
            style = (
                "[red]" if self._early_stop and ni >= self._early_stop - 2
                else "[yellow]" if ni >= 3
                else ""
            )
            table.add_row(
                str(m.epoch),
                f"{m.train_loss:.6f}" if m.train_loss is not None else "-",
                f"{m.dev_loss:.6f}" if m.dev_loss is not None else "-",
                f"{m.learning_rate:.2e}" if m.learning_rate is not None else "-",
                f"{style}{ni}",
                "[bold green]***[/]" if m.is_best else "",
            )
        return table

    def _group(self):
        from rich.console import Group

        return Group(self._epoch_progress, self._batch_progress, self._build_table())

    # -- TrainingVisualizer hooks -------------------------------------------

    def on_training_start(self, config: TrainingConfig) -> None:
        from rich.live import Live
        from rich.panel import Panel
        from rich.progress import (
            BarColumn,
            MofNCompleteColumn,
            Progress,
            SpinnerColumn,
            TextColumn,
            TimeElapsedColumn,
            TimeRemainingColumn,
        )

        self._early_stop = config.early_stop_patience
        self.console.print(
            Panel(
                f"[bold]CAE Training[/bold]\n"
                f"Device: {config.device}  |  Epochs: {config.epochs}  |  "
                f"Early stop: {config.early_stop_patience}\n"
                f"LR: {config.learning_rate}  |  "
                f"Weight decay: {config.weight_decay}  |  "
                f"Batch: {config.batch_size}",
                title="Config",
                border_style="blue",
            )
        )
        self._epoch_progress = Progress(
            SpinnerColumn(),
            TextColumn("[bold blue]Epochs"),
            BarColumn(bar_width=40),
            MofNCompleteColumn(),
            TimeElapsedColumn(),
            TimeRemainingColumn(),
        )
        self._epoch_task = self._epoch_progress.add_task("Epochs", total=config.epochs)
        self._batch_progress = Progress(
            TextColumn("{task.description}"),
            BarColumn(bar_width=30),
            MofNCompleteColumn(),
        )
        self._live = Live(self._group(), console=self.console, refresh_per_second=4)
        self._live.start()

    @contextlib.contextmanager
    def on_epoch_start(self, epoch: int, num_batches: int) -> Iterator[BatchContext]:
        task = self._batch_progress.add_task("  [cyan]Train[/]", total=num_batches)
        try:
            yield _LiveBatchContext(self._batch_progress, task)
        finally:
            self._batch_progress.remove_task(task)

    def on_epoch_end(self, metrics: EpochMetrics, prev: EpochMetrics | None) -> None:
        self.history.append(metrics)
        self._epoch_progress.update(self._epoch_task, advance=1)
        self._live.update(self._group())

    def on_training_end(self, history: list[EpochMetrics]) -> None:
        if self._live is not None:
            self._live.update(self._group())
            self._live.stop()
            self._live = None
        if history and self._early_stop and history[-1].epochs_no_improve >= self._early_stop:
            self.console.print(
                f"\n[bold yellow]Early stopping at epoch {history[-1].epoch} "
                f"(no improvement in {self._early_stop} epochs)[/]"
            )
        best = min(
            (m for m in history if m.dev_loss is not None),
            key=lambda m: m.dev_loss,
            default=None,
        )
        if best is not None:
            self.console.print(
                f"[bold green]Best val MSE {best.dev_loss:.6f} at epoch {best.epoch}[/]"
            )


class CAEPlainDashboard(TrainingVisualizer):
    """The reference's no-rich fallback: one line per epoch
    (``src/train_cae.py:307-348``)."""

    def __init__(self):
        self._early_stop = 0

    def on_training_start(self, config: TrainingConfig) -> None:
        self._early_stop = config.early_stop_patience
        print(
            f"\nTraining on {config.device} for up to {config.epochs} epochs "
            f"(early stop patience={config.early_stop_patience})"
        )
        print("-" * 60)

    @contextlib.contextmanager
    def on_epoch_start(self, epoch: int, num_batches: int) -> Iterator[BatchContext]:
        from dfac_tpu_torch.obs.base import null_batch_context

        with null_batch_context() as ctx:
            yield ctx

    def on_epoch_end(self, metrics: EpochMetrics, prev: EpochMetrics | None) -> None:
        marker = " *" if metrics.is_best else ""
        train = f"{metrics.train_loss:.6f}" if metrics.train_loss is not None else "-"
        val = f"{metrics.dev_loss:.6f}" if metrics.dev_loss is not None else "-"
        lr = f"{metrics.learning_rate:.2e}" if metrics.learning_rate is not None else "-"
        print(
            f"  epoch {metrics.epoch:3d}  train_mse={train}  val_mse={val}  "
            f"lr={lr}  no_improve={metrics.epochs_no_improve}{marker}"
        )

    def on_training_end(self, history: list[EpochMetrics]) -> None:
        if history and self._early_stop and history[-1].epochs_no_improve >= self._early_stop:
            print(
                f"\nEarly stopping at epoch {history[-1].epoch} "
                f"(no improvement in {self._early_stop} epochs)"
            )
        # final best-result line of the reference's plain fallback
        # (src/train_cae.py:363) — the rich dashboard prints its panel
        best = min(
            (m for m in history if m.dev_loss is not None),
            key=lambda m: m.dev_loss, default=None,
        )
        if best is not None:
            print(f"\nBest val MSE: {best.dev_loss:.6f} (epoch {best.epoch})")


def create_cae_visualizer(kind: str = "rich") -> TrainingVisualizer:
    """rich -> plain -> noop fallback chain, mirroring the reference's
    HAS_RICH gate (``src/train_cae.py:225-307``)."""
    if kind == "noop":
        from dfac_tpu_torch.obs.noop import NoOpVisualizer

        return NoOpVisualizer()
    if kind == "rich":
        try:
            return CAEDashboard()
        except ImportError:
            kind = "plain"
    if kind in ("plain", "tqdm"):
        return CAEPlainDashboard()
    raise ValueError(f"unknown CAE visualizer '{kind}' (rich|plain|noop)")
