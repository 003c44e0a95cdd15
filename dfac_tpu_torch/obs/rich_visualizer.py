"""Rich live-dashboard visualizer.

Counterpart of :mod:`dfac_tpu.obs.rich_visualizer`; parity target reference
``src/visualizers/rich_visualizer.py:58-316``
— a live batch progress bar, per-epoch panels with up/down trend arrows vs
the previous epoch, and a final summary table of the full history.
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


def _trend(curr: float | None, prev: float | None, lower_is_better: bool = True) -> str:
    if curr is None or prev is None:
        return ""
    if abs(curr - prev) < 1e-12:
        return " ="
    good = curr < prev if lower_is_better else curr > prev
    arrow = "↓" if curr < prev else "↑"
    color = "green" if good else "red"
    return f" [{color}]{arrow}[/{color}]"


class _RichBatchContext(BatchContext):
    def __init__(self, progress, task_id):
        self.progress = progress
        self.task_id = task_id

    def update_batch(self, metrics: BatchMetrics) -> None:
        self.progress.update(
            self.task_id,
            completed=metrics.batch_idx + 1,
            description=f"loss {metrics.running_loss:.4f}",
        )


class RichVisualizer(TrainingVisualizer):
    def __init__(self):
        from rich.console import Console

        self.console = Console()
        self._total_epochs = 0
        self._config: TrainingConfig | None = None

    def on_training_start(self, config: TrainingConfig) -> None:
        from rich.panel import Panel
        from rich.table import Table

        self._total_epochs = config.epochs
        self._config = config
        t = Table.grid(padding=(0, 2))
        t.add_column(style="bold cyan")
        t.add_column()
        for k, v in (
            ("model", config.model), ("device", config.device), ("epochs", config.epochs),
            ("batch size", config.batch_size), ("learning rate", f"{config.learning_rate:g}"),
            ("weight decay", f"{config.weight_decay:g}"), ("dropout", f"{config.dropout:g}"),
            ("early stop", config.early_stop_patience or "off"),
        ):
            t.add_row(str(k), str(v))
        self.console.print(Panel(t, title="[bold]dfac-tpu training[/bold]", expand=False))

    @contextlib.contextmanager
    def on_epoch_start(self, epoch: int, num_batches: int) -> Iterator[BatchContext]:
        from rich.progress import (
            BarColumn,
            MofNCompleteColumn,
            Progress,
            TextColumn,
            TimeElapsedColumn,
        )

        progress = Progress(
            TextColumn(f"[bold]epoch {epoch}/{self._total_epochs}[/bold]"),
            BarColumn(),
            MofNCompleteColumn(),
            TimeElapsedColumn(),
            TextColumn("{task.description}"),
            console=self.console,
            transient=True,
        )
        task_id = progress.add_task("", total=num_batches)
        with progress:
            yield _RichBatchContext(progress, task_id)

    def on_epoch_end(self, metrics: EpochMetrics, prev: EpochMetrics | None) -> None:
        parts = []
        if metrics.train_loss is not None:
            parts.append(
                f"train loss [bold]{metrics.train_loss:.4f}[/bold]"
                + _trend(metrics.train_loss, prev.train_loss if prev else None)
            )
        if metrics.dev_loss is not None:
            parts.append(
                f"dev loss [bold]{metrics.dev_loss:.4f}[/bold]"
                + _trend(metrics.dev_loss, prev.dev_loss if prev else None)
            )
        if metrics.dev_eer is not None:
            parts.append(
                f"dev EER [bold]{metrics.dev_eer:.4f}[/bold]"
                + _trend(metrics.dev_eer, prev.dev_eer if prev else None)
            )
        if metrics.learning_rate is not None:
            parts.append(f"lr {metrics.learning_rate:g}")
        if metrics.throughput_utt_s:
            parts.append(f"[dim]{metrics.throughput_utt_s:,.0f} utt/s[/dim]")
        badge = " [bold green]★ best[/bold green]" if metrics.is_best else ""
        stall = (
            f" [dim]({metrics.epochs_no_improve} epochs w/o improvement)[/dim]"
            if metrics.epochs_no_improve
            else ""
        )
        self.console.print(f"  epoch {metrics.epoch:>3}: " + "  ".join(parts) + badge + stall)

    def on_training_end(self, history: list[EpochMetrics]) -> None:
        from rich.table import Table

        if not history:
            return
        table = Table(title="training summary")
        for col in ("epoch", "train loss", "dev loss", "dev EER", "best"):
            table.add_column(col, justify="right")
        for m in history:
            table.add_row(
                str(m.epoch),
                "-" if m.train_loss is None else f"{m.train_loss:.4f}",
                "-" if m.dev_loss is None else f"{m.dev_loss:.4f}",
                "-" if m.dev_eer is None else f"{m.dev_eer:.4f}",
                "★" if m.is_best else "",
            )
        self.console.print(table)
