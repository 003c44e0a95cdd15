"""Multi-model / multi-seed experiment harness.

Counterpart of :mod:`dfac_tpu.train.benchmark_harness`; parity target
reference ``src/benchmark.py`` — sweep a comma list
of model specs (``name[+specaug]``) over seeds, and emit:

* ``model_runs.csv``   — one row per (model, seed) run (best EER/epoch/time)
* ``model_epochs.csv`` — per-epoch train/dev loss + dev EER curves
* ``model_ranking.csv`` — per-model mean/std aggregation, ranked by EER
* ranking bar plot + per-model mean+-std loss/EER curves + combined plot
* an overfit heuristic (train loss falling while dev loss rises for 2
  consecutive epochs, reference ``:530-548``)
* ``benchmark_report.md`` and a rich ranking table.

Unlike the reference (which clones its own training loop), this harness
drives the real :class:`dfac_tpu_torch.train.loop.Trainer` on ``device``
(default ``cuda``): the sweep measures the production path, throughput
column included. It is the package's own model sweep, not a benchmark of
the port's speed.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.obs.base import EpochMetrics
from dfac_tpu_torch.train.loop import TrainConfig, Trainer


@dataclasses.dataclass
class ModelSpec:
    name: str
    spec_augment: bool = False

    @property
    def label(self) -> str:
        return f"{self.name}+specaug" if self.spec_augment else self.name


def parse_model_specs(spec: str) -> list[ModelSpec]:
    """``"cnn2d,cnn2d+specaug,cnn1d"`` -> specs (reference ``:157-167``)."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, suffix = item.partition("+")
        if suffix and suffix != "specaug":
            raise ValueError(f"unknown model suffix '+{suffix}' in '{item}'")
        out.append(ModelSpec(name=name, spec_augment=bool(suffix)))
    return out


def detect_overfit(history: list[EpochMetrics], window: int = 2) -> bool:
    """Train loss strictly falling while dev loss strictly rising for
    ``window`` consecutive steps (reference ``:530-548``)."""
    tl = [m.train_loss for m in history]
    dl = [m.dev_loss for m in history]
    for i in range(len(history) - window):
        seg_t = tl[i : i + window + 1]
        seg_d = dl[i : i + window + 1]
        if any(v is None for v in seg_t + seg_d):
            continue
        if all(seg_t[j + 1] < seg_t[j] for j in range(window)) and all(
            seg_d[j + 1] > seg_d[j] for j in range(window)
        ):
            return True
    return False


def run_benchmark(
    train_ds: ArrayDataset,
    dev_ds: ArrayDataset,
    model_specs: list[ModelSpec],
    seeds: list[int],
    base_cfg: TrainConfig,
    output_dir: str,
    make_plots: bool = True,
    print_table: bool = True,
    device=None,
) -> dict:
    """Train every (spec, seed) with ``base_cfg``; write the CSVs, the
    plots (skipped where matplotlib cannot be imported), the report and
    the ranking table under ``output_dir``. ``device`` as the
    :class:`~dfac_tpu_torch.train.loop.Trainer`'s."""
    os.makedirs(output_dir, exist_ok=True)
    run_rows: list[dict] = []
    epoch_rows: list[dict] = []

    for spec in model_specs:
        for seed in seeds:
            cfg = dataclasses.replace(
                base_cfg,
                model=spec.name,
                seed=seed,
                augment=dataclasses.replace(base_cfg.augment, spec_augment=spec.spec_augment),
            )
            trainer = Trainer(cfg, device=device)
            t0 = time.perf_counter()
            result = trainer.fit(train_ds, dev_ds)
            elapsed = time.perf_counter() - t0
            history = result["history"]
            best = min(
                (m for m in history if m.dev_eer is not None),
                key=lambda m: m.dev_eer,
                default=None,
            )
            run_rows.append(
                {
                    "model": spec.label,
                    "seed": seed,
                    "best_dev_eer": best.dev_eer if best else None,
                    "best_epoch": best.epoch if best else None,
                    "final_train_loss": history[-1].train_loss if history else None,
                    "final_dev_loss": history[-1].dev_loss if history else None,
                    "epochs_run": len(history),
                    "wall_seconds": round(elapsed, 2),
                    "mean_utt_per_sec": round(
                        float(np.mean([m.throughput_utt_s for m in history if m.throughput_utt_s]))
                    )
                    if history
                    else None,
                    "overfit": detect_overfit(history),
                }
            )
            for m in history:
                epoch_rows.append(
                    {
                        "model": spec.label,
                        "seed": seed,
                        "epoch": m.epoch,
                        "train_loss": m.train_loss,
                        "dev_loss": m.dev_loss,
                        "dev_eer": m.dev_eer,
                        # per-epoch wall: identical work per epoch means the
                        # column attributes run-to-run wall swings (a slow
                        # first epoch, isolated stalls, or the whole run)
                        "epoch_seconds": m.epoch_seconds,
                        "utt_per_sec": m.throughput_utt_s,
                    }
                )

    ranking_rows = _aggregate(run_rows)
    _write_csvs(output_dir, run_rows, epoch_rows, ranking_rows)
    if make_plots:
        try:
            _write_plots(output_dir, epoch_rows, ranking_rows)
        except ImportError:
            pass
    _write_report(output_dir, run_rows, ranking_rows)
    if print_table:
        _print_ranking(ranking_rows)
    return {"runs": run_rows, "epochs": epoch_rows, "ranking": ranking_rows}


def _aggregate(run_rows: list[dict]) -> list[dict]:
    by_model: dict[str, list[dict]] = {}
    for r in run_rows:
        by_model.setdefault(r["model"], []).append(r)
    ranking = []
    for model, rows in by_model.items():
        eers = [r["best_dev_eer"] for r in rows if r["best_dev_eer"] is not None]
        ranking.append(
            {
                "model": model,
                "n_runs": len(rows),
                "mean_best_eer": float(np.mean(eers)) if eers else None,
                "std_best_eer": float(np.std(eers)) if eers else None,
                "min_best_eer": float(np.min(eers)) if eers else None,
                "mean_wall_seconds": float(np.mean([r["wall_seconds"] for r in rows])),
                "any_overfit": any(r["overfit"] for r in rows),
            }
        )
    ranking.sort(key=lambda r: (r["mean_best_eer"] is None, r["mean_best_eer"]))
    return ranking


def _write_csvs(output_dir, run_rows, epoch_rows, ranking_rows):
    import pandas as pd

    pd.DataFrame(run_rows).to_csv(os.path.join(output_dir, "model_runs.csv"), index=False)
    pd.DataFrame(epoch_rows).to_csv(os.path.join(output_dir, "model_epochs.csv"), index=False)
    pd.DataFrame(ranking_rows).to_csv(os.path.join(output_dir, "model_ranking.csv"), index=False)


def _write_plots(output_dir, epoch_rows, ranking_rows):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    edf = pd.DataFrame(epoch_rows)

    # ranking bar plot
    fig, ax = plt.subplots(figsize=(7, 4))
    models = [r["model"] for r in ranking_rows]
    means = [r["mean_best_eer"] or 0 for r in ranking_rows]
    stds = [r["std_best_eer"] or 0 for r in ranking_rows]
    ax.bar(models, means, yerr=stds, capsize=4)
    ax.set_ylabel("best dev EER (mean ± std)")
    ax.set_title("model ranking")
    plt.xticks(rotation=20, ha="right")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "model_ranking.png"), dpi=120)
    plt.close(fig)

    # One aggregation pass per model feeds every curve artifact: the
    # 3-panel all-model figure, the per-model curve files, and the combined
    # losses plot (the latter two are artifact-file parity with the
    # reference harness, src/benchmark.py:551-605 plots/{model}_curves.png
    # and :672-704 plots/combined_losses.png).
    plots_dir = os.path.join(output_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    fig2, axes = plt.subplots(1, 3, figsize=(14, 4))
    combined_fig, combined_ax = plt.subplots(figsize=(10, 6))
    for model, group in edf.groupby("model"):
        agg = group[["epoch", "train_loss", "dev_loss", "dev_eer"]].groupby("epoch").agg(["mean", "std"])
        epochs = agg.index

        # all-model 3-panel curves
        for ax, col, title in (
            (axes[0], "train_loss", "train loss"),
            (axes[1], "dev_loss", "dev loss"),
            (axes[2], "dev_eer", "dev EER"),
        ):
            mean = agg[(col, "mean")]
            std = agg[(col, "std")].fillna(0)
            ax.plot(epochs, mean, label=model)
            ax.fill_between(epochs, mean - std, mean + std, alpha=0.2)
            ax.set_title(title)
            ax.set_xlabel("epoch")

        # per-model curve file
        fig3, (ax_loss, ax_eer) = plt.subplots(2, 1, figsize=(10, 6))
        for col, label, color in (
            ("train_loss", "train loss", "#4c78a8"),
            ("dev_loss", "dev loss", "#f58518"),
        ):
            mean = agg[(col, "mean")]
            std = agg[(col, "std")].fillna(0)
            ax_loss.plot(epochs, mean, label=label, color=color)
            ax_loss.fill_between(epochs, mean - std, mean + std, alpha=0.2, color=color)
        ax_loss.set_title(f"{model}: loss (mean ± std over seeds)")
        ax_loss.legend()
        eer_mean = agg[("dev_eer", "mean")]
        eer_std = agg[("dev_eer", "std")].fillna(0)
        ax_eer.plot(epochs, eer_mean, label="dev EER", color="#54a24b")
        ax_eer.fill_between(epochs, eer_mean - eer_std, eer_mean + eer_std, alpha=0.2, color="#54a24b")
        ax_eer.set_title(f"{model}: dev EER")
        ax_eer.set_xlabel("epoch")
        fig3.tight_layout()
        fig3.savefig(os.path.join(plots_dir, f"{model}_curves.png"), dpi=120)
        plt.close(fig3)

        # combined losses plot
        combined_ax.plot(epochs, agg[("train_loss", "mean")], label=f"{model} train")
        combined_ax.plot(epochs, agg[("dev_loss", "mean")], linestyle="--", label=f"{model} dev")

    axes[0].legend(fontsize=7)
    fig2.tight_layout()
    fig2.savefig(os.path.join(output_dir, "training_curves.png"), dpi=120)
    plt.close(fig2)

    combined_ax.set_xlabel("epoch")
    combined_ax.set_ylabel("loss")
    combined_ax.set_title("train vs dev loss (all models)")
    combined_ax.legend(ncol=2, fontsize=8)
    combined_fig.tight_layout()
    combined_fig.savefig(os.path.join(plots_dir, "combined_losses.png"), dpi=120)
    plt.close(combined_fig)


def _write_report(output_dir, run_rows, ranking_rows):
    lines = ["# Benchmark report", "", "## Ranking (mean best dev EER)", ""]
    lines.append("| rank | model | runs | mean EER | std | min | mean wall (s) | overfit? |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for i, r in enumerate(ranking_rows, 1):
        lines.append(
            f"| {i} | {r['model']} | {r['n_runs']} | "
            f"{r['mean_best_eer']:.6f} | {r['std_best_eer']:.6f} | {r['min_best_eer']:.6f} | "
            f"{r['mean_wall_seconds']:.1f} | {'yes' if r['any_overfit'] else 'no'} |"
            if r["mean_best_eer"] is not None
            else f"| {i} | {r['model']} | {r['n_runs']} | - | - | - | {r['mean_wall_seconds']:.1f} | - |"
        )
    lines += ["", "## Runs", ""]
    lines.append("| model | seed | best dev EER | best epoch | epochs | wall (s) | utt/s | overfit |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for r in run_rows:
        eer = f"{r['best_dev_eer']:.6f}" if r["best_dev_eer"] is not None else "-"
        lines.append(
            f"| {r['model']} | {r['seed']} | {eer} | {r['best_epoch']} | "
            f"{r['epochs_run']} | {r['wall_seconds']} | {r['mean_utt_per_sec']} | "
            f"{'yes' if r['overfit'] else 'no'} |"
        )
    walls = [r["wall_seconds"] for r in run_rows if r["wall_seconds"]]
    if walls and max(walls) > 1.5 * min(walls):
        lines += [
            "",
            f"**Wall-clock spread:** {min(walls):.0f}-{max(walls):.0f} s across "
            "runs of identical per-epoch work. Per-epoch `epoch_seconds` in "
            "`model_epochs.csv` attributes it: a slow FIRST epoch is warm-up "
            "(cuDNN's algorithm search, the allocator), isolated slow later "
            "epochs are host stalls, a uniform slowdown is the run itself. "
            "EER columns are unaffected either way.",
        ]
    lines += ["", "## Plots", ""]
    lines.append("- ranking: `model_ranking.png`")
    lines.append("- all-model curves: `training_curves.png`")
    lines.append("- combined: `plots/combined_losses.png`")
    for model in sorted({r["model"] for r in run_rows}):
        lines.append(f"- {model}: `plots/{model}_curves.png`")
    with open(os.path.join(output_dir, "benchmark_report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _print_ranking(ranking_rows):
    try:
        from rich.console import Console
        from rich.table import Table

        table = Table(title="benchmark ranking")
        for col in ("rank", "model", "runs", "mean best EER", "std", "min", "overfit"):
            table.add_column(col, justify="right")
        for i, r in enumerate(ranking_rows, 1):
            table.add_row(
                str(i), r["model"], str(r["n_runs"]),
                "-" if r["mean_best_eer"] is None else f"{r['mean_best_eer']:.6f}",
                "-" if r["std_best_eer"] is None else f"{r['std_best_eer']:.6f}",
                "-" if r["min_best_eer"] is None else f"{r['min_best_eer']:.6f}",
                "yes" if r["any_overfit"] else "no",
            )
        Console().print(table)
    except ImportError:
        for i, r in enumerate(ranking_rows, 1):
            print(i, r["model"], r["mean_best_eer"])
