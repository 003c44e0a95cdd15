"""``python -m dfac_tpu_torch.cli.benchmark`` — multi-model / multi-seed sweep CLI.

Counterpart of ``dfac-benchmark`` (:mod:`dfac_tpu.cli.benchmark`); parity
target reference ``src/benchmark.py:707-829`` flags: ``--models
cnn2d,cnn2d+specaug --seeds 0,1,2`` sweeps with CSV/plot/markdown outputs
under a timestamped directory. The same flags and outputs, with
``--device`` defaulting to ``cuda`` (no implicit fallback).
"""

from __future__ import annotations

import argparse
import datetime
import os

from dfac_tpu_torch.cli.common import add_augment_args, add_data_args, add_swap_tf_args, augment_config_from_args


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Benchmark a set of models over seeds.")
    add_data_args(p)
    p.add_argument("--models", default="cnn2d",
                   help="comma list of specs, e.g. cnn2d,cnn2d+specaug,cnn1d")
    p.add_argument("--seeds", default="0", help="comma list of seeds")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--early-stop", type=int, default=0)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--output-dir", default=None,
                   help="default: results/benchmark_<timestamp>")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--device-resident", action="store_true",
                   help="device-resident corpora (one upload per run, on-device batching)")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    add_augment_args(p)
    add_swap_tf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.train.benchmark_harness import parse_model_specs, run_benchmark
    from dfac_tpu_torch.train.loop import TrainConfig

    output_dir = args.output_dir or os.path.join(
        "results", f"benchmark_{datetime.datetime.now():%Y%m%d_%H%M%S}"
    )
    train_ds = load_dataset(args.train_features, args.train_labels)
    dev_ds = load_dataset(args.dev_features, args.dev_labels)

    base_cfg = TrainConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        early_stop=args.early_stop,
        label_smoothing=args.label_smoothing,
        in_features=args.in_features,
        dropout=args.dropout,
        swap_tf=args.swap_tf,
        augment=augment_config_from_args(args),
        device_resident=args.device_resident,
    )
    result = run_benchmark(
        train_ds, dev_ds,
        parse_model_specs(args.models),
        [int(s) for s in args.seeds.split(",")],
        base_cfg, output_dir,
        make_plots=not args.no_plots,
        device=args.device,
    )
    print(f"benchmark outputs written to {output_dir}")
    return result


if __name__ == "__main__":
    main()
