"""``python -m dfac_tpu_torch.cli.compare_kernels`` — CNN1D kernel-size A/B study.

Counterpart of :mod:`dfac_tpu.cli.compare_kernels`; parity target reference
``src/compare_kernels.py`` — train
``CNN1DVariant`` with configurable kernel sizes under different input
normalizations ((3,3,3)-raw, (5,3,3)-raw, (5,3,3)+cmn, (5,3,3)+cvmn by
default) and save checkpoints with embedded experiment metadata
(reference ``:178-184``). The same flags, lines and checkpoints, with
``--device`` defaulting to ``cuda`` (no implicit fallback).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from dfac_tpu_torch.cli.common import add_data_args, add_swap_tf_args, set_seed


DEFAULT_EXPERIMENTS = "3,3,3:raw;5,3,3:raw;5,3,3:cmn;5,3,3:cvmn"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Compare CNN1D kernel-size variants.")
    add_data_args(p)
    p.add_argument(
        "--experiments", default=DEFAULT_EXPERIMENTS,
        help="semicolon list of k1,k2,k3:scheme specs",
    )
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--early-stop", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--label-smoothing", type=float, default=0.05)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints/kernel_compare")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    add_swap_tf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)

    from dfac_tpu_torch.data.normalizer import apply_utterance_norm
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.models import build_model, model_width, width_overrides
    from dfac_tpu_torch.train import checkpoint as ckpt_lib
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer
    from dfac_tpu_torch.utils.convert import jax_from_state_dict

    train_ds = load_dataset(args.train_features, args.train_labels)
    dev_ds = load_dataset(args.dev_features, args.dev_labels)

    rows = []
    for spec in args.experiments.split(";"):
        kern_s, _, scheme = spec.partition(":")
        kernels = tuple(int(k) for k in kern_s.split(","))
        scheme = scheme or "raw"
        label = f"k{'-'.join(map(str, kernels))}_{scheme}"

        tr = dataclasses.replace(train_ds, features=apply_utterance_norm(train_ds.features, scheme))
        dv = dataclasses.replace(dev_ds, features=apply_utterance_norm(dev_ds.features, scheme))
        cfg = TrainConfig(
            model="cnn1d_variant", batch_size=args.batch_size, epochs=args.epochs,
            lr=args.lr, early_stop=args.early_stop, label_smoothing=args.label_smoothing,
            in_features=args.in_features, seed=args.seed, swap_tf=args.swap_tf,
        )
        model = build_model(
            "cnn1d_variant", **width_overrides(model_width(train_ds.features.shape, args.swap_tf)),
            kernel_sizes=kernels,
        )
        trainer = Trainer(cfg, device=args.device, model=model)
        result = trainer.fit(tr, dv)
        rows.append({"experiment": label, "dev_eer": result["best_eer"]})
        print(f"[{label}] best dev EER = {result['best_eer']:.6f}")

        os.makedirs(args.checkpoint_dir, exist_ok=True)
        ckpt_lib.save_checkpoint(
            os.path.join(args.checkpoint_dir, f"{label}.ckpt"),
            # best-epoch weights — the config records best_dev_eer, so the
            # saved model must be the one that achieved it
            jax_from_state_dict(trainer.best_variables(), "cnn1d_variant"),
            # the epoch that PRODUCED these weights, not the last one run
            epoch=next(
                (m.epoch for m in reversed(result["history"]) if m.is_best),
                len(result["history"]),
            ),
            config={
                "model": "cnn1d_variant", "kernel_sizes": list(kernels),
                "normalization": scheme, "seed": args.seed,
                "best_dev_eer": result["best_eer"],
            },
        )

    print("\nexperiment          dev EER")
    for row in rows:
        print(f"{row['experiment']:<18s}  {row['dev_eer']:.6f}")
    return rows


if __name__ == "__main__":
    main()
