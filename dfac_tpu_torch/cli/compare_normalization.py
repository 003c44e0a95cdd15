"""``python -m dfac_tpu_torch.cli.compare_normalization`` — normalization A/B study.

Counterpart of :mod:`dfac_tpu.cli.compare_normalization`; parity target
reference ``src/compare_normalization.py`` — train
CNN2D under raw vs per-utterance CMN vs CVMN input normalization (defaults:
30 epochs, early-stop 8, label smoothing 0.05) and print a dev(+test) EER
comparison table. The same flags and lines, with ``--device`` defaulting
to ``cuda`` (no implicit fallback).
"""

from __future__ import annotations

import argparse
import dataclasses

from dfac_tpu_torch.cli.common import add_data_args, add_swap_tf_args, set_seed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Compare input normalization schemes for CNN2D.")
    add_data_args(p)
    p.add_argument("--test-features", default=None)
    p.add_argument("--test-labels", default=None)
    p.add_argument("--schemes", default="raw,cmn,cvmn")
    p.add_argument("--model", default="cnn2d")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--early-stop", type=int, default=8)
    p.add_argument("--label-smoothing", type=float, default=0.05)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    add_swap_tf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)

    from dfac_tpu_torch.data.normalizer import apply_utterance_norm
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.train.evaluate import evaluate_classifier
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    train_ds = load_dataset(args.train_features, args.train_labels)
    dev_ds = load_dataset(args.dev_features, args.dev_labels)
    test_ds = (
        load_dataset(args.test_features, args.test_labels)
        if args.test_features and args.test_labels
        else None
    )

    rows = []
    for scheme in args.schemes.split(","):
        scheme = scheme.strip()
        tr = dataclasses.replace(train_ds, features=apply_utterance_norm(train_ds.features, scheme))
        dv = dataclasses.replace(dev_ds, features=apply_utterance_norm(dev_ds.features, scheme))
        cfg = TrainConfig(
            model=args.model, batch_size=args.batch_size, epochs=args.epochs,
            lr=args.lr, early_stop=args.early_stop, label_smoothing=args.label_smoothing,
            in_features=args.in_features, seed=args.seed, swap_tf=args.swap_tf,
        )
        trainer = Trainer(cfg, device=args.device)
        result = trainer.fit(tr, dv)
        row = {"scheme": scheme, "dev_eer": result["best_eer"]}
        if test_ds is not None:
            ts = dataclasses.replace(test_ds, features=apply_utterance_norm(test_ds.features, scheme))
            # best-epoch weights (the model that achieved dev_eer), not
            # the final epoch's — early stopping trains past the best
            trainer.model.load_state_dict(trainer.best_variables())
            metrics, _, _ = evaluate_classifier(
                trainer.model, ts, batch_size=args.batch_size, swap_tf=args.swap_tf,
            )
            row["test_eer"] = metrics["eer"]
        rows.append(row)
        print(f"[{scheme}] dev EER = {row['dev_eer']:.6f}"
              + (f"  test EER = {row['test_eer']:.6f}" if "test_eer" in row else ""))

    print("\nscheme     dev EER" + ("     test EER" if test_ds is not None else ""))
    for row in rows:
        line = f"{row['scheme']:<10s} {row['dev_eer']:.6f}"
        if "test_eer" in row:
            line += f"   {row['test_eer']:.6f}"
        print(line)
    return rows


if __name__ == "__main__":
    main()
