"""``python -m dfac_tpu_torch.cli.reproduce_reference`` — one command that
reproduces the reference's published result on its real data layout and
checks the BASELINE contract.

Counterpart of ``dfac-reproduce-reference``
(:mod:`dfac_tpu.cli.reproduce_reference`): the same recipe, report and
contract assertion, trained by the port on ``--device`` (default
``cuda``, no implicit fallback), in f32 or ``--bf16``.

The reference's headline quality numbers come from its "Robust Training
Recipe" (the reference's ``results/final_submission_report.md`` §2,
``results/archive/20260206_final_prep/model_prediction_report.md`` §1):
CNN2D with SpecAugment (time 0.20 / feature 0.10), time shift 0.10,
channel drop 0.05, gaussian jitter 0.005, label smoothing 0.05, plateau
LR on dev EER, early stop 8, seed 2 — reaching dev EER 0.001005
(2000 utts) and test1 EER 0.000000 (500 utts).

This command, pointed at the reference's ``data/`` directory (the Zenodo
layout: ``train/{features,labels}.pkl``, ``dev/{features,labels}.pkl``,
``test1/features.pkl`` [+ optional labels]), runs that exact recipe
through the port's trainer, scores dev and test1, writes
``prediction.pkl`` + a report, and asserts the BASELINE.md contract:
dev EER within 0.1% absolute of the reference's 0.001005 (and test1
within 0.1% of 0.0 when test1 labels exist).

The real corpus is not in this repository, so the runbook is dry-tested end-to-end on a synthetic fixture shaped exactly
like the real pickles ([180, 321] torch.Tensor cells, ``raw_*`` uttids)
in ``tests/test_reproduce_reference.py`` (the port's run:
``tests/test_torch_port_train_cli.py``).
"""

from __future__ import annotations

import argparse
import os

# the reference robust run's dev result; test1 was exactly 0 (BASELINE.md)
REF_DEV_EER = 0.001005
REF_TEST1_EER = 0.0
CONTRACT_ABS = 0.001  # BASELINE.md: within 0.1% absolute


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Reproduce the reference's robust CNN2D result on its "
        "data/ layout and assert the 0.1%-absolute EER contract."
    )
    p.add_argument("--data-dir", required=True,
                   help="the reference's data directory (train/ dev/ test1/)")
    p.add_argument("--out-dir", default="results/reproduce_reference")
    p.add_argument("--epochs", type=int, default=30,
                   help="schedule length; early stop 8 halts it like the reference")
    p.add_argument("--batch-size", type=int, default=32,
                   help="the reference's batch size; raise (e.g. 512) for throughput")
    p.add_argument("--seed", type=int, default=2, help="the reference run's seed")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--device-resident", action="store_true",
                   help="upload the corpus to the card once; gather batches there")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (f32 parameters)")
    p.add_argument("--expect-dev-eer", type=float, default=REF_DEV_EER,
                   help="reference dev EER to check against (default: the "
                        "published robust-run value)")
    p.add_argument("--expect-test1-eer", type=float, default=REF_TEST1_EER)
    p.add_argument("--no-assert", dest="do_assert", action="store_false",
                   help="report the deltas without failing the process")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from dfac_tpu_torch.data.augment import AugmentConfig
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.ops.eer import calculate_eer
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    def split(name, labeled=True):
        f = os.path.join(args.data_dir, name, "features.pkl")
        lab = os.path.join(args.data_dir, name, "labels.pkl")
        if labeled and not os.path.exists(lab):
            lab = None
        return load_dataset(f, lab)

    train_ds = split("train")
    dev_ds = split("dev")
    test1_ds = split("test1")
    in_features = train_ds.features.shape[1]

    # the reference's robust recipe, verbatim knobs
    cfg = TrainConfig(
        model="cnn2d",
        in_features=in_features,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=1e-3,
        early_stop=8,
        lr_scheduler="plateau",
        lr_scheduler_metric="dev_eer",
        label_smoothing=0.05,
        seed=args.seed,
        device_resident=args.device_resident,
        compute_dtype="bfloat16" if args.bf16 else None,
        augment=AugmentConfig(
            spec_augment=True, time_mask_ratio=0.20,
            feature_mask=True, feature_mask_ratio=0.10,
            time_shift=True, time_shift_ratio=0.10,
            channel_drop=True, channel_drop_prob=0.05,
            gaussian_jitter=True, gaussian_jitter_std=0.005,
        ),
    )
    os.makedirs(args.out_dir, exist_ok=True)
    trainer = Trainer(cfg, device=args.device)
    result = trainer.fit(
        train_ds, dev_ds,
        checkpoint_dir=os.path.join(args.out_dir, "checkpoints"),
    )

    # sigmoid scores, matching the reference predict CLI's prediction.pkl
    # contract (src/predict.py: probabilities in [0, 1]); EER is
    # rank-invariant so the contract check is unaffected
    trainer.model.load_state_dict(trainer.best_variables())
    dev_scores = predict_scores(trainer.model, dev_ds, cfg.batch_size, apply_sigmoid=True)
    dev_eer, _ = calculate_eer(dev_scores, dev_ds.labels)

    test1_scores = predict_scores(trainer.model, test1_ds, cfg.batch_size, apply_sigmoid=True)
    write_predictions(
        os.path.join(args.out_dir, "prediction.pkl"), test1_ds.uttids, test1_scores
    )
    test1_eer = None
    if test1_ds.labels is not None:
        test1_eer, _ = calculate_eer(test1_scores, test1_ds.labels)

    dev_delta = abs(dev_eer - args.expect_dev_eer)
    lines = [
        "# Reference reproduction report",
        "",
        f"Recipe: robust CNN2D (seed {args.seed}, {args.epochs} epochs max, "
        f"early stop 8, plateau on dev EER, label smoothing 0.05, "
        f"SpecAug 0.20/0.10 + shift 0.10 + drop 0.05 + jitter 0.005)",
        f"Data: {args.data_dir} (train {len(train_ds)} / dev {len(dev_ds)} / "
        f"test1 {len(test1_ds)})",
        "",
        f"| split | EER | reference | delta | contract ({CONTRACT_ABS} abs) |",
        "|---|---|---|---|---|",
        f"| dev | {dev_eer:.6f} | {args.expect_dev_eer:.6f} | {dev_delta:+.6f} | "
        f"{'PASS' if dev_delta <= CONTRACT_ABS else 'FAIL'} |",
    ]
    ok = dev_delta <= CONTRACT_ABS
    if test1_eer is not None:
        t_delta = abs(test1_eer - args.expect_test1_eer)
        lines.append(
            f"| test1 | {test1_eer:.6f} | {args.expect_test1_eer:.6f} | "
            f"{t_delta:+.6f} | {'PASS' if t_delta <= CONTRACT_ABS else 'FAIL'} |"
        )
        ok = ok and t_delta <= CONTRACT_ABS
    else:
        lines.append("| test1 | (no labels: prediction.pkl written) | — | — | — |")
    lines += [
        "",
        f"Best dev EER during training {result['best_eer']:.6f} over "
        f"{len(result['history'])} trained epochs.",
    ]
    report = os.path.join(args.out_dir, "report.md")
    with open(report, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {report}")
    if args.do_assert and not ok:
        print("CONTRACT FAILED: EER outside the 0.1%-absolute band")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
