"""``python -m dfac_tpu_torch.cli.train_cae`` — CAE anomaly-model training CLI.

Counterpart of ``dfac-train-cae`` (:mod:`dfac_tpu.cli.train_cae`), parity
target reference ``src/train_cae.py:108-163``: bonafide-only
reconstruction training with the normalizer fitted on the training split
(or loaded with ``--normalizer``), the rich live dashboard (plain lines
with ``--no-rich`` or where ``rich`` is not installed, nothing with
``--quiet``), and the ``cae_best.ckpt`` / ``cae_last.ckpt`` /
``normalizer.npz`` artifacts. The same flags and final line, with
``--device`` defaulting to ``cuda`` (no implicit fallback; ``--device
cpu`` runs on the CPU). Trains in f32 on one device or, with
``--data-parallel N``, on N (one process each; rank 0 prints and writes
the artifacts), host-fed, ``--device-resident``, streamed in chunks
(``--resident-chunk-batches``, ``--chunk-ingest``) or as one
``--fused-fit`` run, with the BatchNorm freeze tail
(``--bn-freeze-after``; ``--train-fast`` is a 0.5 tail: the CAE has no
dropout), ``--profile-dir`` tracing the fit. ``--multihost`` trains
data-parallel over the ranks of a cluster of processes
(:mod:`dfac_tpu_torch.parallel.multihost`; the coordinator writes the
artifacts); ``--checkpoint-format orbax`` exits non-zero: orbax is not
ported.
"""

from __future__ import annotations

import argparse

from dfac_tpu_torch.cli.common import (
    DATA_PARALLEL_HELP,
    FREEZE_HELP,
    add_data_args,
    add_multihost_args,
    add_stream_args,
    joined,
    check_stream_args,
    refuse_unported_training,
    run_training,
    set_seed,
    train_device,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the ConvAutoencoder on bonafide-only data (PyTorch).")
    add_data_args(p)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--lr-scheduler-patience", type=int, default=7)
    p.add_argument("--lr-scheduler-factor", type=float, default=0.5)
    p.add_argument("--early-stop", type=int, default=10)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--normalizer", default=None,
                   help="load an existing normalizer (.npz or torch .pt) instead of fitting")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device-resident", action="store_true",
                   help="upload the bonafide corpus to the card once; gather batches there")
    add_stream_args(p, "the WHOLE run (epochs + validation + best rule + plateau + early stop) over a "
                       "device-resident corpus, with no live UI")
    p.add_argument("--data-parallel", type=int, default=0, help=DATA_PARALLEL_HELP)
    p.add_argument("--bn-freeze-after", type=float, default=0.0, metavar="FRAC",
                   help=FREEZE_HELP + "; every BatchNorm, encoder and decoder")
    p.add_argument("--train-fast", action="store_true",
                   help="opt-in fast-numerics recipe: the CAE has no dropout, so this is the BN freeze tail "
                        "(2nd half of the schedule)")
    add_multihost_args(p)
    p.add_argument("--checkpoint-format", choices=("pickle", "orbax"), default="pickle",
                   help="checkpoint layout (orbax is not ported: it imports JAX)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the fit into this directory")
    p.add_argument("--no-rich", action="store_true")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.train_fast and not args.bn_freeze_after:
        args.bn_freeze_after = 0.5
    check_stream_args(p, args)
    return args


def main(argv=None):
    args = parse_args(argv)
    refuse_unported_training(args)
    set_seed(args.seed)

    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.data.pipeline import load_dataset

    with joined(args) as cluster:  # join the cluster before the data is read
        train_ds = load_dataset(args.train_features, args.train_labels)
        dev_ds = load_dataset(args.dev_features, args.dev_labels)
        normalizer = FeatureNormalizer.load(args.normalizer) if args.normalizer else None
        return run_training(_fit, args, train_ds, dev_ds, normalizer, cluster=cluster)


def _fit(args, train_ds, dev_ds, normalizer):
    """The run after the data is read: in this process, or on each rank of
    ``--data-parallel`` or ``--multihost`` (rank 0 prints and writes); the fit's result."""
    from dfac_tpu_torch.obs.cae_dashboard import create_cae_visualizer
    from dfac_tpu_torch.obs.profiling import trace
    from dfac_tpu_torch.parallel.data_parallel import main_process
    from dfac_tpu_torch.train.cae_loop import CAEConfig, CAETrainer

    set_seed(args.seed)
    main = main_process()
    cfg = CAEConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        lr_scheduler_patience=args.lr_scheduler_patience,
        lr_scheduler_factor=args.lr_scheduler_factor,
        early_stop=args.early_stop,
        base_channels=args.base_channels,
        seed=args.seed,
        device_resident=args.device_resident or args.fused_fit,
        resident_chunk_batches=args.resident_chunk_batches,
        chunk_ingest=args.chunk_ingest,
        bn_freeze_after_frac=args.bn_freeze_after,
        data_parallel=args.data_parallel,
        multihost=args.multihost,
    )
    visualizer = create_cae_visualizer("noop" if args.quiet or not main else ("plain" if args.no_rich else "rich"))
    trainer = CAETrainer(cfg, visualizer=visualizer, device=train_device(args))
    fit = trainer.fit_fused if args.fused_fit else trainer.fit
    with trace(args.profile_dir if main else None):
        result = fit(train_ds, dev_ds, checkpoint_dir=args.checkpoint_dir, normalizer=normalizer)
    if main:
        print(f"best val reconstruction MSE: {result['best_val_mse']:.6f}")
    return result


if __name__ == "__main__":
    main()
