"""``python -m dfac_tpu_torch.cli.train`` — supervised training CLI.

Counterpart of ``dfac-train`` (:mod:`dfac_tpu.cli.train`), parity target
reference ``src/train.py:94-246``: the same flags, with ``--device``
defaulting to ``cuda`` (no implicit fallback; ``--device cpu`` runs on the
CPU). Trains every ``--model`` choice on one device or, with
``--data-parallel N``, on N devices (one process each, BatchNorm synced
across them; :mod:`dfac_tpu_torch.parallel`), in f32 or ``--bf16``
(the families that take a compute dtype: CNN2D and CNN1D; the zoo trains
in f32, as in JAX), host-fed, ``--device-resident`` or streamed in chunks
(``--resident-chunk-batches G``, ``--chunk-ingest f32|bf16|int8``), or as
one ``--fused-fit`` run (resident, no display; it writes the best and
last checkpoints at the end, as the JAX CLI does); the BatchNorm
freeze tail (``--bn-freeze-after FRAC``, ``--train-fast``: dropout 0 and
a 0.5 tail); ``--resume``, ``--run-name``, ``--debug-augment-stats`` and
``--profile-dir`` (a ``torch.profiler`` Chrome trace of the fit) work. The
display is the rich dashboard, ``--no-rich`` tqdm and ``--quiet`` none
(the JAX CLI's ``create_visualizer`` chain), shown by rank 0 of a
data-parallel run, which alone prints and writes checkpoints.
``--multihost`` trains data-parallel over the ranks of a cluster of
processes (:mod:`dfac_tpu_torch.parallel.multihost`: one copy of the CLI a
host, joined at ``--coordinator-address``); ``--device-resident`` and
``--fused-fit`` then keep the whole corpus on every rank, and
``--resume`` is read by the coordinator alone. ``--checkpoint-format
orbax`` exits non-zero: orbax is not ported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dfac_tpu_torch.cli.common import (
    DATA_PARALLEL_HELP,
    FREEZE_HELP,
    add_augment_args,
    add_data_args,
    add_multihost_args,
    add_stream_args,
    add_swap_tf_args,
    augment_config_from_args,
    check_stream_args,
    joined,
    refuse_unported_training,
    run_training,
    set_seed,
    train_device,
)

MODELS = [
    "cnn2d", "cnn1d", "meanpool_mlp", "statspool_mlp", "cnn1d_spatial",
    "cnn1d_archive", "cnn2d_spatial", "crnn", "crnn2", "cnn2d_robust",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a model for audio deepfake detection (PyTorch).")
    add_data_args(p)
    p.add_argument("--model", default="cnn2d", choices=MODELS)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=2,
                   help="accepted for reference-CLI compatibility (a prefetch thread feeds the card)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--early-stop", type=int, default=0, help="patience in epochs (0 disables)")
    p.add_argument("--lr-scheduler", default="none", choices=["none", "plateau"])
    p.add_argument("--lr-scheduler-metric", default="dev_eer", choices=["dev_eer", "dev_loss"])
    p.add_argument("--lr-scheduler-factor", type=float, default=0.5)
    p.add_argument("--lr-scheduler-patience", type=int, default=2)
    p.add_argument("--lr-scheduler-threshold", type=float, default=1e-4)
    p.add_argument("--lr-scheduler-min-lr", type=float, default=1e-6)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--run-name", default="",
                   help="optional subfolder under --checkpoint-dir for outputs")
    p.add_argument("--no-rich", action="store_true", help="tqdm bars instead of the rich dashboard")
    p.add_argument("--quiet", action="store_true", help="noop visualizer (CI)")
    p.add_argument("--seed", type=int, default=0)
    add_augment_args(p)
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="label smoothing epsilon in [0, 0.5)")
    p.add_argument("--debug-augment-stats", action="store_true",
                   help="print feature stats before/after augmentation on the first batch")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (f32 parameters)")
    p.add_argument("--data-parallel", type=int, default=0, help=DATA_PARALLEL_HELP)
    p.add_argument("--checkpoint-format", choices=("pickle", "orbax"), default="pickle",
                   help="checkpoint layout (orbax is not ported: it imports JAX)")
    p.add_argument("--device-resident", action="store_true",
                   help="upload the training corpus to the card once; gather batches there")
    add_stream_args(p, "run the ENTIRE training loop (epochs+eval+plateau+early-stop) over a device-resident "
                       "corpus (implies --device-resident; no live UI)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume training from a checkpoint (model+optimizer+scheduler+epoch)")
    p.add_argument("--bn-freeze-after", type=float, default=0.0, metavar="FRAC", help=FREEZE_HELP)
    p.add_argument("--train-fast", action="store_true",
                   help="opt-in fast-numerics recipe: dropout-free training plus a BN freeze tail (2nd half of "
                        "the schedule)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the fit into this directory")
    add_multihost_args(p)
    add_swap_tf_args(p)
    args = p.parse_args(argv)
    if args.train_fast:
        # the JAX CLI's recipe: no dropout and the BN freeze tail; composes with every training mode
        args.dropout = 0.0
        if not args.bn_freeze_after:
            args.bn_freeze_after = 0.5
    check_stream_args(p, args)
    return args


def _debug_augment_stats(augment_fn, feats_swapped, device) -> None:
    """First-batch before/after quantile dump (reference ``src/train.py:390-430``)."""
    import torch

    def stats(x):
        flat = np.asarray(x).reshape(-1)
        q01, q50, q99 = np.quantile(flat, [0.01, 0.50, 0.99])
        return (
            f"shape={tuple(x.shape)} min={flat.min():.4f} q01={q01:.4f} "
            f"median={q50:.4f} q99={q99:.4f} max={flat.max():.4f} "
            f"mean={flat.mean():.4f} std={flat.std():.4f} "
            f"zero%={100 * (flat == 0).mean():.4f}"
        )

    print("[augment-stats] before:", stats(feats_swapped))
    if augment_fn is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        out = augment_fn(torch.as_tensor(feats_swapped, device=device), gen)
        print("[augment-stats] after: ", stats(out.cpu().numpy()))
    else:
        print("[augment-stats] after:  (no augmentation enabled)")


def main(argv=None):
    args = parse_args(argv)
    refuse_unported_training(args)
    set_seed(args.seed)

    from dfac_tpu_torch.data.pipeline import load_dataset

    with joined(args) as cluster:  # join the cluster before the data is read
        train_ds = load_dataset(args.train_features, args.train_labels)
        dev_ds = load_dataset(args.dev_features, args.dev_labels)
        return run_training(_fit, args, train_ds, dev_ds, cluster=cluster)


def _fit(args, train_ds, dev_ds):
    """The run after the data is read: in this process, or on each rank of
    ``--data-parallel`` or ``--multihost`` (rank 0 prints and writes); the
    fit's result."""
    from dfac_tpu_torch.obs.factory import create_visualizer
    from dfac_tpu_torch.parallel.data_parallel import main_process
    from dfac_tpu_torch.train.checkpoint import build_config_dict
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    set_seed(args.seed)
    main = main_process()
    checkpoint_root = args.checkpoint_dir
    if args.run_name:
        checkpoint_root = os.path.join(checkpoint_root, args.run_name)
    if not main:
        checkpoint_root = None  # one rank writes; every rank holds the same model

    cfg = TrainConfig(
        model=args.model,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        early_stop=args.early_stop,
        lr_scheduler=args.lr_scheduler,
        lr_scheduler_metric=args.lr_scheduler_metric,
        lr_scheduler_factor=args.lr_scheduler_factor,
        lr_scheduler_patience=args.lr_scheduler_patience,
        lr_scheduler_threshold=args.lr_scheduler_threshold,
        lr_scheduler_min_lr=args.lr_scheduler_min_lr,
        in_features=args.in_features,
        hidden_dim=args.hidden_dim,
        dropout=args.dropout,
        seed=args.seed,
        label_smoothing=args.label_smoothing,
        swap_tf=args.swap_tf,
        augment=augment_config_from_args(args),
        compute_dtype="bfloat16" if args.bf16 else None,
        device_resident=args.device_resident or args.fused_fit,
        resident_chunk_batches=args.resident_chunk_batches,
        chunk_ingest=args.chunk_ingest,
        bn_freeze_after_frac=args.bn_freeze_after,
        data_parallel=args.data_parallel,
        multihost=args.multihost,
    )
    visualizer = create_visualizer("noop" if args.quiet or not main else ("tqdm" if args.no_rich else "rich"))
    trainer = Trainer(cfg, visualizer=visualizer, device=train_device(args))

    if args.debug_augment_stats and main:
        first = train_ds.features[: args.batch_size]
        feats = np.transpose(first, (0, 2, 1)) if args.swap_tf else first
        _debug_augment_stats(trainer.augment_fn, np.ascontiguousarray(feats, np.float32), trainer.device)

    from dfac_tpu_torch.obs.profiling import trace

    with trace(args.profile_dir if main else None):
        if args.fused_fit:
            result = trainer.fit_fused(train_ds, dev_ds, resume_from=args.resume)
            if checkpoint_root:
                _save_fused(trainer, result, checkpoint_root, args, build_config_dict(args))
        else:
            result = trainer.fit(
                train_ds, dev_ds, checkpoint_dir=checkpoint_root,
                config_snapshot=build_config_dict(args),
                resume_from=args.resume,
            )
    if result["best_eer"] is not None and main:
        print(f"best dev EER: {result['best_eer']:.6f}")
    return result


def _save_fused(trainer, result: dict, checkpoint_root: str, args, config: dict) -> None:
    """The JAX CLI's checkpoints after a fused fit (``dfac_tpu/cli/train.py:219-244``):
    ``*_best.ckpt`` only when an epoch of this run improved (a resumed run
    keeps its better best), ``*_last.ckpt`` only when an epoch ran (a
    resume with nothing left keeps its resume point)."""
    os.makedirs(checkpoint_root, exist_ok=True)
    trainer_state = {
        "best_eer": result["best_eer"], "best_train_loss": result["best_train_loss"],
        "best_dev_loss": result["best_dev_loss"], "epochs_no_improve": result["epochs_no_improve"],
        "lr": trainer._lr,
    }
    if any(m.is_best for m in result["history"]):
        trainer.save_checkpoint_file(os.path.join(checkpoint_root, f"{args.model}_best.ckpt"),
                                     epoch=result["best_epoch"], variables=trainer.best_variables(),
                                     config_snapshot=config, trainer_state=trainer_state)
    if result["history"]:
        trainer.save_checkpoint_file(os.path.join(checkpoint_root, f"{args.model}_last.ckpt"),
                                     epoch=result["history"][-1].epoch, config_snapshot=config,
                                     trainer_state=trainer_state)


if __name__ == "__main__":
    main()
