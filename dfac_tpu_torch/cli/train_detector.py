"""``python -m dfac_tpu_torch.cli.train_detector`` — dlqueen detector train + predict.

Counterpart of :mod:`dfac_tpu.cli.train_detector`, parity target
reference ``src/dlqueen_model.py:266-448`` main(): train the
DeepfakeDetector with weighted sampling, pos_weight BCE, EMA and gradient
clipping, then score a test split and write ``prediction.pkl`` (logits by
default, ``--use-prob`` for sigmoid), printing the EER when the test split
has labels. ``--epochs 0`` scores ``--ckpt-path`` without training;
``--fast`` scores through the folded chain (f32 by default, ``--bf16``
for bf16 activations). The same flags and lines, with ``--device``
defaulting to ``cuda`` (no implicit fallback; ``--device cpu`` runs on
the CPU). Trains on one device or, with ``--data-parallel N``, on N (one
process each; rank 0 prints its training line and writes the checkpoint,
then this process scores the test split), in f32 or ``--bf16`` (the model in bf16,
which then scores the test split without ``--fast``, as in JAX), host-fed,
``--device-resident``, streamed in chunks (``--resident-chunk-batches``,
``--chunk-ingest``) or as one ``--fused-fit`` run, with the BatchNorm
freeze tail (``--bn-freeze-after``; ``--train-fast``: both dropouts 0 and
a 0.5 tail), ``--profile-dir`` tracing the fit. ``--multihost`` trains
data-parallel over the ranks of a cluster of processes
(:mod:`dfac_tpu_torch.parallel.multihost`): the coordinator writes the
checkpoint and alone scores the test split; ``--checkpoint-format orbax``
exits non-zero: orbax is not ported.
"""

from __future__ import annotations

import argparse
import os

from dfac_tpu_torch.cli.common import (
    DATA_PARALLEL_HELP,
    FREEZE_HELP,
    add_multihost_args,
    add_stream_args,
    joined,
    check_stream_args,
    refuse_unported_training,
    run_training,
    train_device,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/predict the DeepfakeDetector (dlqueen recipe, PyTorch).")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--train-split", default="train")
    p.add_argument("--dev-split", default="dev")
    p.add_argument("--test-split", default="test2")
    p.add_argument("--ckpt-path", default="best_model.ckpt")
    p.add_argument("--prediction-pkl", default="prediction.pkl")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--encoder-dropout", type=float, default=0.2,
                   help="per-block encoder dropout (reference ConvEncoder default)")
    p.add_argument("--bn-freeze-after", type=float, default=0.0, metavar="FRAC",
                   help=FREEZE_HELP + ". Composes with --ema: the EMA keeps averaging params over frozen stats")
    p.add_argument("--train-fast", action="store_true",
                   help="opt-in fast-numerics recipe: dropout-free training (head + encoder) plus a BN freeze "
                        "tail (2nd half of the schedule)")
    p.add_argument("--use-prob", action="store_true", help="save sigmoid probs instead of logits")
    p.add_argument("--specaug", action="store_true")
    p.add_argument("--time-mask-max", type=int, default=30)
    p.add_argument("--time-mask-n", type=int, default=2)
    p.add_argument("--freq-mask-max", type=int, default=24)
    p.add_argument("--freq-mask-n", type=int, default=2)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--patience", type=int, default=6)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 training; with --fast, the bf16 serving chain")
    p.add_argument("--fast", action="store_true",
                   help="score the test split through the folded-BN detector serving chain")
    p.add_argument("--device-resident", action="store_true",
                   help="upload the training corpus to the card once; gather batches there")
    add_stream_args(p, "the WHOLE run (epochs + dev EER + best rule + patience) over a device-resident "
                       "corpus")
    p.add_argument("--data-parallel", type=int, default=0, help=DATA_PARALLEL_HELP)
    p.add_argument("--checkpoint-format", choices=("pickle", "orbax"), default="pickle",
                   help="checkpoint layout (orbax is not ported: it imports JAX)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the fit into this directory")
    add_multihost_args(p)
    args = p.parse_args(argv)
    if args.train_fast:
        # the JAX CLI's recipe: both dropouts off and the BN freeze tail
        args.dropout = 0.0
        args.encoder_dropout = 0.0
        if not args.bn_freeze_after:
            args.bn_freeze_after = 0.5
    check_stream_args(p, args)
    return args


def main(argv=None):
    args = parse_args(argv)
    refuse_unported_training(args)
    with joined(args) as cluster:  # join the cluster before the data is read
        return _main(args, cluster)


def _main(args, cluster):
    import torch

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.ops.eer import calculate_eer
    from dfac_tpu_torch.train.checkpoint import load_model_variables
    from dfac_tpu_torch.train.detector_loop import DetectorConfig, dataset_lengths, detector_scores

    if cluster is not None and args.epochs <= 0 and not cluster.is_coordinator:
        # scoring alone is local compute from a checkpoint on the coordinator's
        # filesystem: concurrent writes of one prediction.pkl would corrupt it
        return None
    device = resolve_device(args.device)
    cfg = DetectorConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        hidden=args.hidden, dropout=args.dropout, encoder_dropout=args.encoder_dropout,
        specaug=args.specaug, time_mask_max=args.time_mask_max, time_mask_n=args.time_mask_n,
        freq_mask_max=args.freq_mask_max, freq_mask_n=args.freq_mask_n,
        ema=args.ema, ema_decay=args.ema_decay, patience=args.patience,
        seed=args.seed, compute_dtype="bfloat16" if args.bf16 else None,
        device_resident=args.device_resident or args.fused_fit,
        resident_chunk_batches=args.resident_chunk_batches,
        chunk_ingest=args.chunk_ingest,
        bn_freeze_after_frac=args.bn_freeze_after,
        data_parallel=args.data_parallel,
        multihost=args.multihost,
    )

    def split_paths(split):
        return (
            os.path.join(args.data_dir, split, "features.pkl"),
            os.path.join(args.data_dir, split, "labels.pkl"),
        )

    test_feat, test_lab = split_paths(args.test_split)
    has_test_labels = os.path.exists(test_lab)
    if args.epochs > 0:
        train_ds = load_dataset(*split_paths(args.train_split))
        dev_ds = load_dataset(*split_paths(args.dev_split))
        result = run_training(_fit, args, cfg, train_ds, dev_ds, cluster=cluster)
        if cluster is not None:
            from dfac_tpu_torch.parallel.multihost import sync

            sync()  # the test split is scored from the coordinator's checkpoint, after its write
            if not cluster.is_coordinator:
                return result
    test_ds = load_dataset(test_feat, test_lab if has_test_labels else None)

    if not os.path.exists(args.ckpt_path):
        raise FileNotFoundError(f"Checkpoint not found: {args.ckpt_path}")
    state_dict = load_model_variables(args.ckpt_path, model_name="detector")
    lengths = dataset_lengths(test_ds)
    if args.fast:
        from dfac_tpu_torch.models.fast_infer import detector_scores_fast

        scores = detector_scores_fast(
            state_dict, test_ds, lengths, device, args.batch_size, apply_sigmoid=args.use_prob,
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        )
    else:
        # the trained model scores in its own dtype (bf16 after --bf16
        # training); a checkpoint scored alone, with the f32 eval model
        trained_bf16 = args.bf16 and args.epochs > 0
        model = model_from_state_dict("detector", state_dict,
                                      compute_dtype=torch.bfloat16 if trained_bf16 else None)
        scores = detector_scores(model.to(device), test_ds, lengths, args.batch_size, apply_sigmoid=args.use_prob)
    write_predictions(args.prediction_pkl, test_ds.uttids, scores)
    print(f"Saved prediction file -> {args.prediction_pkl}  shape: ({len(scores)}, 2)")
    if has_test_labels:
        eer, _ = calculate_eer(scores, test_ds.labels)
        print(f"EER on split '{args.test_split}': {eer:.6f}")
    return scores


def _fit(args, cfg, train_ds, dev_ds):
    """The training after the data is read: in this process, or on each
    rank of ``--data-parallel`` or ``--multihost`` (rank 0 prints and writes
    the checkpoint)."""
    from dfac_tpu_torch.obs.profiling import trace
    from dfac_tpu_torch.parallel.data_parallel import main_process
    from dfac_tpu_torch.train.detector_loop import DetectorTrainer

    main = main_process()
    trainer = DetectorTrainer(cfg, in_channels=train_ds.features.shape[1], device=train_device(args))
    fit = trainer.fit_fused if args.fused_fit else trainer.fit
    with trace(args.profile_dir if main else None):
        result = fit(train_ds, dev_ds, ckpt_path=args.ckpt_path)
    if main:
        print(f"Training done. Best dev EER: {result['best_eer']:.6f}")
    return result


if __name__ == "__main__":
    main()
