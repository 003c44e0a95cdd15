"""``python -m dfac_tpu_torch.cli.evaluate`` — two evaluation modes in one CLI.

Counterpart of ``dfac-evaluate`` (:mod:`dfac_tpu.cli.evaluate`):

1. **Score-file mode** (positional args, reference ``scripts/evaluation.py``):
   ``evaluate prediction.pkl labels.pkl`` — merge on uttid, print
   EER/threshold/confusion exactly like the reference leaderboard script.
2. **Checkpoint mode** (flags, reference ``src/evaluation.py:127-222``):
   run a checkpoint over a labeled split on ``--device`` (default
   ``cuda``, no implicit fallback) and print avg_loss/eer/threshold, with
   the strict uttid alignment check on by default.
"""

from __future__ import annotations

import argparse
import sys

from dfac_tpu_torch.cli.common import add_swap_tf_args


def _score_file_mode(prediction_path: str, labels_path: str) -> None:
    from dfac_tpu_torch.io.pickle_io import load_labels, load_predictions
    from dfac_tpu_torch.ops.eer import calculate_eer, confusion_at_threshold

    pu, scores = load_predictions(prediction_path)
    lu, labels = load_labels(labels_path)
    lab_map = dict(zip(lu, labels.tolist()))
    if set(pu) != set(lu) or len(pu) != len(lu):
        raise ValueError("uttid mismatch between prediction and labels")
    aligned = [lab_map[u] for u in pu]

    eer, threshold = calculate_eer(scores, aligned)
    tp, fp, tn, fn, far, frr = confusion_at_threshold(scores, aligned, threshold)
    print(f"EER: {eer:.6f}")
    print(f"Threshold: {threshold:.6f}")
    print(f"TP: {tp}  FP: {fp}  TN: {tn}  FN: {fn}")
    print(f"FAR: {far:.6f}  FRR: {frr:.6f}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate predictions or a checkpoint on a labeled set.")
    p.add_argument("positional", nargs="*", help="<prediction.pkl> <labels.pkl> (score-file mode)")
    p.add_argument("--features", help="Path to features.pkl (checkpoint mode)")
    p.add_argument("--labels", help="Path to labels.pkl (checkpoint mode)")
    p.add_argument("--checkpoint", help="Path to model checkpoint")
    p.add_argument("--model", default="cnn2d", choices=["cnn2d", "cnn1d"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.2)
    chk = p.add_mutually_exclusive_group()
    chk.add_argument("--check-uttid", dest="check_uttid", action="store_true", default=True)
    chk.add_argument("--no-check-uttid", dest="check_uttid", action="store_false")
    sig = p.add_mutually_exclusive_group()
    sig.add_argument("--apply-sigmoid", dest="apply_sigmoid", action="store_true", default=True)
    sig.add_argument("--no-apply-sigmoid", dest="apply_sigmoid", action="store_false")
    add_swap_tf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if len(args.positional) == 2:
        _score_file_mode(*args.positional)
        return
    if args.positional:
        print("usage: evaluate <prediction.pkl> <labels.pkl>  (or flag mode)", file=sys.stderr)
        raise SystemExit(2)
    if not (args.features and args.labels and args.checkpoint):
        raise SystemExit("checkpoint mode needs --features, --labels, --checkpoint")

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.train.checkpoint import load_model_variables
    from dfac_tpu_torch.train.evaluate import evaluate_classifier

    device = resolve_device(args.device)
    # strict uttid verification happens inside load_dataset's align step;
    # --no-check-uttid relaxes it to tolerate EXTRA labels (features
    # without labels always raise, see io/pickle_io.py align_labels)
    ds = load_dataset(args.features, args.labels, strict=args.check_uttid)
    # the widths come from the checkpoint's weights (JAX's modules read them from the data)
    model = model_from_state_dict(args.model, load_model_variables(args.checkpoint, model_name=args.model),
                                  dropout=args.dropout)
    metrics, _, _ = evaluate_classifier(
        model.to(device), ds,
        batch_size=args.batch_size, swap_tf=args.swap_tf, apply_sigmoid=args.apply_sigmoid,
    )
    print(f"avg_loss={metrics['avg_loss']}")
    print(f"eer={metrics['eer']}")
    print(f"threshold={metrics['threshold']}")


if __name__ == "__main__":
    main()
