"""``python -m dfac_tpu_torch.cli.evaluate <prediction.pkl> <labels.pkl>``.

Counterpart of the score-file mode of ``dfac-evaluate``
(:mod:`dfac_tpu.cli.evaluate`, reference ``scripts/evaluation.py``): merge
on uttid, print EER / threshold / confusion exactly like the reference
leaderboard script. The checkpoint mode is not ported yet.
"""

from __future__ import annotations

import argparse


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


def main(argv=None):
    p = argparse.ArgumentParser(description="EER of a prediction.pkl against labels.pkl.")
    p.add_argument("prediction", help="prediction.pkl")
    p.add_argument("labels", help="labels.pkl")
    args = p.parse_args(argv)
    _score_file_mode(args.prediction, args.labels)


if __name__ == "__main__":
    main()
