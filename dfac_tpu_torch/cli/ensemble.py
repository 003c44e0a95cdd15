"""``python -m dfac_tpu_torch.cli.ensemble`` — checkpoint ensemble evaluation.

Counterpart of ``dfac-ensemble`` (:mod:`dfac_tpu.cli.ensemble`), parity
target reference ``src/ensemble.py``: N ``arch:path`` checkpoint specs, one
unshuffled split, sigmoid scores per model from the f32 eval model, their
mean, the EER of each and of the ensemble. The same flags and lines, with
``--device`` (default ``cuda``, no implicit fallback), for every
architecture of the registry (the model's widths from its checkpoint).
"""

from __future__ import annotations

import argparse

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an ensemble of checkpoints by score averaging.")
    p.add_argument("--features", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument(
        "--checkpoints", required=True, nargs="+",
        help="specs like cnn2d:checkpoints/cnn2d_best.ckpt cnn1d:.../cnn1d_best.pt",
    )
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--out", default=None, help="optionally write ensemble scores as prediction.pkl")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    specs = []
    for spec in args.checkpoints:
        arch, _, path = spec.partition(":")
        if not path:
            raise SystemExit(f"bad checkpoint spec '{spec}' (want arch:path)")
        specs.append((arch, path))

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.ensemble.mean import ensemble_scores, score_checkpoints
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.ops.eer import calculate_eer

    device = resolve_device(args.device)
    ds = load_dataset(args.features, args.labels)
    per_model = score_checkpoints(specs, ds, args.batch_size, device=device)
    for name, scores in per_model.items():
        eer, thr = calculate_eer(scores, ds.labels)
        print(f"{name}: EER={eer:.6f} threshold={thr:.6f}")
    ens = ensemble_scores(per_model)
    eer, thr = calculate_eer(ens, ds.labels)
    print(f"ensemble (mean of {len(per_model)}): EER={eer:.6f} threshold={thr:.6f}")
    if args.out:
        write_predictions(args.out, ds.uttids, ens)
        print(f"wrote ensemble scores to {args.out}")


if __name__ == "__main__":
    main()
