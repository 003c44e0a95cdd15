"""``python -m dfac_tpu_torch.cli.evaluate_cae`` — CAE anomaly evaluation.

Counterpart of ``dfac-evaluate-cae`` (:mod:`dfac_tpu.cli.evaluate_cae`),
parity target reference ``src/evaluation_cae.py``: per-sample
reconstruction MSE of the f32 eval model, the dual +/-MSE EER convention,
per-class mean MSE and the spoof/bonafide ratio; the same flags and
lines, with ``--device`` (default ``cuda``, no implicit fallback).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained CAE with reconstruction-error scoring.")
    p.add_argument("--features", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--checkpoint", required=True, help="cae checkpoint (.ckpt or torch .pt)")
    p.add_argument("--normalizer", required=True, help="normalizer sidecar (.npz or torch .pt)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--out", default=None, help="optionally write MSE scores as prediction.pkl")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.train.cae_loop import evaluate_cae
    from dfac_tpu_torch.train.checkpoint import load_model_variables

    device = resolve_device(args.device)
    ds = load_dataset(args.features, args.labels)
    model = build_model("cae", base_channels=args.base_channels)
    model.load_state_dict(load_model_variables(args.checkpoint, model_name="cae"))
    normalizer = FeatureNormalizer.load(args.normalizer)

    rep = evaluate_cae(model.to(device), ds, normalizer, args.batch_size)
    print(f"EER (+MSE convention): {rep['eer_pos_mse']:.6f}")
    print(f"EER (-MSE convention): {rep['eer_neg_mse']:.6f}")
    print(f"best convention: {rep['convention']}  EER: {rep['eer']:.6f}  threshold: {rep['threshold']:.6f}")
    print(f"bonafide mean MSE: {rep['bonafide_mean_mse']:.6f}")
    print(f"spoof mean MSE:    {rep['spoof_mean_mse']:.6f}")
    print(f"spoof/bonafide MSE ratio: {rep['spoof_bonafide_ratio']:.4f}")
    if args.out:
        write_predictions(args.out, ds.uttids, rep["scores"])
        print(f"wrote MSE scores to {args.out}")
    return rep


if __name__ == "__main__":
    main()
