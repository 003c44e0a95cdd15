"""``python -m dfac_tpu_torch.cli.hybrid_ensemble`` — CNN + CAE fusion alpha
sweep on a labeled split.

Counterpart of ``dfac-hybrid-ensemble`` (:mod:`dfac_tpu.cli.hybrid_ensemble`),
parity target reference ``src/hybrid_ensemble.py``: the supervised sigmoid
scores and the raw CAE MSE of the f32 eval models, min-max normalized,
alpha swept over ``linspace(0, 1, 21)``, the best alpha and EER. The same
flags and lines, with ``--device`` (default ``cuda``, no implicit
fallback).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Sweep hybrid CNN+CAE fusion weight on a labeled dev set.")
    p.add_argument("--features", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--cnn-checkpoint", required=True)
    p.add_argument("--cnn-model", default="cnn2d", choices=["cnn2d", "cnn1d"])
    p.add_argument("--cae-checkpoint", required=True)
    p.add_argument("--normalizer", required=True)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--num-alphas", type=int, default=21)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.ensemble.hybrid import sweep_alpha
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.ops.eer import calculate_eer
    from dfac_tpu_torch.train.cae_loop import cae_mse_scores
    from dfac_tpu_torch.train.checkpoint import load_model_variables
    from dfac_tpu_torch.train.evaluate import predict_scores

    device = resolve_device(args.device)
    ds = load_dataset(args.features, args.labels)

    # the widths come from the weights
    cnn = model_from_state_dict(args.cnn_model, load_model_variables(args.cnn_checkpoint, model_name=args.cnn_model))
    sup_scores = predict_scores(cnn.to(device), ds, args.batch_size, apply_sigmoid=True)

    cae = model_from_state_dict("cae", load_model_variables(args.cae_checkpoint, model_name="cae"))
    normalizer = FeatureNormalizer.load(args.normalizer)
    cae_scores = cae_mse_scores(cae.to(device), ds, normalizer, args.batch_size)

    sup_eer, _ = calculate_eer(sup_scores, ds.labels)
    cae_eer, _ = calculate_eer(cae_scores, ds.labels)
    print(f"supervised EER: {sup_eer:.6f}")
    print(f"CAE (+MSE) EER: {cae_eer:.6f}")

    res = sweep_alpha(sup_scores, cae_scores, ds.labels, num=args.num_alphas)
    for row in res["sweep"]:
        print(f"  alpha={row['alpha']:.2f}  EER={row['eer']:.6f}")
    print(f"best alpha={res['best_alpha']:.2f}  best EER={res['best_eer']:.6f}")
    return res


if __name__ == "__main__":
    main()
