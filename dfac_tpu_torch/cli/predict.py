"""``python -m dfac_tpu_torch.cli.predict`` — prediction.pkl from a checkpoint.

Counterpart of ``dfac-predict`` (:mod:`dfac_tpu.cli.predict`), parity
target reference ``src/predict.py``: label-free batched inference (sigmoid
and swap_tf on by default), strict prediction count, ``prediction.pkl``
DataFrame {uttid, predictions}. Reads dfac_tpu pickle checkpoints and
reference ``.pt`` files.

Ported: ``--fast --model cnn2d`` (the folded chain through the fused
kernels on CUDA), ``--bf16``, ``--device cuda|cpu``. The other flags of
the JAX CLI exit non-zero with "not yet ported".
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate prediction.pkl from a model checkpoint.")
    p.add_argument("--features", required=True, help="Path to features.pkl")
    p.add_argument("--checkpoint", required=True, help="Path to model checkpoint (.ckpt or torch .pt)")
    p.add_argument("--model", required=True, choices=["cnn2d", "cnn1d"])
    p.add_argument("--out", required=True, help="Output path for prediction.pkl")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations, f32 accumulation")
    p.add_argument("--fast", action="store_true", help="folded-BatchNorm fused serving chain")
    p.add_argument("--data-parallel", type=int, default=0)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--ingest-int8", action="store_true")
    p.add_argument("--multihost", action="store_true")
    sig = p.add_mutually_exclusive_group()
    sig.add_argument("--apply-sigmoid", dest="apply_sigmoid", action="store_true", default=True)
    sig.add_argument("--no-apply-sigmoid", dest="apply_sigmoid", action="store_false")
    tf = p.add_mutually_exclusive_group()
    tf.add_argument("--swap-tf", dest="swap_tf", action="store_true",
                    help="swap time and feature dimensions (T <-> F) (default)")
    tf.add_argument("--no-swap-tf", dest="swap_tf", action="store_false",
                    help="disable time/feature swap")
    p.set_defaults(swap_tf=True)
    return p.parse_args(argv)


def _not_yet_ported(args) -> str | None:
    for flag, on in (
        ("--int8", args.int8), ("--ingest-int8", args.ingest_int8),
        ("--data-parallel", args.data_parallel > 1), ("--multihost", args.multihost),
        ("--model cnn1d", args.model != "cnn2d"), ("predict without --fast", not args.fast),
    ):
        if on:
            return flag
    return None


def main(argv=None):
    args = parse_args(argv)
    missing = _not_yet_ported(args)
    if missing:
        raise SystemExit(f"{missing}: not yet ported to dfac_tpu_torch (see ROADMAP.md)")

    import torch

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.io.prefetch import PrefetchStats
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast
    from dfac_tpu_torch.train.checkpoint import load_model_variables

    device = resolve_device(args.device)
    model = build_model(args.model, in_features=args.in_features, dropout=args.dropout)
    model.load_state_dict(load_model_variables(args.checkpoint, model_name=args.model))
    ds = load_dataset(args.features)

    stats = PrefetchStats()
    t_run = time.perf_counter()
    scores = predict_scores_fast(
        model.state_dict(), ds, device,
        batch_size=args.batch_size, swap_tf=args.swap_tf,
        apply_sigmoid=args.apply_sigmoid,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        stats=stats,
    )
    elapsed = time.perf_counter() - t_run
    if len(scores) != len(ds):
        raise ValueError("Number of predictions does not match number of rows in features.pkl")
    write_predictions(args.out, ds.uttids, scores)
    print(f"wrote {len(scores)} predictions to {args.out}")
    if elapsed > 0:
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(
            f"throughput: {len(scores) / elapsed:,.1f} utt/s over {elapsed:.2f}s on {where} "
            f"(host-wait {stats.host_wait_s:.2f}s, device-wait "
            f"{stats.device_wait_s:.2f}s, {stats.items} batches)"
        )
        if stats.host_bound():
            print(f"ingest-bound: the device waited {stats.host_wait_s:.2f}s on host batch assembly")


if __name__ == "__main__":
    main()
