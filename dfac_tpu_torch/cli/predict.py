"""``python -m dfac_tpu_torch.cli.predict`` — prediction.pkl from a checkpoint.

Counterpart of ``dfac-predict`` (:mod:`dfac_tpu.cli.predict`), parity
target reference ``src/predict.py``: label-free batched inference (sigmoid
and swap_tf on by default), strict prediction count, ``prediction.pkl``
DataFrame {uttid, predictions}. Reads dfac_tpu pickle checkpoints and
reference ``.pt`` files.

Ported for ``--model cnn2d`` and ``cnn1d``: ``--fast`` (the folded chain,
f32 by default or ``--bf16``; CNN2D's through the fused kernels on CUDA,
CNN1D's through cuDNN), ``--fast --ingest-int8`` (int8 rows and
per-group scales uploaded, dequantized on the device), ``--fast --int8``
for cnn2d (the w8a8 chain: blocks 2 and 3 on the int8 kernel; composes
with ``--ingest-int8``), the eval model without ``--fast`` (f32, or bf16
layers with ``--bf16``, JAX ``cli/predict.py:95-104``), ``--device
cuda|cpu``. The model's widths come from the checkpoint's weights.

``--data-parallel N`` scores each batch on N ranks (one process each,
:func:`dfac_tpu_torch.parallel.launch`, the dataset in shared memory):
with ``--fast`` the sharded feature scorer
(:func:`dfac_tpu_torch.parallel.serving.predict_scores_sharded`), without
it the eval model (``predict_scores(ranks=...)``). ``--multihost`` runs
the ranks of a cluster of processes joined at ``--coordinator-address``
(:mod:`dfac_tpu_torch.parallel.multihost`; ``--fast`` required), each
reading only its rows. Rank 0 (the coordinator) writes ``prediction.pkl``
and prints the throughput line; the other processes write nothing. The
JAX CLI's refusals keep its messages.
"""

from __future__ import annotations

import argparse
import time

from dfac_tpu_torch.cli.common import add_multihost_args, joined


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate prediction.pkl from a model checkpoint.")
    p.add_argument("--features", required=True, help="Path to features.pkl or a .npy store directory")
    p.add_argument("--checkpoint", required=True, help="Path to model checkpoint (.ckpt or torch .pt)")
    p.add_argument("--model", required=True, choices=["cnn2d", "cnn1d"])
    p.add_argument("--out", required=True, help="Output path for prediction.pkl")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations, f32 accumulation")
    p.add_argument("--fast", action="store_true", help="folded-BatchNorm fused serving chain")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard each scoring batch over N devices (0 = single device)")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 int8 device compute for the folded cnn2d chain: blocks 2-3 run int8 x int8 -> "
                        "int32 on the int8 conv-block kernel (per-output-channel weight scales, calibrated "
                        "static activation scales). Requires --fast, cnn2d, single device")
    p.add_argument("--ingest-int8", action="store_true",
                   help="quantize feature rows to int8 (a scale per utterance x feature dim) on the host and "
                        "dequantize on the device: half the host->device bytes of bf16 ingest; scores shift "
                        "by ~amax/254 per group. Requires --fast")
    add_multihost_args(p, extra_help="requires --fast")
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


def main(argv=None):
    args = parse_args(argv)
    if args.multihost and not args.fast:
        raise SystemExit("--multihost serving runs the folded fast chain — add --fast")
    if args.ingest_int8 and not args.fast:
        raise SystemExit("--ingest-int8 rides the folded fast chain — add --fast")
    if args.int8 and (not args.fast or args.model != "cnn2d" or args.multihost or args.data_parallel > 1):
        raise SystemExit(
            "--int8 (w8a8 device compute) runs the folded cnn2d chain on a "
            "single device — use with --fast --model cnn2d and without "
            "--multihost/--data-parallel"
        )
    with joined(args) as cluster:  # join the cluster before anything is read
        if cluster is not None and args.data_parallel != cluster.world:
            from dfac_tpu_torch.parallel.multihost import SPAN_MESSAGE

            raise SystemExit(f"--data-parallel {args.data_parallel} over {cluster.world} global ranks: "
                             + SPAN_MESSAGE)
        if args.fast and args.data_parallel > 1 and args.batch_size % args.data_parallel:
            raise SystemExit("--batch-size must divide by --data-parallel")

        from dfac_tpu_torch.data.pipeline import load_dataset
        from dfac_tpu_torch.train.checkpoint import load_model_variables

        state_dict = load_model_variables(args.checkpoint, model_name=args.model)
        ds = load_dataset(args.features)
        if cluster is not None:
            result = cluster.run(_score, args, state_dict, ds)
            if not cluster.is_coordinator:
                return  # every process holds the gathered scores; one writes
        elif args.data_parallel > 1:
            from dfac_tpu_torch.parallel import launch

            result = launch(_score, args.data_parallel, args.device, args, state_dict, ds)
        else:
            result = _score(args, state_dict, ds)

    from dfac_tpu_torch.io.pickle_io import write_predictions

    scores, elapsed, stats, where = result
    if len(scores) != len(ds):
        raise ValueError("Number of predictions does not match number of rows in features.pkl")
    write_predictions(args.out, ds.uttids, scores)
    print(f"wrote {len(scores)} predictions to {args.out}")
    if elapsed > 0:
        print(
            f"throughput: {len(scores) / elapsed:,.1f} utt/s over {elapsed:.2f}s on {where} "
            f"(host-wait {stats.host_wait_s:.2f}s, device-wait "
            f"{stats.device_wait_s:.2f}s, {stats.items} batches)"
        )
        if stats.host_bound():
            print(f"ingest-bound: the device waited {stats.host_wait_s:.2f}s on host batch assembly")


def _score(args, state_dict: dict, ds):
    """The scoring run, in this process or on each rank of ``--data-parallel``
    / ``--multihost`` (each rank scores its rows of every batch; the scores
    are gathered on every rank): ``(scores, seconds, PrefetchStats, where)``,
    ``where`` naming the devices."""
    import torch

    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.io.prefetch import PrefetchStats
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast, predict_scores_fast_cnn1d
    from dfac_tpu_torch.parallel.data_parallel import Ranks, rank_device
    from dfac_tpu_torch.train.evaluate import predict_scores

    sharded = args.data_parallel > 1 or args.multihost
    device = rank_device(args.device) if sharded else resolve_device(args.device)
    ranks = Ranks.of() if sharded else None
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    stats = PrefetchStats()
    t_run = time.perf_counter()
    if args.fast and ranks is not None:
        from dfac_tpu_torch.parallel.serving import predict_scores_sharded

        scores = predict_scores_sharded(
            state_dict, ds, device, ranks, batch_size=args.batch_size, swap_tf=args.swap_tf,
            apply_sigmoid=args.apply_sigmoid, compute_dtype=dtype, model=args.model,
            ingest_int8=args.ingest_int8, stats=stats,
        )
    elif args.fast:
        if args.int8:
            from dfac_tpu_torch.models.fast_infer_int8 import predict_scores_w8a8 as fast
        else:
            fast = predict_scores_fast if args.model == "cnn2d" else predict_scores_fast_cnn1d
        scores = fast(
            state_dict, ds, device,
            batch_size=args.batch_size, swap_tf=args.swap_tf,
            apply_sigmoid=args.apply_sigmoid,
            compute_dtype=dtype,
            stats=stats, ingest_int8=args.ingest_int8,
        )
    else:
        model = model_from_state_dict(args.model, state_dict, dropout=args.dropout,
                                      compute_dtype=dtype if args.bf16 else None)
        scores = predict_scores(
            model.to(device), ds, batch_size=args.batch_size, swap_tf=args.swap_tf,
            apply_sigmoid=args.apply_sigmoid, stats=stats, ranks=ranks,
        )
    elapsed = time.perf_counter() - t_run
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if ranks is not None:
        import torch.distributed as dist

        where = f"{ranks.world} ranks over {dist.get_backend(ranks.group)} ({where} for rank 0)"
    return scores, elapsed, stats, where


if __name__ == "__main__":
    main()
