"""``python -m dfac_tpu_torch.cli.predict_hybrid`` — hybrid CNN + CAE
prediction on an unlabeled set.

Counterpart of ``dfac-predict-hybrid`` (:mod:`dfac_tpu.cli.predict_hybrid`),
parity target reference ``src/predict_hybrid.py``: fixed-alpha fusion
(default 0.80) of the supervised sigmoid scores and the raw CAE MSE, both
min-max normalized, into ``prediction.pkl``; the score-distribution line,
and with ``--compare-with`` the per-sample difference and class agreement
against another prediction set. The same flags and lines, with
``--device`` (default ``cuda``, no implicit fallback).

``--fast`` runs both legs through the folded chains in bf16, as the JAX
CLI does: CNN2D through the fused conv-block kernel (three launches a
batch) or CNN1D through cuDNN, and the CAE through cuDNN. Without it both
legs run the f32 eval models with TF32 off. ``--data-parallel N`` (with
``--fast``) scores each batch's rows on N ranks
(:func:`dfac_tpu_torch.parallel.serving.hybrid_scores_sharded`; the upload
stays f32, both legs read it), ``--multihost`` on the ranks of a cluster of
processes (:mod:`dfac_tpu_torch.parallel.multihost`), each reading only its
rows; the fusion runs on the host over the gathered corpus, and only the
coordinator writes and prints.
"""

from __future__ import annotations

import argparse

from dfac_tpu_torch.cli.common import add_multihost_args, joined


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Hybrid CNN+CAE prediction for submission.")
    p.add_argument("--features", required=True)
    p.add_argument("--cnn-checkpoint", required=True)
    p.add_argument("--cnn-model", default="cnn2d", choices=["cnn2d", "cnn1d"])
    p.add_argument("--cae-checkpoint", required=True)
    p.add_argument("--normalizer", required=True)
    p.add_argument("--alpha", type=float, default=0.80,
                   help="supervised weight (reference src/predict_hybrid.py:107)")
    p.add_argument("--out", default="prediction.pkl")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--in-features", type=int, default=180)
    p.add_argument("--base-channels", type=int, default=32)
    p.add_argument("--compare-with", default=None,
                   help="existing prediction.pkl to diff against")
    p.add_argument("--fast", action="store_true",
                   help="folded-BN serving chains for BOTH legs "
                   "(bf16 with f32 accumulation; cnn2d/cnn1d + CAE)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard each scoring batch over N devices (requires "
                   "--fast; both legs run per shard)")
    add_multihost_args(p, extra_help="requires --fast")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.multihost and not args.fast:
        raise SystemExit("--multihost hybrid serving runs the folded fast chains — add --fast")
    with joined(args) as cluster:  # join the cluster before anything is read
        if cluster is not None and args.data_parallel != cluster.world:
            from dfac_tpu_torch.parallel.multihost import SPAN_MESSAGE

            raise SystemExit(f"--data-parallel {args.data_parallel} over {cluster.world} global ranks: "
                             + SPAN_MESSAGE)
        result = _scores(args, cluster)
        if cluster is not None and not cluster.is_coordinator:
            return  # every process holds the gathered scores; one writes
    _report(args, *result)


def _scores(args, cluster):
    """``(uttids, supervised scores, CAE MSE)`` of the corpus: in this
    process, or sharded over ``--data-parallel`` ranks or the ``cluster``'s."""
    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.train.checkpoint import load_model_variables

    ds = load_dataset(args.features)
    cnn_sd = load_model_variables(args.cnn_checkpoint, model_name=args.cnn_model)
    cae_sd = load_model_variables(args.cae_checkpoint, model_name="cae")
    normalizer = FeatureNormalizer.load(args.normalizer)

    if args.data_parallel > 1 or cluster is not None:
        if not args.fast:
            raise SystemExit("--data-parallel hybrid serving requires --fast")
        if args.batch_size % args.data_parallel:
            raise SystemExit("--batch-size must divide by --data-parallel")
        if cluster is not None:
            sup, cae_s = cluster.run(_sharded, args, cnn_sd, cae_sd, normalizer, ds)
        else:
            from dfac_tpu_torch.parallel import launch

            sup, cae_s = launch(_sharded, args.data_parallel, args.device, args, cnn_sd, cae_sd, normalizer, ds)
        return ds.uttids, sup, cae_s
    device = resolve_device(args.device)
    if args.fast:
        from dfac_tpu_torch.models.fast_infer import (
            cae_mse_scores_fast,
            predict_scores_fast,
            predict_scores_fast_cnn1d,
        )

        fast = predict_scores_fast if args.cnn_model == "cnn2d" else predict_scores_fast_cnn1d
        sup = fast(cnn_sd, ds, device, args.batch_size, apply_sigmoid=True)
        cae_s = cae_mse_scores_fast(cae_sd, ds, normalizer, device, args.batch_size)
    else:
        from dfac_tpu_torch.train.cae_loop import cae_mse_scores
        from dfac_tpu_torch.train.evaluate import predict_scores

        cnn = model_from_state_dict(args.cnn_model, cnn_sd)  # widths from the weights
        sup = predict_scores(cnn.to(device), ds, args.batch_size, apply_sigmoid=True)
        cae = model_from_state_dict("cae", cae_sd)
        cae_s = cae_mse_scores(cae.to(device), ds, normalizer, args.batch_size)
    return ds.uttids, sup, cae_s


def _sharded(args, cnn_sd: dict, cae_sd: dict, normalizer, ds):
    """Both legs on one rank (its rows of every batch), gathered on every rank."""
    from dfac_tpu_torch.parallel.data_parallel import Ranks, rank_device
    from dfac_tpu_torch.parallel.serving import hybrid_scores_sharded

    return hybrid_scores_sharded(cnn_sd, cae_sd, normalizer, ds, rank_device(args.device), Ranks.of(),
                                 args.batch_size, model=args.cnn_model)


def _report(args, uttids, sup, cae_s) -> None:
    """Fuse the legs, write ``prediction.pkl``, print the reference's lines."""
    from dfac_tpu_torch.ensemble.hybrid import compare_with_submission, fuse_scores, score_distribution_report
    from dfac_tpu_torch.io.pickle_io import load_predictions, write_predictions

    hybrid = fuse_scores(sup, cae_s, alpha=args.alpha)
    write_predictions(args.out, uttids, hybrid)
    print(f"wrote {len(hybrid)} hybrid predictions (alpha={args.alpha}) to {args.out}")

    rep = score_distribution_report(hybrid)
    print(
        f"distribution: min={rep['min']:.6f} median={rep['median']:.4f} max={rep['max']:.6f}  "
        f"class1@0.5={rep['n_class1_at_0.5']} class0@0.5={rep['n_class0_at_0.5']}"
    )

    if args.compare_with:
        ou, os_ = load_predictions(args.compare_with)
        diff = compare_with_submission(uttids, hybrid, ou, os_)
        print(
            f"vs {args.compare_with}: common={diff['n_common']} "
            f"mean|d|={diff['mean_abs_diff']:.6f} max|d|={diff['max_abs_diff']:.6f} "
            f"agreement={diff['class_agreement']:.4f} flipped={diff['n_flipped']}"
        )


if __name__ == "__main__":
    main()
