"""The submission pair through the program: ``predict_hybrid --fast`` on one device.

Each request runs the single-device ``--fast`` branch of
``cli/predict_hybrid._scores`` and its fusion: the CNN2D leg
``models/fast_infer.predict_scores_fast`` (sigmoid scores), then the CAE
leg ``models/fast_infer.cae_mse_scores_fast`` (the raw reconstruction
MSE), both in the configuration's precision with the CLI's batch, then
``ensemble/hybrid.fuse_scores`` at the configuration's alpha. The
normalizer is the benchmark's own (made from the corpus's bonafide rows,
as the weights are made from the seed), handed to the program as a
``FeatureNormalizer`` and to the reference as arrays.

Compared on the sampled requests: each leg against the plain references
in f32, and the fusion against the reference's fusion of the program's
legs. The control is the references with fp8 operands in both legs.
"""

from __future__ import annotations

import numpy as np

from perfbench.lib import seeded
from perfbench.lib.bench import CAE_WEIGHTS, model_dims, module
from perfbench.reference import cae as cae_ref
from perfbench.reference import cnn2d as cnn_ref

_base = module("systems", "cnn2d")
gap = _base.gap


class Serving:
    def __init__(self, ctx, cnn: dict, cae: dict, mean: np.ndarray, std: np.ndarray):
        from dfac_tpu_torch.data.normalizer import FeatureNormalizer
        from dfac_tpu_torch.io.prefetch import PrefetchStats

        self.ctx, self.cnn, self.cae, self.mean, self.std = ctx, cnn, cae, mean, std
        self.normalizer = FeatureNormalizer(mean, std)
        self.stats = PrefetchStats()

    def score(self, ds) -> dict:
        from dfac_tpu_torch.ensemble.hybrid import fuse_scores
        from dfac_tpu_torch.models.fast_infer import cae_mse_scores_fast, predict_scores_fast

        ctx, rec = self.ctx, self.ctx.record
        dt, batch = _base.DTYPES[ctx.config["dtype"]], ctx.traffic["batch_size"]
        with rec.span("cnn2d_leg"):
            sup = predict_scores_fast(self.cnn, ds, ctx.device, batch, apply_sigmoid=True, compute_dtype=dt,
                                      stats=self.stats)
        with rec.span("cae_leg"):
            cae = cae_mse_scores_fast(self.cae, ds, self.normalizer, ctx.device, batch, compute_dtype=dt)
        with rec.span("fuse"):
            fused = fuse_scores(sup, cae, alpha=ctx.config["alpha"])
        return {"score": fused, "cnn2d": sup, "cae": cae}

    def counters(self) -> dict:
        return {"host_wait_s": self.stats.host_wait_s}

    def release(self) -> dict:
        return {"cnn2d": self.cnn, "cae": self.cae, "mean": self.mean, "std": self.std}


def serving(ctx, feats, labels) -> Serving:
    cnn = _base.weights(ctx)
    cae = seeded.state_dict(cae_ref.leaves(model_dims(ctx.config, "cae")), ctx.generator(CAE_WEIGHTS), ctx.device)
    mean, std = seeded.bonafide_normalizer(feats, labels)
    return Serving(ctx, cnn, cae, mean, std)


def compare_scores(ctx, inputs: dict, pairs, control: str | None = None) -> dict:
    """Over every row of the sampled requests: ``cnn2d_gap``, the largest gap
    of a CNN2D score, and ``cae_gap``, the largest relative gap of a CAE
    MSE, against the f32 references; ``fused_gap``, the largest gap of a
    fused score against the reference's fusion of the program's own legs
    (the request's min-max fusion in float64: an exact comparison, since a
    min-max over a request magnifies any gap of the legs by its range).
    ``control``: ``fp8``, the references with fp8 operands in the program's
    place for both legs."""
    dev, alpha = ctx.device, ctx.config["alpha"]
    got = {"cnn2d": [], "cae": [], "score": []}
    want = {"cnn2d": [], "cae": [], "score": []}
    for ds, answers in pairs:
        want["cnn2d"].append(cnn_ref.sigmoid(cnn_ref.logits_of_rows(inputs["cnn2d"], ds.features, dev)))
        want["cae"].append(cae_ref.mse_of_rows(inputs["cae"], ds.features, inputs["mean"], inputs["std"], dev))
        if control:
            sup = cnn_ref.sigmoid(cnn_ref.logits_of_rows(inputs["cnn2d"], ds.features, dev, control))
            mse = cae_ref.mse_of_rows(inputs["cae"], ds.features, inputs["mean"], inputs["std"], dev, "fp8")
            answers = {"cnn2d": sup, "cae": mse, "score": cae_ref.fuse(sup, mse, alpha)}
        for k in got:
            got[k].append(np.asarray(answers[k]))
        ok = len(answers["cnn2d"]) == len(answers["cae"]) == len(answers["score"])
        want["score"].append(cae_ref.fuse(answers["cnn2d"], answers["cae"], alpha) if ok else np.zeros(0))
    cat = {k: (np.concatenate(got[k]), np.concatenate(want[k])) for k in got}
    return {
        "cnn2d_gap": gap(*cat["cnn2d"]),
        "cae_gap": gap(*cat["cae"], relative=True),
        "fused_gap": gap(*cat["score"]),
    }
