"""The CNN2D configuration through the program: ``predict --fast`` scoring and the reference recipe's training.

Scoring calls ``models/fast_infer.predict_scores_fast`` with the CLI's
batch and the configuration's precision (f32 is ``predict --fast``'s
default): the fold, host ingest in the prefetch thread, K2's three blocks,
the head, one fetch, the pad rows dropped. The sigmoid scores are compared
with the plain reference's on the sampled requests' rows.

Training builds one ``train/loop.Trainer`` with the recipe of
``cli/reproduce_reference.py`` from the benchmark's seeded weights and
drives it through the window's own call, ``train_epoch`` on the whole
corpus (epoch 0: its order, its device-resident feed), for its first
``setup_steps`` steps: a live display (``batch_ctx``) reads each step's
running loss and the optimizer's state after the first, and stops the
epoch there. That same trainer goes to the window, which runs
``train_epoch`` and ``evaluate`` as ``fit``'s loop does. The reference
follows the set-up steps from the same weights and draws: each step's
loss, the first gradient as the optimizer holds it after one step
(AdamW's first moment over 1 - beta1), and each parameter's change over
the steps. The window's last evaluation is held against the reference's
evaluation of the trainer's final parameters: the program's own state,
so that stage is followed from it. And every parameter has to have moved
over the window's epochs.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import seeded
from perfbench.lib.bench import WEIGHTS, model_dims
from perfbench.reference import cnn2d as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ORDER_STRIDE = 100003  # the trainer's epoch order: default_rng(seed * 100003 + epoch).shuffle(arange(n))
MOVED = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's moves by round-off alone


def weights(ctx) -> dict:
    """CNN2D's seeded weights and BatchNorm statistics on the card."""
    return seeded.state_dict(ref.leaves(model_dims(ctx.config, "cnn2d")), ctx.generator(WEIGHTS), ctx.device)


def gap(got: np.ndarray, want: np.ndarray, relative: bool = False) -> float:
    """The largest gap; inf where the shapes differ or a value is not finite."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    d = np.abs(got - want)
    return float(np.max(d / np.abs(want) if relative else d)) if d.size else 0.0


# -- scoring -----------------------------------------------------------------------------------


class Serving:
    def __init__(self, ctx, sd: dict):
        from dfac_tpu_torch.io.prefetch import PrefetchStats

        self.ctx, self.sd, self.stats = ctx, sd, PrefetchStats()

    def score(self, ds) -> dict:
        from dfac_tpu_torch.models.fast_infer import predict_scores_fast

        ctx = self.ctx
        return {"score": predict_scores_fast(self.sd, ds, ctx.device, ctx.traffic["batch_size"],
                                             compute_dtype=DTYPES[ctx.config["dtype"]], stats=self.stats)}

    def counters(self) -> dict:
        return {"host_wait_s": self.stats.host_wait_s}

    def release(self) -> dict:
        """The benchmark's inputs (the seeded weights); the program keeps no state between calls."""
        return {"cnn2d": self.sd}


def serving(ctx, feats, labels) -> Serving:
    return Serving(ctx, weights(ctx))


def compare_scores(ctx, inputs: dict, pairs, control: str | None = None) -> dict:
    """``score_gap``: the largest gap between a served score and the
    reference's sigmoid, over every row of the sampled requests
    (``pairs``: (rows, answers)); with ``control``, the reference at that
    precision in the program's place."""
    rows = np.concatenate([ds.features for ds, _ in pairs])
    want = ref.sigmoid(ref.logits_of_rows(inputs["cnn2d"], rows, ctx.device))
    if control:
        got = ref.sigmoid(ref.logits_of_rows(inputs["cnn2d"], rows, ctx.device, control))
    else:
        got = np.concatenate([a["score"] for _, a in pairs])
    return {"score_gap": gap(got, want)}


# -- training ----------------------------------------------------------------------------------


class _Stop(Exception):
    pass


class _FirstSteps:
    """A live display for ``train_epoch``: each step's loss (from the running
    mean and the batch's count), ``on_first()`` after the first step, and a
    stop after ``n``."""

    wants_updates = True

    def __init__(self, n: int, losses: list, on_first):
        self.n, self.losses, self.on_first = n, losses, on_first
        self.total = self.count = 0.0

    def update_batch(self, m) -> None:
        count = self.count + m.batch_size
        total = m.running_loss * count
        self.losses.append((total - self.total) / m.batch_size if self.count else m.running_loss)
        self.total, self.count = total, count
        if m.batch_idx == 0:
            self.on_first()
        if len(self.losses) >= self.n:
            raise _Stop


class Training:
    def __init__(self, ctx, train_ds, dev_ds):
        from dfac_tpu_torch.data.augment import AugmentConfig
        from dfac_tpu_torch.train.loop import TrainConfig, Trainer

        tr, r = ctx.traffic, ctx.traffic["recipe"]
        self.ctx, self.train_ds, self.dev_ds = ctx, train_ds, dev_ds
        self.seed = ctx.seed % (1 << 62)
        cfg = TrainConfig(
            model="cnn2d", in_features=ctx.config["input"]["in_features"], batch_size=tr["batch_size"],
            lr=r["lr"], weight_decay=r["weight_decay"], label_smoothing=r["label_smoothing"], dropout=r["dropout"],
            early_stop=8, lr_scheduler="plateau", lr_scheduler_metric="dev_eer", seed=self.seed,
            device_resident=tr["device_resident"], augment=AugmentConfig(**r["augment"]),
        )
        self.sd0 = weights(ctx)
        self.trainer = Trainer(cfg, device=ctx.device)
        self.trainer.init_state(state_dict=self.sd0)
        self.losses: list[float] = []
        self.first_moments: dict | None = None
        self.after: dict | None = None
        self.last_eval: dict | None = None
        self.final: dict | None = None

    def setup_steps(self, n: int) -> None:
        """The first ``n`` steps of ``train_epoch`` on the whole corpus (epoch
        0), with the snapshots the reference reads; then the epoch stops."""
        t = self.trainer
        names = {p: k for k, p in t.model.named_parameters()}

        def first_moments() -> None:
            self.first_moments = {names[p]: s["exp_avg"].detach().clone() for p, s in t.optimizer.state.items()}

        try:
            t.train_epoch(self.train_ds, 0, batch_ctx=_FirstSteps(n, self.losses, first_moments))
        except _Stop:
            pass
        self.after = {k: v.detach().clone() for k, v in t.model.named_parameters()}

    def epoch(self, epoch: int) -> float | None:
        return self.trainer.train_epoch(self.train_ds, epoch)

    def evaluate(self) -> dict:
        self.last_eval = self.trainer.evaluate(self.dev_ds)
        return self.last_eval

    def release(self) -> dict:
        """The trainer's final parameters and BatchNorm statistics; the trainer is dropped on the first call."""
        if self.final is None:
            self.final = {k: v.detach().clone() for k, v in self.trainer.model.state_dict().items()}
            self.trainer = None
        return self.final


def training(ctx, train_ds, dev_ds) -> Training:
    return Training(ctx, train_ds, dev_ds)


def _leaf_gap(prog: dict, want: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in want.items() if k in keep}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k in keep:
        if k not in prog:
            return float("inf")
        g = float(prog[k].float().norm())
        if not np.isfinite(g):
            return float("inf")
        worst = max(worst, abs(g - norms[k]) / max(norms[k], median, 1e-30))
    return worst


def compare_training(ctx, t: Training, control: str | None = None) -> dict:
    """The set-up steps against the reference's from the same weights, rows
    and draws; the last evaluation against the reference's evaluation of
    the final parameters. ``control``: a precision of the reference put in
    the program's place, or ``drop_half`` (a reference whose steps and
    evaluation average the loss over half of each batch). The cell's limits
    name the numbers compared; the others are readings."""
    m = model_dims(ctx.config, "cnn2d")
    recipe, bs = ctx.traffic["recipe"], ctx.traffic["batch_size"]
    n = len(t.losses)
    order = np.arange(len(t.train_ds))
    np.random.default_rng(t.seed * ORDER_STRIDE).shuffle(order)
    batches = [(torch.as_tensor(t.train_ds.features[idx], device=ctx.device),
                torch.as_tensor(t.train_ds.labels[idx].astype(np.float32), device=ctx.device))
               for idx in (order[i * bs : (i + 1) * bs] for i in range(n))]
    sd0 = {k: v.float() for k, v in t.sd0.items() if v.is_floating_point()}
    final = t.release()
    want = ref.train_steps(sd0, batches, recipe, t.seed, m)
    if control:
        got = ref.train_steps(sd0, batches, recipe, t.seed, m, p="f32" if control == "drop_half" else control,
                              drop_half=control == "drop_half")
        losses, first = got["losses"], got["first_grads"]
        change = {k: got["params"][k] - sd0[k] for k in got["params"]}
    else:
        losses = t.losses
        first = {k: v / (1.0 - ref.BETAS[0]) for k, v in (t.first_moments or {}).items()}
        change = {k: t.after[k] - sd0[k] for k in t.after}
    grads = want["first_grads"]
    median_grad = float(np.median([float(g.norm()) for g in grads.values()]))
    moved = [k for k, g in grads.items() if float(g.norm()) >= MOVED * median_grad]
    ref_change = {k: want["params"][k] - sd0[k] for k in want["params"]}
    numbers = {
        # the first step's loss: the later steps' read the round-off of Adam's first, sign-like update
        "loss1_gap": gap(losses[:1], want["losses"][:1], relative=True),
        "loss_gap": gap(losses, want["losses"], relative=True),
        "grad_gap": _leaf_gap(first, grads, list(grads)),
        "change_gap": _leaf_gap(change, ref_change, moved),
    }
    dev = t.dev_ds
    state = {k: v.float() for k, v in final.items() if v.is_floating_point()}
    logits = ref.logits_of_rows(state, dev.features, ctx.device)
    ev = t.last_eval
    if control in ("tf32", "fp8"):  # the reference's evaluation of the same parameters at that precision
        low = ref.logits_of_rows(state, dev.features, ctx.device, control)
        ev = {"avg_loss": _dev_loss(low, dev.labels, recipe), "eer": ref.eer(low, dev.labels)}
    elif control == "drop_half":  # the evaluation's mean over the first half of each batch
        keep = (np.arange(len(logits)) % bs) < bs // 2
        ev = {"avg_loss": _dev_loss(logits[keep], dev.labels[keep], recipe), "eer": ref.eer(logits, dev.labels)}
    numbers["dev_loss_gap"] = gap([ev["avg_loss"]], [_dev_loss(logits, dev.labels, recipe)], relative=True)
    numbers["dev_eer_gap"] = gap([ev["eer"]], [ref.eer(logits, dev.labels)])
    # the parameters the window's epochs left bit for bit as set-up handed them over (AdamW's decay alone moves each)
    ran = ctx.record.counters.get("epochs", 0) > 0 and not control
    numbers["window_unmoved"] = float(sum(torch.equal(final[k], v) for k, v in t.after.items())) if ran else 0.0
    return numbers


def _dev_loss(logits: np.ndarray, labels: np.ndarray, recipe: dict) -> float:
    ls = recipe["label_smoothing"]
    x = torch.as_tensor(np.asarray(logits, np.float64))
    y = torch.as_tensor(np.asarray(labels, np.float64)) * (1.0 - ls) + 0.5 * ls
    return float(ref.bce(x, y).mean())
