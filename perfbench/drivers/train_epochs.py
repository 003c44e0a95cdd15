"""Whole training epochs, each followed by the dev evaluation, as ``fit``'s epoch loop runs them.

The traffic file gives the training and dev corpora's sizes, the batch,
whether the corpus lives on the device, the number of set-up steps and
the recipe. Set-up makes both corpora and the weights from the seed,
builds the configuration's trainer, runs the first ``setup_steps`` steps
of the window's own call (which the reference follows) and one
evaluation, so that every shape of the window has run once. The window then runs epoch after epoch (epoch
1, 2, ...: each its own order) with the evaluation after each, and stops
before an epoch that would end past ``--seconds`` by the epochs' mean
length (at least one epoch runs; ``--seconds 0`` runs none, for the
readings of the comparison alone). The plateau scheduler, checkpoints and
the display of ``fit`` are left out: a window this short never reaches a
plateau.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.lib.bench import CORPUS, DEV_CORPUS
from perfbench.lib.seeded import host_dataset, labeled_corpus


class Outcome:
    def __init__(self, training):
        self.training = training
        self.losses: list = []
        self.steps_per_epoch = 0

    @property
    def attempted(self) -> int:
        return len(self.losses) * self.steps_per_epoch

    @property
    def failed(self) -> int:
        return sum(self.steps_per_epoch for x in self.losses if x is None or not np.isfinite(x))


def run(ctx) -> Outcome:
    tr = ctx.traffic
    ctx.mark("start")
    corpora = []
    for n, purpose, tag in ((tr["train_utterances"], CORPUS, "train"), (tr["dev_utterances"], DEV_CORPUS, "dev")):
        feats, labels = labeled_corpus(n, **ctx.config["input"], gen=ctx.generator(purpose), device=ctx.device)
        corpora.append(host_dataset(feats, labels, tag))
        del feats
    ctx.mark("corpora")
    training = ctx.system.training(ctx, *corpora)
    ctx.mark("trainer")
    training.setup_steps(tr["setup_steps"])
    ctx.mark("steps")
    training.evaluate()
    out = Outcome(training)
    out.steps_per_epoch = -(-tr["train_utterances"] // tr["batch_size"])
    ctx.begin_window()
    w0 = time.perf_counter()
    with ctx.record.span("window"):
        epoch = 0
        while ctx.seconds > 0:
            epoch += 1
            with ctx.record.span("train_epoch"):
                out.losses.append(training.epoch(epoch))
            with ctx.record.span("evaluate"):
                training.evaluate()
            elapsed = time.perf_counter() - w0
            if elapsed + elapsed / epoch > ctx.seconds:
                break
    ctx.window_s = time.perf_counter() - w0
    ctx.end_window()
    ctx.record.add("epochs", epoch)
    ctx.record.add("rows", epoch * tr["train_utterances"])
    ctx.record.add("dev_rows", epoch * tr["dev_utterances"])
    return out


def check(ctx, out: Outcome, control: str | None = None) -> dict:
    return ctx.system.compare_training(ctx, out.training, control)
