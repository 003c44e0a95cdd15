"""Closed-loop scoring: one client hands the program a shard of a corpus and waits for its scores.

That is what ``predict`` and ``predict_hybrid`` are to their users: a
caller passes a corpus and waits for its scores. The traffic file gives
the in-memory host corpus's size, the program's batch, and the request
sizes: a cycle of ``cycle`` sizes spread evenly over [``min``, ``max``]
rows (the midpoints of ``cycle`` equal slices of the uniform law), each
cycle in a new order drawn from the seed, each request a contiguous row
range at a start drawn from the seed. Every seed sends the same sizes,
so a run's work does not depend on its seed.

Set-up makes the corpus and the weights from the seed and scores one
request, which warms every shape (every batch of the program is padded to
one size). The window then sends requests back to back until
``--seconds`` have passed; a request's latency runs from the call into the
program to its scores as host arrays. After the window, a sample of the
finished requests drawn from the seed, with the largest among them, is
compared with the plain reference.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.lib.bench import CORPUS, REQUESTS, SAMPLE, derived_seed
from perfbench.lib.seeded import host_dataset, labeled_corpus


@dataclasses.dataclass
class Request:
    start: int
    rows: int
    answers: dict | None = None


def request_sizes(traffic: dict) -> list[int]:
    r = traffic["request_rows"]
    k = r["cycle"]
    return [int(round(r["min"] + (r["max"] - r["min"]) * (i + 0.5) / k)) for i in range(k)]


def requests(traffic: dict, seed: int, n_rows: int):
    """Endless requests: each cycle of :func:`request_sizes` in a new order."""
    rng = np.random.default_rng(derived_seed(seed, REQUESTS))
    sizes = np.asarray(request_sizes(traffic))
    while True:
        for rows in sizes[rng.permutation(len(sizes))]:
            rows = int(min(rows, n_rows))
            yield Request(int(rng.integers(0, n_rows - rows + 1)), rows)


def shard(corpus, req: Request):
    """The request's rows of the corpus, as a view."""
    from dfac_tpu_torch.data.pipeline import ArrayDataset

    s, e = req.start, req.start + req.rows
    return ArrayDataset(uttids=corpus.uttids[s:e], features=corpus.features[s:e], labels=corpus.labels[s:e])


def sample(done: list[Request], seed: int, k: int) -> list[Request]:
    """``k`` finished requests drawn from the seed, and the largest."""
    rng = np.random.default_rng(derived_seed(seed, SAMPLE))
    pick = set(rng.choice(len(done), size=min(k, len(done)), replace=False).tolist())
    pick.add(max(range(len(done)), key=lambda i: done[i].rows))
    return [done[i] for i in sorted(pick)]


class Outcome:
    def __init__(self, serving, corpus):
        self.serving, self.corpus = serving, corpus
        self.done: list[Request] = []
        self.failed = 0

    @property
    def attempted(self) -> int:
        return len(self.done)


def run(ctx) -> Outcome:
    import torch

    tr = ctx.traffic
    ctx.mark("start")
    feats, labels = labeled_corpus(tr["corpus_utterances"], **ctx.config["input"],
                                   gen=ctx.generator(CORPUS), device=ctx.device)
    ctx.mark("corpus")
    serving = ctx.system.serving(ctx, feats, labels)
    ctx.mark("weights")
    corpus = host_dataset(feats, labels, "utt")
    del feats
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("host copy")
    out = Outcome(serving, corpus)
    stream = requests(tr, ctx.seed, len(corpus))
    serving.score(shard(corpus, next(stream)))  # warm-up: builds, loads and caches every shape
    ctx.begin_window()
    before = serving.counters()
    w0 = time.perf_counter()
    with ctx.record.span("window"):
        while time.perf_counter() - w0 < ctx.seconds:
            req = next(stream)
            with ctx.record.span("request"):  # the latency: the call into the program to its host arrays
                req.answers = serving.score(shard(corpus, req))
            out.done.append(req)
    ctx.window_s = time.perf_counter() - w0
    for k, v in serving.counters().items():
        ctx.record.add(k, v - before.get(k, 0.0))
    ctx.end_window()
    ctx.record.add("rows", sum(r.rows for r in out.done))
    for r in out.done:
        if any(len(a) != r.rows or not np.all(np.isfinite(a)) for a in r.answers.values()):
            out.failed += 1
    return out


def check(ctx, out: Outcome, control: str | None = None) -> dict:
    """The numbers compared, on the sample; ``control`` puts the reference in
    the program's place at that lower precision."""
    picked = sample(out.done, ctx.seed, ctx.traffic["sample_requests"])
    inputs = out.serving.release()
    return ctx.system.compare_scores(ctx, inputs, [(shard(out.corpus, r), r.answers) for r in picked], control)
