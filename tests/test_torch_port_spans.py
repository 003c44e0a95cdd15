"""The port's program spans (``dfac_tpu_torch/obs/profiling.py``) and the benchmark's readers of them, on the CPU.

* With no profiler the scoring and training paths record nothing and
  return bit for bit what they return under one.
* Under ``torch.profiler`` one ``predict_scores_fast`` call records
  ``score`` with ``score.fold``, ``ingest.start``, ``ingest.wait`` and
  ``score.fetch`` inside it, all of one call on the scoring thread; its counts are the call's rows and pad rows; the waits'
  spans and ``PrefetchStats.host_wait_s`` are one measurement, also for
  ``cae_mse_scores_fast``'s ``stats``.
* ``train_epoch`` records one ``train.step`` per batch and a
  ``train.fetch``, ``evaluate`` an ``eval`` and its ``eval.fetch``.
* A span's real-time ends enclose the profiler's record of the op it wraps.
* The list is bounded and counts what it drops, from many threads at once.
* The benchmark's ``idle_*`` readers split the device idle of a window
  among the spans exactly, and read nothing from a program without spans.
"""

from __future__ import annotations

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfac_tpu_torch.data.normalizer import FeatureNormalizer
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.io.prefetch import PrefetchStats
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.models.fast_infer import cae_mse_scores_fast, predict_scores_fast
from dfac_tpu_torch.obs import profiling
from dfac_tpu_torch.train.loop import TrainConfig, Trainer
from perfbench.lib import bench, program_spans
from perfbench.lib.device_trace import DeviceTrace

F_, T_, BC, B = 16, 17, 4, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _dataset(n: int, seed: int = 0) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    return ArrayDataset(uttids=[f"u{i}" for i in range(n)],
                        features=rng.standard_normal((n, F_, T_), dtype=np.float32),
                        labels=(np.arange(n) % 2).astype(np.int32))


def _weights() -> dict:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_model("cnn2d", in_features=F_, base_channels=BC, dropout=0.0).state_dict()


def _score(ds, stats=None):
    return predict_scores_fast(_weights(), ds, CPU, B, compute_dtype=torch.float32, stats=stats)


def _trainer(resident: bool) -> Trainer:
    cfg = TrainConfig(model="cnn2d", in_features=F_, batch_size=B, epochs=1, lr=1e-3, dropout=0.0, seed=3,
                      device_resident=resident)
    t = Trainer(cfg, device="cpu", model=build_model("cnn2d", in_features=F_, base_channels=BC, dropout=0.0))
    t.init_state()
    return t


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_no_profiler_records_nothing_and_changes_nothing():
    ds, dev = _dataset(20), _dataset(12, seed=1)
    plain = _score(ds)
    a, b = _trainer(True), _trainer(True)
    loss_a, eval_a = a.train_epoch(ds, 1), a.evaluate(dev)
    assert profiling.spans() == [] and profiling.dropped() == 0
    (traced, loss_b, eval_b), _ = _traced(lambda: (_score(ds), b.train_epoch(ds, 1), b.evaluate(dev)))
    assert profiling.spans()
    assert np.array_equal(plain, traced) and loss_a == loss_b and eval_a == eval_b
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_one_scoring_call_records_its_spans():
    stats = PrefetchStats()
    ds = _dataset(20)
    _traced(lambda: _score(ds, stats))
    kept = profiling.spans()
    names = Counter(s.name for s in kept)
    assert names == {"score": 1, "score.fold": 1, "ingest.start": 1, "score.fetch": 1,
                     "ingest.wait": 4}  # three batches and the end of the feed
    (root,) = [s for s in kept if s.name == "score"]
    assert root.parent is None and root.call == root.id
    assert all(s.call == root.id and s.parent == root.id for s in kept if s is not root)
    assert {s.thread for s in kept} == {root.thread}
    for s in kept:
        if s is not root:
            assert root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns, s.name
    waits = [s.ns for s in kept if s.name == "ingest.wait"]
    assert stats.host_wait_s == pytest.approx(sum(waits) / 1e9, rel=1e-9)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 20, 24])
def test_rows_padded_counts_the_pad_rows(n):
    _traced(lambda: _score(_dataset(n)))
    (root,) = [s for s in profiling.spans() if s.name == "score"]
    batches = -(-n // B)
    assert root.counts == {"rows": n, "rows_padded": batches * B - n}


def test_cae_mse_scores_fast_counts_its_waits():
    cae_f, cae_t = 20, 37  # the CAE's geometry wants a width and a length it can halve and restore
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        weights = build_model("cae", base_channels=BC).state_dict()
    feats = np.random.default_rng(3).standard_normal((11, cae_f, cae_t), dtype=np.float32)
    ds = ArrayDataset(uttids=[f"u{i}" for i in range(11)], features=feats)
    norm = FeatureNormalizer(np.zeros(cae_f, np.float32), np.ones(cae_f, np.float32))

    def mse(stats=None):
        return cae_mse_scores_fast(weights, ds, norm, CPU, 4, compute_dtype=torch.float32, stats=stats)

    plain, stats = mse(), PrefetchStats()
    assert np.array_equal(mse(stats), plain) and stats.items == 3 and stats.host_wait_s > 0
    traced_stats = PrefetchStats()
    traced, _ = _traced(lambda: mse(traced_stats))
    waits = [s.ns for s in profiling.spans() if s.name == "ingest.wait"]
    assert np.array_equal(traced, plain) and len(waits) == 4 and traced_stats.items == 3
    assert traced_stats.host_wait_s == pytest.approx(sum(waits) / 1e9, rel=1e-9)


@pytest.mark.parametrize("resident", [True, False])
def test_train_epoch_and_evaluate_record_their_spans(resident):
    ds, dev = _dataset(20), _dataset(12, seed=1)
    t = _trainer(resident)
    _traced(lambda: (t.train_epoch(ds, 1), t.evaluate(dev)))
    kept = profiling.spans()
    (epoch,) = [s for s in kept if s.name == "train.epoch"]
    steps = [s for s in kept if s.name == "train.step"]
    assert epoch.counts == {"steps": 3, "rows": 20} and epoch.parent is None
    assert sorted(s.counts["rows"] for s in steps) == [4, 8, 8]
    (fetch,) = [s for s in kept if s.name == "train.fetch"]
    assert all(s.parent == epoch.id for s in steps + [fetch]) and fetch.t0_ns >= max(s.t1_ns for s in steps)
    (ev,) = [s for s in kept if s.name == "eval"]
    (ev_fetch,) = [s for s in kept if s.name == "eval.fetch"]
    assert ev.counts == {"rows": 12} and ev.call != epoch.call and ev_fetch.parent == ev.id
    waits = [s for s in kept if s.name == "ingest.wait"]
    # a host-fed epoch waits on its prefetch thread inside each step (and once more for the feed's end,
    # under the step span that found no batch, which is not kept); the resident feed has no thread
    assert sum(w.parent in {s.id for s in steps} for w in waits) == (0 if resident else 3)
    assert sum(w.parent == ev.id for w in waits) == (0 if resident else 2)  # zip stops before the feed's end


def test_span_ends_enclose_the_op_it_wraps():
    a = torch.ones(128, 128)

    def wrapped():
        sp = profiling.open_span("score", root=True)
        (a @ a).sum()
        return profiling.close_span(sp)

    sp, prof = _traced(wrapped)
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert sp.t0_ns <= mm.start_ns() and mm.start_ns() + mm.duration_ns() <= sp.t1_ns
    assert 0 < sp.ns and 0 < mm.duration_ns() <= sp.t1_ns - sp.t0_ns


def test_the_bound_and_the_dropped_count_from_many_threads(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 100)
    threads, each = 16, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def record():
            for _ in range(each):
                root = profiling.open_span("score", root=True)
                profiling.close_span(profiling.open_span("score.fold"))
                profiling.close_span(root)

        workers = [threading.Thread(target=record) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert len(profiling.spans()) == 100 and profiling.dropped() == 2 * threads * each - 100
    assert len({s.id for s in profiling.spans()}) == 100
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped() == 0


IDLE_PARTS = ("idle_fold.score", "idle_start.score", "idle_ingest.score", "idle_fetch.score", "idle_self.score",
              "idle_outside.score")


class _Span:
    def __init__(self, name, t0, t1, thread=1):
        self.name, self.t0_ns, self.t1_ns, self.ns, self.thread, self.counts = name, t0, t1, t1 - t0, thread, {}


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_idle_split_sums_to_the_idle_share(monkeypatch):
    # a window of 1,000 ns; the card busy over [100, 150), [300, 360), [500, 900) after its start
    trace = DeviceTrace(CPU)
    trace.window = (1_000, 2_000)
    trace.ops = [("k", 1_100, 1_150), ("k", 1_300, 1_340), ("k", 1_330, 1_360), ("k", 1_500, 1_900)]
    calls = []
    for c0 in (1_050, 1_500):  # two calls, each: fold, a wait, the thread's start, a wait, the fetch
        calls += [_Span("score", c0, c0 + 400), _Span("score.fold", c0 + 10, c0 + 60),
                  _Span("ingest.wait", c0 + 70, c0 + 140), _Span("ingest.start", c0 + 200, c0 + 208),
                  _Span("ingest.wait", c0 + 210, c0 + 260), _Span("score.fetch", c0 + 300, c0 + 390)]
    other = [_Span("train.step", 1_000, 2_000, thread=2)]  # another thread's spans name no idle time
    early = [_Span("score", 900, 1_100)]  # not inside the window
    monkeypatch.setattr(profiling, "spans", lambda: calls + other + early)
    read = {m: bench.module("metrics", m).read(_Run(trace)) for m in IDLE_PARTS + ("idle_share.score",)}
    split = program_spans.score_idle(_Run(trace))
    # idle [0, 100), [150, 300), [360, 500), [900, 1000) after the window's start; the second call is all busy
    assert split == {"outside": 50 + 50 + 100, "score": 10 + 60 + 2 + 10, "score.fold": 40, "ingest.start": 8,
                     "ingest.wait": 40 + 40, "score.fetch": 80}
    assert read["idle_fold.score"] == pytest.approx(4.0) and read["idle_outside.score"] == pytest.approx(20.0)
    assert read["idle_self.score"] == pytest.approx(8.2) and read["idle_start.score"] == pytest.approx(0.8)
    assert sum(read[m] for m in IDLE_PARTS) == pytest.approx(read["idle_share.score"], abs=1e-12)
    assert read["idle_share.score"] == pytest.approx(100.0 * sum(split.values()) / 1_000, abs=1e-12)
    # a program without spans (an older commit) gives every reader nothing
    monkeypatch.delattr(profiling, "spans")
    assert all(bench.module("metrics", m).read(_Run(trace)) is None for m in IDLE_PARTS + ("pad_share.score",))
