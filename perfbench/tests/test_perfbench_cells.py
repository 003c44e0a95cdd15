"""Every cell runs end to end on the CPU at a tiny size, untraced and traced, and prints its result line."""

from __future__ import annotations

import json

import pytest
from conftest import tiny

from perfbench import run
from perfbench.lib import bench

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def result(capsys, argv, **kw) -> dict:
    assert run.main(argv, **kw) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    # the numbers compared are the last lines of standard error, in the result's order
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    return line


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell, trace, cpu, capsys):
    argv = ["--workload", cell, "--seed", str(2**31 + 7), "--seconds", "0.5", "--trace", str(trace)]
    line = result(capsys, argv, device=cpu, overrides=tiny(cell))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) \
        + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line
    assert set(line["checks"]) == set(bench.data("cells", cell)["limits"])
    spec = bench.benchmark()
    kind = run.LAYER if trace else run.E2E
    expected = {m["name"] for m in run.metrics_of(spec, cell, kind)}
    assert set(line["metrics"]) <= expected
    if not trace:  # host-clock end-to-end metrics exist on any device
        assert set(line["metrics"]) == expected
    else:  # the device-trace readers find nothing on the CPU, and stay silent
        assert line["device"]["busy_s"] == 0.0 and line["breakdown"]["device_ops"] == []
        assert not any(m in line["metrics"] for m in expected if "roofline" in m or "idle_share" in m)


def test_same_seed_same_inputs(cpu):
    cell = "cnn2d-score-f32"
    a = run.run_cell(cell, 5, 0.2, False, cpu, tiny(cell))
    b = run.run_cell(cell, 5, 0.2, False, cpu, tiny(cell))
    ra, rb = a[1].done[:3], b[1].done[:3]
    assert [(r.start, r.rows) for r in ra] == [(r.start, r.rows) for r in rb]
    assert all((x.answers["score"] == y.answers["score"]).all() for x, y in zip(ra, rb))


def test_every_seed_sends_the_same_sizes():
    traffic = bench.data("traffic", "shards-256-2048")
    drv = bench.module("drivers", "score_requests")
    k = traffic["request_rows"]["cycle"]
    for seed in (1, 2**31 + 11):
        stream = drv.requests(traffic, seed, traffic["corpus_utterances"])
        sizes = sorted(next(stream).rows for _ in range(k))
        assert sizes == sorted(drv.request_sizes(traffic))
    assert min(drv.request_sizes(traffic)) >= 256 and max(drv.request_sizes(traffic)) <= 2048


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
