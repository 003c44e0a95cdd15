"""BENCHMARK.json keeps to the benchmark's contract, and every name in it resolves to its files."""

from __future__ import annotations

import json
import re

import pytest

from perfbench.lib import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return bench.benchmark()


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(spec["workloads"])
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200, "24 cells must fit a check"
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, cells // 4)


def test_names_units_and_whys(spec):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in spec["configs"] + spec["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys(spec, kind):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[kind]
    for e in spec[kind]:
        extra = set(e) - keys
        assert keys <= set(e) and extra <= {"workloads"} and not (extra and kind in ("configs", "workloads")), e


def test_bounds(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_resolves_to_its_files(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cell = bench.data("cells", w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert w["chips"] in (1, 4)
        bench.data("traffic", w["traffic"])
        assert hasattr(bench.module("drivers", cell["driver"]), "run")
        assert hasattr(bench.module("systems", w["config"]), "serving" if cell["driver"] == "score_requests"
                       else "training")
        conf = json.loads((bench.ROOT / configs[w["config"]]["file"]).read_text())
        assert conf["reduced"] == configs[w["config"]]["reduced"] == []
        assert configs[w["config"]]["file"] == f"perfbench/configs/{w['config']}.json"


def test_every_metric_has_a_reader_and_every_cell_its_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e_in = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e_in and set(m["workloads"]) <= e2e_in[m["moves"]]
        assert 1 <= len(m["layer"]) <= 200
    for c in cells:
        reported = [n for n, ws in e2e_in.items() if c in ws]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(c in m["workloads"] for m in spec["per_layer"])


def test_roofline_and_mfu_names(spec):
    for m in spec["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    moves = {m["moves"] for m in spec["per_layer"] if "roofline" in m["name"]}
    assert moves <= {m["moves"] for m in spec["per_layer"] if "mfu" in m["name"]}


def test_files_are_named_from_names():
    for path in bench.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(bench.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
