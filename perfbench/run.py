"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (``perfbench/cells/<cell>.json``) names its configuration,
traffic mix and timed loop (``perfbench/drivers/``), which makes its inputs and weights from
``--seed``, warms every shape the cell uses (set-up), measures for
``--seconds``, then compares what the timed path produced with the plain
reference. With ``--trace 0`` the result carries the cell's end-to-end
metrics (``BENCHMARK.json``'s ``end_to_end``); with ``--trace 1`` the
window runs under ``torch.profiler`` and the result carries its per-layer
metrics, the device's busy and window seconds and a breakdown.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``),
then ``checks``, each number compared beside its limit; the same numbers
are the last lines of standard error. The run exits non-zero and prints no
result where the cards are missing, the program cannot be imported, or
the JAX package (or JAX itself) is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import bench  # noqa: E402
from perfbench.lib.guard import forbidden_loaded  # noqa: E402

E2E, LAYER = "end_to_end", "per_layer"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class RunView:
    """What a metric reader reads: the record, the device trace, the configuration and traffic, the clocks."""

    def __init__(self, ctx):
        self.record, self.trace = ctx.record, ctx.trace
        self.config, self.traffic = ctx.config, ctx.traffic
        self.window_s, self.setup_s = ctx.window_s, ctx.setup_s

    def counter(self, name: str) -> float:
        return self.record.counters.get(name, 0.0)


def metrics_of(spec: dict, cell_name: str, kind: str) -> list[dict]:
    """The cell's metrics of ``kind``: the end-to-end metrics that list it or
    list no cells; the per-layer metrics that list it (each lists its cells)."""
    if kind == E2E:
        return [m for m in spec[E2E] if cell_name in m.get("workloads", [cell_name])]
    return [m for m in spec[LAYER] if cell_name in m["workloads"]]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None, overrides=None, control=None):
    """One run of cell ``name``: returns ``(ctx, outcome, numbers)``, the
    numbers compared from :func:`check`. ``device`` (default the first
    card) and ``overrides`` (``{"config": {...}, "traffic": {...}}``,
    merged into the files' contents) let the tests run a tiny cell on the
    CPU; ``control`` compares the control in the program's place."""
    import torch

    from perfbench.lib.device_trace import DeviceTrace

    cell = bench.data("cells", name)
    config = {**bench.data("configs", cell["config"]), **(overrides or {}).get("config", {})}
    traffic = {**bench.data("traffic", cell["traffic"]), **(overrides or {}).get("traffic", {})}
    dev = device if device is not None else torch.device("cuda", 0)
    ctx = bench.Context(cell_name=name, cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
                        device=dev, record=bench.Record(), system=bench.module("systems", cell["config"]),
                        trace=DeviceTrace(dev) if trace else None)
    driver = bench.module("drivers", cell["driver"])
    outcome = driver.run(ctx)
    ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev.index) if dev.type == "cuda" else 0
    loaded = forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    numbers = driver.check(ctx, outcome, control)
    gc.collect()
    return ctx, outcome, numbers


class ForbiddenModules(RuntimeError):
    pass


def is_correct(ctx, outcome, numbers: dict) -> bool:
    """Every answer came and every number compared is within its limit."""
    return outcome.failed == 0 and all(numbers[k] <= v for k, v in ctx.cell["limits"].items())


def result_line(spec: dict, name: str, ctx, outcome, numbers: dict) -> dict:
    checks = {k: {"value": numbers[k], "limit": v} for k, v in ctx.cell["limits"].items()}
    correct = is_correct(ctx, outcome, numbers)
    view = RunView(ctx)
    kind = LAYER if ctx.trace is not None else E2E
    metrics = {}
    for m in metrics_of(spec, name, kind):
        value = bench.module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = ctx.device
    import torch

    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    out = {"correct": bool(correct), "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
           "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(10), "idle_gaps": ctx.trace.idle_gaps(10)}
    out["checks"] = checks
    return out


def main(argv=None, device=None, overrides=None) -> int:
    args = parse_args(argv)
    spec = bench.benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if device is None:
        chips = cells[args.workload]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
    try:
        import dfac_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program cannot be imported: {e}", file=sys.stderr)
        return 2
    try:
        ctx, outcome, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                         overrides)
    except ForbiddenModules as e:
        print(f"JAX or the JAX package is loaded in the benchmark's process: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    line = result_line(spec, args.workload, ctx, outcome, numbers)
    loaded = forbidden_loaded()
    if loaded:
        print(f"JAX or the JAX package is loaded in the benchmark's process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    if ctx.device.type == "cuda":
        print(f"card: {card_line()}; setup_s {ctx.setup_s:.3f}, window_s {ctx.window_s:.3f}", file=sys.stderr)
    print("set-up: " + ", ".join(f"{name} at {t:.2f} s" for name, t in ctx.phases), file=sys.stderr)
    for k, v in numbers.items():
        if k not in line["checks"]:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
