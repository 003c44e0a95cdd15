"""What a run is made of, found by name, and what it records.

Every configuration, cell, traffic mix, driver, system adapter and metric
reader is a file of its own under ``perfbench/``, found by the name that
``BENCHMARK.json`` gives it:

* ``cells/<cell>.json``: the configuration, the traffic mix, the timed loop and
  the limits of the numbers compared;
* ``configs/<config>.json``: the models' widths and the precision;
* ``traffic/<traffic>.json``: the parameters one driver reads;
* ``drivers/<driver>.py``: one timed loop per kind of traffic;
* ``systems/<config>.py``: the calls into the program for that
  configuration, and the comparison with its plain reference;
* ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float | None``.

So a later cell, mix or metric is new files and new entries, and no edit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_IMPORTED = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: its start in clock
    ticks after boot), else since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _IMPORTED


def checked_name(name: str) -> str:
    """``name`` if it is a name of the contract (so it names a file and no path)."""
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def data(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    return json.loads((BENCH_DIR / kind / f"{checked_name(name)}.json").read_text())


_MODULES: dict[Path, object] = {}


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` imported by its path (a name may hold
    ``.`` and ``-``), once per process."""
    path = BENCH_DIR / kind / f"{checked_name(name)}.py"
    if path not in _MODULES:
        mod_name = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def model_dims(config: dict, model: str) -> dict:
    """One model's widths with the input's (``in_features``, ``frames``)."""
    return {**config["input"], **config["models"][model]}


def derived_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose (weights, corpus, requests ...) of the
    run's ``--seed``: every purpose draws from its own stream."""
    words = [int(seed) % (1 << 64), *purpose]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


# the purposes of derived_seed
WEIGHTS, CORPUS, REQUESTS, SAMPLE, DEV_CORPUS, CAE_WEIGHTS = range(6)


@dataclasses.dataclass
class Span:
    name: str
    t0: float  # perf_counter seconds
    t1: float
    t0_ns: int = 0  # the real-time clock's ns, the device trace's
    t1_ns: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Record:
    """The benchmark's own spans and counters. A span keeps the host's
    monotonic clock (its length) and its real-time clock, on which the
    device trace's timestamps lie, so that a trace can say what the host
    was doing in each idle gap."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0, t0_ns = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.spans.append(Span(name, t0, time.perf_counter(), t0_ns, time.time_ns()))

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def total(self, name: str) -> float:
        return sum(s.seconds for s in self.spans if s.name == name)

    def durations(self, name: str) -> list[float]:
        return [s.seconds for s in self.spans if s.name == name]


@dataclasses.dataclass
class Context:
    """One run of one cell: what its timed loop and its system adapter read."""

    cell_name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: object  # torch.device
    record: Record
    system: object  # the configuration's systems/<config>.py
    window_s: float = 0.0  # the measured window, host clock
    setup_s: float = 0.0  # process start to the first timed request or epoch
    trace: object = None  # lib.device_trace.DeviceTrace of the window, with --trace 1
    memory_peak_bytes: int = 0  # the device's peak allocation, read when the window has closed
    phases: list = dataclasses.field(default_factory=list)  # (set-up phase, seconds since process start)

    def generator(self, purpose: int):
        import torch

        return torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, purpose))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, for the run's report on standard error."""
        self.sync()
        self.phases.append((phase, process_age_s()))

    def begin_window(self) -> None:
        """Set-up ends: the device is idle, its peak memory counts from here
        (``memory_peak_bytes`` is the window's), the trace (if any) starts."""
        self.mark("warm-up")
        if self.device.type == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats(self.device.index)
        if self.trace is not None:
            self.trace.start()
        self.setup_s = process_age_s()

    def end_window(self) -> None:
        self.sync()
        if self.trace is not None:
            self.trace.stop(self.record.spans)
