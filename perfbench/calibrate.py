"""Read the numbers that set a cell's limits: the program's over many seeds, the control's and the faults'.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --first-seed <n> \\
        --controls tf32[,drop_half] --control-seeds 3 [--seconds 3] [--out FILE]

In one process (set-up is paid per seed, the CUDA context once): for each
seed, one run of the cell with a short window (``--seconds``; a training
cell's readings need none, so 0 runs no epoch) and the program's numbers;
for the first ``--control-seeds`` seeds also each control's numbers on the
same inputs and sample, the reference put in the program's place at a
lower precision (``tf32``, ``fp8``) or with a planted fault
(``drop_half``: the loss averaged over half of each batch). Prints one
JSON line per reading and, last, each number's largest program reading
(the lower end of its limit) and smallest reading per control (the upper
end).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import bench  # noqa: E402
from perfbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Program and control readings of a cell's compared numbers.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    controls = [c for c in args.controls.split(",") if c]
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        ctx, out, numbers = run_cell(args.workload, seed, args.seconds, False)
        rows.append({"seed": seed, "label": "program", "numbers": numbers, "failed": out.failed})
        if i < args.control_seeds:
            driver = bench.module("drivers", ctx.cell["driver"])
            for c in controls:
                rows.append({"seed": seed, "label": c, "numbers": driver.check(ctx, out, c)})
        for r in rows[-1 - (len(controls) if i < args.control_seeds else 0):]:
            print(json.dumps({"workload": args.workload, **r}), flush=True)
        del ctx, out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    summary = {}
    for name in rows[0]["numbers"]:
        summary[name] = {"program_max": max(r["numbers"][name] for r in rows if r["label"] == "program")}
        for c in controls:
            vals = [r["numbers"][name] for r in rows if r["label"] == c]
            summary[name][f"{c}_min"] = min(vals) if vals else None
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n" + json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
