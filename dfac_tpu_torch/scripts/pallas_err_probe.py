"""Counterpart of ``scripts/pallas_err_probe.py``: run stage 13's conv
formulations g, i, j, k at B=8 and print each checksum of sample 0.

    python -m dfac_tpu_torch.scripts.pallas_err_probe [g i j k] [--device cuda|cpu]

The JAX script printed the full Mosaic error of a kernel that failed to
compile and went on; here a case that fails raises and the script exits
non-zero, since on the card a caught failure would hide a broken kernel.
Nothing runs at import. The last line gives the run's kernel launches.
"""

from __future__ import annotations

import argparse
import json

import torch

from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.ops import _build, conv_probe
from dfac_tpu_torch.scripts.train_opt_probe import stage13_inputs

B = 8  # the JAX script's batch; its arrays and shapes are stage 13's (train_opt_probe.TP, ...)
CASES = "gijk"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help=f"any of {' '.join(CASES)} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    unknown = [c for c in args.cases if c not in CASES]
    if unknown:
        ap.error(f"unknown case(s) {unknown}; choose from {list(CASES)}")
    device = resolve_device(args.device)
    before = _build.launch_counts()
    arrs = stage13_inputs(B, torch.bfloat16, device)
    sums = {}
    with torch.inference_mode():
        for name in args.cases or CASES:
            case = conv_probe.CASES[name]
            out = case.kernel(arrs[case.inp], arrs[case.weights])
            sums[name] = out[0, 0, 0].item()
            print(f"== {name}: OK {sums[name]:.3f}")
    print(f"kernel launches: {json.dumps(_build.launches_since(before))}")
    return sums


if __name__ == "__main__":
    main()
