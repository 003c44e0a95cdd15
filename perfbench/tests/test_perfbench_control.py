"""On the card: the control, in the program's place, comes out not correct; the program comes out correct.

The control is the plain reference at the precision below the one the
configuration states (TF32 for float32; fp8 operands for bfloat16); a
training cell is also held against the reference with half of each batch
left out. Full widths, each
cell's own batch, a smaller corpus so that the test holds in a test run,
three seeds each.

    python -m pytest perfbench/tests/test_perfbench_control.py -q   # on a machine with a card
"""

from __future__ import annotations

import pytest

from perfbench.lib import bench
from perfbench.run import run_cell

CONTROLS = {"cnn2d-score-f32": ["tf32"], "hybrid-score-bf16": ["fp8"],
            "cnn2d-train-b32": ["tf32", "drop_half"], "cnn2d-train-b512": ["tf32", "drop_half"]}
SMALL = {"score_requests": {"corpus_utterances": 2048, "sample_requests": 4},
         "train_epochs": {"train_utterances": 1536, "dev_utterances": 512}}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 2**31 + 42, 43])
@pytest.mark.parametrize("cell", list(CONTROLS))
def test_control_is_not_correct(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = bench.data("cells", cell)
    ctx, out, numbers = run_cell(cell, seed, 2.0 if c["driver"] == "score_requests" else 0.0, False,
                                 overrides={"traffic": SMALL[c["driver"]]})
    limits = c["limits"]
    assert all(numbers[k] <= limits[k] for k in limits), numbers
    driver = bench.module("drivers", c["driver"])
    for control in CONTROLS[cell]:
        got = driver.check(ctx, out, control)
        assert any(got[k] > limits[k] for k in limits), (control, got)
