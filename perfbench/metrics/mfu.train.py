"""The training window's model operations per second, as a share of the card's peak at the configuration's precision.

Each training utterance counts one step's operations
(``counts/cnn2d.train_step_flops``: the forward, the weight gradients and
the input gradients but conv 1's), each dev utterance one forward; their
sum over the window's seconds (host clock) and the published dense peak
(f32 on the CUDA cores 67 TFLOP/s; ``lib/peaks.py``).
"""

from perfbench.lib.bench import model_dims, module
from perfbench.lib.peaks import DTYPE_PEAK, PEAK_FLOPS


def read(run):
    rows, dev_rows = run.counter("rows"), run.counter("dev_rows")
    if not rows or run.window_s <= 0:
        return None
    counts = module("counts", "cnn2d")
    m = model_dims(run.config, "cnn2d")
    ops = rows * counts.train_step_flops(m) + dev_rows * counts.forward_flops(m)
    return 100.0 * ops / run.window_s / PEAK_FLOPS[DTYPE_PEAK[run.config["dtype"]]]
