"""The scoring window's model operations per second, as a share of the card's peak at the configuration's precision.

Each model of the configuration counts its forward operations per
utterance (``counts/<model>.forward_flops``), times the utterances scored
in the window, over the window's seconds (host clock) and the published
dense peak (f32 on the CUDA cores 67 TFLOP/s, bf16 on the tensor cores
989 TFLOP/s; ``lib/peaks.py``).
"""

from perfbench.lib.bench import model_dims, module
from perfbench.lib.peaks import DTYPE_PEAK, PEAK_FLOPS


def read(run):
    rows = run.counter("rows")
    if not rows or run.window_s <= 0:
        return None
    per_utt = sum(module("counts", m).forward_flops(model_dims(run.config, m)) for m in run.config["models"])
    return 100.0 * per_utt * rows / run.window_s / PEAK_FLOPS[DTYPE_PEAK[run.config["dtype"]]]
