"""CNN2D's operations per utterance, and the roofline bound of the fused conv-block kernel (K2).

A conv counts 2 operations per multiply-add: ``2 * 9 * C_in * C_out`` per
output pixel, at the block's input size (T = 321, 160, 80 at F = 180).
Bias, BatchNorm, ReLU, pools and dropout are not counted. The head is the
mean over time (not counted) and one ``4c * F`` dot product.
"""

from __future__ import annotations

from perfbench.lib.peaks import bound

POOLED = (True, True, False)  # blocks 1 and 2 pool over time


def _blocks(m: dict) -> list[tuple[int, int, int]]:
    """(C_in, C_out, conv rows) of the three convs at the model's frames."""
    c = m["base_channels"]
    ch = [1, c, 2 * c, 4 * c]
    t, out = m["frames"], []
    for i in range(3):
        out.append((ch[i], ch[i + 1], t))
        t = t // 2 if POOLED[i] else t
    return out


def conv_flops(m: dict) -> list[int]:
    """Each conv's operations per utterance, forward."""
    return [2 * 9 * ci * co * t * m["in_features"] for ci, co, t in _blocks(m)]


def head_flops(m: dict) -> int:
    return 2 * 4 * m["base_channels"] * m["in_features"]


def forward_flops(m: dict) -> int:
    """Operations of one utterance's forward pass (3,218,376,960 at full width:
    3,218,330,880 in the convs and 46,080 in the head)."""
    return sum(conv_flops(m)) + head_flops(m)


def train_step_flops(m: dict) -> int:
    """Operations of one utterance's training step: the forward, each conv's
    and the head's weight gradient (as many as its forward), and each
    input gradient but conv 1's (whose input needs none)."""
    convs = conv_flops(m)
    return 2 * sum(convs) + sum(convs[1:]) + 3 * head_flops(m)


def k2_block_bounds(m: dict, batch: int, dtype: str) -> list[tuple[float, str]]:
    """(ms, limiter) of K2's three launches on a batch (``chip_smoke.py``'s
    ``block_bound``): the input read once and the output written once, at
    2 bytes (bf16) or 4 (f32); the conv rows that a floor-mode pool keeps
    (an odd trailing row is not computed); f32 on the CUDA cores, bf16 on the
    tensor cores."""
    size = 4 if dtype == "float32" else 2
    kind = "f32" if dtype == "float32" else "bf16"
    f, out = m["in_features"], []
    for (ci, co, t), pool in zip(_blocks(m), POOLED):
        rows = t - t % 2 if pool else t
        t_out = t // 2 if pool else t
        io = batch * f * (t * ci + t_out * co) * size
        out.append(bound(io, **{kind: 2 * batch * rows * f * 9 * ci * co}))
    return out


def k2_batch_bound_s(m: dict, batch: int, dtype: str) -> float:
    """Seconds K2 needs at least for one batch: its three launches' bounds summed."""
    return sum(ms for ms, _ in k2_block_bounds(m, batch, dtype)) / 1e3
