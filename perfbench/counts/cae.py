"""The autoencoder's operations per utterance, forward.

Encoder convs count ``2 * 9 * C_in * C_out`` per output pixel at their
input size; a transposed conv with kernel 2 and stride 2 counts ``2 * 4 *
C_in * C_out`` per input pixel. Bias, BatchNorm, ReLU, pools and the MSE
are not counted. At base 32 on 321 x 180: about 1.79 GFLOP.
"""

from __future__ import annotations


def forward_flops(m: dict) -> int:
    """``m``: the base width and the input's frames and features."""
    c = m["base_channels"]
    enc = [1, c, 2 * c, 4 * c, 8 * c]
    t, f, total, pre = m["frames"], m["in_features"], 0, []
    for i in range(4):
        total += 2 * 9 * enc[i] * enc[i + 1] * t * f
        pre.append((t, f))
        t, f = t // 2, f // 2
    dec = [8 * c, 4 * c, 2 * c, c, 1]
    # each transposed conv restores its encoder stage's size before the pool
    for i, (ti, fi) in enumerate([(t, f)] + pre[:0:-1]):
        total += 2 * 4 * dec[i] * dec[i + 1] * ti * fi
    return total
