"""The published peaks of one NVIDIA H100 SXM and the roofline bound.

A frozen copy of ``chip_smoke.py``'s ``PEAK_FLOPS``, ``HBM_BYTES_PER_S``
and ``bound()``: NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the full 700 W power limit. f32 counts the CUDA cores (TF32
off), bf16 the tensor cores; int8 is operations a second.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12, "int8": 1979e12}
DTYPE_PEAK = {"float32": "f32", "bfloat16": "bf16"}  # a configuration's dtype -> its peak's key


def bound(n_bytes: float, **flops: float) -> tuple[float, str]:
    """(ms, limiter): the larger of ``n_bytes`` over the HBM rate and the
    operations of each type over its peak (``f32=``, ``bf16=`` ...; the
    tensor cores and the CUDA cores work at once, so the largest counts)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((n / PEAK_FLOPS[kind] for kind, n in flops.items()), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
