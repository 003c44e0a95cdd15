"""The arithmetic a reference runs in: its own precision, or the control's.

* ``f32``: float32 with TF32 off in cuDNN and cuBLAS (the precision the
  configurations state, and the references' own);
* ``tf32``: TF32 on, the control of a float32 configuration;
* ``fp8``: every product's operands rounded to float8 e4m3 with one scale
  per tensor (its largest magnitude to 448), the control of a bfloat16
  configuration.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
PRECISIONS = ("f32", "tf32", "fp8")


@contextlib.contextmanager
def arithmetic(p: str):
    if p not in PRECISIONS:
        raise ValueError(f"unknown precision {p!r}")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = p == "tf32"
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def operand(x: torch.Tensor, p: str) -> torch.Tensor:
    """``x`` as a product reads it in precision ``p``."""
    if p != "fp8":
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
