"""Standalone (2,1) time pool: kernel 5 and its plain PyTorch version.

Counterpart of the Pallas pool in ``scripts/pool_kernel_probe.py``
(``_pool_kernel`` :81, ``pool_pallas`` :89-109): a floor-mode (2, 1)
average over time on NHWC tensors,

    h (B, T, F, C) -> (B, T // 2, F, C),  out[:, t] = dtype(dtype(h[:, 2t] + h[:, 2t+1]) * 0.5)

with the sum rounded to the input dtype before the halving, as the Pallas
body adds in its input dtype (halving is exact, so this is one rounding of
the mean). An odd last row is dropped.

On a CUDA tensor :func:`time_pool` launches the kernel in
``csrc/pool_kernel.cu``; on a CPU tensor it runs :func:`time_pool_plain`.
It never falls back.
"""

from __future__ import annotations

import torch

from dfac_tpu_torch.ops import _build


def time_pool_plain(h: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: f32 arithmetic, rounded to h's
    dtype after the add and after the halving."""
    t2 = h.shape[1] - h.shape[1] % 2
    s = (h[:, 0:t2:2].float() + h[:, 1:t2:2].float()).to(h.dtype)
    return (s.float() * 0.5).to(h.dtype)


def _check_tile(t: int, tt: int) -> None:
    """The probe's precondition (``pool_kernel_probe.py:95``)."""
    if tt <= 0 or (t // 2) % tt:
        raise ValueError(f"T // 2 = {t // 2} is not a multiple of the tile tt={tt}")


def _time_pool_cuda(h: torch.Tensor, tt: int) -> torch.Tensor:
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"h must be bfloat16 or float32, got {h.dtype}")
    if h.dim() != 4:
        raise ValueError(f"want h (B, T, F, C), got shape {tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous (the kernel reads rows of F * C elements)")
    batch, t, f, c = h.shape
    _check_tile(t, tt)
    out = torch.empty((batch, t // 2, f, c), device=h.device, dtype=h.dtype)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.dfac_time_pool(h.data_ptr(), out.data_ptr(), batch, t, f * c, tt,
                                 int(h.dtype == torch.bfloat16), stream)
    _build.check(err, "time_pool launch")
    _build.LAUNCHES["time_pool"] += 1
    return out


def time_pool(h: torch.Tensor, tt: int = 16) -> torch.Tensor:
    """h (B, T, F, C) bf16 or f32 -> (B, T // 2, F, C); ``(T // 2) % tt == 0``."""
    if h.is_cuda:
        return _time_pool_cuda(h, tt)
    if h.device.type != "cpu":
        raise ValueError(f"unsupported device {h.device}")
    _check_tile(h.shape[1], tt)
    return time_pool_plain(h)
