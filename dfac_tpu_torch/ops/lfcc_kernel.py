"""Post-FFT LFCC kernel (K4) and its plain PyTorch version.

Counterpart of :mod:`dfac_tpu.ops.pallas.lfcc_kernel`: the half of the
LFCC front-end after the rFFT,

    ceps = log(max(power @ FB, floor)) @ DCT     # (..., T, 257) -> (..., T, 60)

On a CUDA tensor, :func:`fused_fb_log_dct` launches the hand-written kernel
in ``csrc/lfcc_kernel.cu`` (persistent blocks fed by a ring of bulk copies
of 32-row tiles; banded filterbank, log and a register-tiled DCT in f32;
the log energies never leave the chip). On a CPU tensor it runs
:func:`fb_log_dct_plain`. It never falls back from one to the other.

The TPU's 128-lane padding (257 -> 384 bins, 120 -> 128 filters, 60 -> 128
outputs) and the mask of padded filters are gone: the kernel works at the
real sizes.
"""

from __future__ import annotations

import torch

from dfac_tpu_torch.features import lfcc as lfcc_mod
from dfac_tpu_torch.ops import _build


def fb_log_dct_plain(power: torch.Tensor, cfg: lfcc_mod.LFCCConfig) -> torch.Tensor:
    """The kernel's plain PyTorch version: (..., T, bins) -> (..., T, n_ceps),
    dense f32 products."""
    _, _, dct = lfcc_mod.device_constants(cfg, power.device, torch.float32)
    return lfcc_mod.log_filterbank_energies(power.float(), cfg) @ dct


def _fb_log_dct_cuda(power: torch.Tensor, cfg: lfcc_mod.LFCCConfig) -> torch.Tensor:
    lfcc_mod.check_kernel_cfg(cfg, ("n_fft", "n_filters", "n_ceps"), "post-FFT kernel")
    n_bins = cfg.n_fft // 2 + 1
    if power.dtype != torch.float32:
        raise TypeError(f"power must be float32, got {power.dtype}")
    if power.ndim < 1 or power.shape[-1] != n_bins:
        raise ValueError(f"power must end in {n_bins} bins, got shape {tuple(power.shape)}")
    if not power.is_contiguous():
        raise ValueError("power must be contiguous (the kernel copies 32-row tiles flat)")
    lead = power.shape[:-1]
    rows = power.numel() // n_bins
    out = torch.empty((*lead, cfg.n_ceps), device=power.device, dtype=torch.float32)
    if rows == 0:
        return out
    fb, fb_lo, fb_hi, dct = lfcc_mod.banded_constants(cfg, power.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(power.device).cuda_stream
    with torch.cuda.device(power.device):
        err = lib.dfac_fb_log_dct(
            power.data_ptr(), fb.data_ptr(), fb_lo.data_ptr(), fb_hi.data_ptr(), dct.data_ptr(),
            out.data_ptr(), rows, cfg.log_floor, stream,
        )
    _build.check(err, "fb_log_dct launch")
    _build.LAUNCHES["fb_log_dct"] += 1
    return out


def fused_fb_log_dct(power: torch.Tensor, cfg: lfcc_mod.LFCCConfig) -> torch.Tensor:
    """(..., T, n_fft//2+1) f32 power spectrum -> (..., T, n_ceps) f32 cepstra."""
    if power.is_cuda:
        return _fb_log_dct_cuda(power, cfg)
    if power.device.type != "cpu":
        raise ValueError(f"unsupported device {power.device}")
    return fb_log_dct_plain(power, cfg)
