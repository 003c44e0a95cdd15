"""GEMM-native LFCC front-end: kernel 1 and its plain PyTorch version.

Counterpart of :mod:`dfac_tpu.ops.pallas.gemm_frontend`. With the Hamming
window folded into the DFT basis, the front-end is

    re   = frames @ (diag(w) @ C)        # cos basis, (320, 257)
    im   = frames @ (diag(w) @ S)        # sin basis
    P    = re^2 + im^2                   # power spectrum
    ceps = log(max(P @ FB, floor)) @ DCT # filterbank + cepstrum, first 60

and a frame is two consecutive 160-sample blocks (hop = win/2).

On a CUDA tensor, :func:`gemm_lfcc_cepstra` launches the hand-written
kernel in ``csrc/gemm_frontend.cu`` (frames read straight from the
waveform, DFT on the tensor cores in bf16 or on the CUDA cores in f32,
filterbank/log/DCT in f32, all on chip). On a CPU tensor it runs
:func:`cepstra_plain`. It never falls back from one to the other.

Only the TPU's 128-lane padding is gone: K = 320 and 257 bins are the real
sizes; the kernel's basis pads to 16-bin groups for the tensor-core tile.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dfac_tpu_torch.features import lfcc as lfcc_mod
from dfac_tpu_torch.ops import _build

BIN_GROUP = 16  # bins per tensor-core column group (cos and sin side by side)


@functools.lru_cache(maxsize=8)
def host_constants(cfg: lfcc_mod.LFCCConfig):
    """Windowed DFT bases, filterbank and DCT as host numpy (f32).

    Returns ``(cos_b, sin_b, fb, dct)`` with shapes (win, bins), (win, bins),
    (bins, n_filters) and (n_filters, n_ceps). The sin basis carries the
    rFFT's minus sign (it does not matter for the power)."""
    n_bins = cfg.n_fft // 2 + 1
    win = lfcc_mod.hamming_window(cfg.win_length)
    n = np.arange(cfg.win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    cos_b = (win[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (-win[:, None] * np.sin(ang)).astype(np.float32)
    fb = lfcc_mod.linear_filterbank(cfg).astype(np.float32)
    dct = lfcc_mod.dct_matrix(cfg.n_filters, cfg.n_ceps).astype(np.float32)
    return cos_b, sin_b, fb, dct


@functools.lru_cache(maxsize=8)
def kernel_constants(cfg: lfcc_mod.LFCCConfig):
    """The kernel's layouts of the same constants (host numpy).

    * basis (win, groups * 32): group g holds the cos columns of bins
      16g..16g+15, then their sin columns; the bins past the last (256)
      are zero columns.
    * fb_lo / fb_hi (n_filters,) int32: each triangular filter's first and
      last nonzero bin. The kernel sums only that band, which equals the
      dense product (the skipped terms are exact zeros).
    """
    cos_b, sin_b, fb, _ = host_constants(cfg)
    n_bins = cos_b.shape[1]
    groups = -(-n_bins // BIN_GROUP)
    basis = np.zeros((cfg.win_length, groups, 2, BIN_GROUP), np.float32)
    for g in range(groups):
        lo, hi = g * BIN_GROUP, min((g + 1) * BIN_GROUP, n_bins)
        basis[:, g, 0, : hi - lo] = cos_b[:, lo:hi]
        basis[:, g, 1, : hi - lo] = sin_b[:, lo:hi]
    nz = fb != 0
    fb_lo = np.argmax(nz, axis=0).astype(np.int32)
    fb_hi = (n_bins - 1 - np.argmax(nz[::-1], axis=0)).astype(np.int32)
    return basis.reshape(cfg.win_length, -1), fb_lo, fb_hi


def frames_by_reshape(waveform: torch.Tensor, cfg: lfcc_mod.LFCCConfig) -> torch.Tensor:
    """(..., N) -> (..., T, win) framing as reshape+slice (hop = win/2)."""
    if cfg.hop_length * 2 != cfg.win_length:
        return lfcc_mod.frames(waveform, cfg)
    t = cfg.num_frames(waveform.shape[-1])
    usable = (t + 1) * cfg.hop_length
    blocks = waveform[..., :usable].reshape(*waveform.shape[:-1], t + 1, cfg.hop_length)
    return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], dim=-1)


def cepstra_plain(
    waveform: torch.Tensor, cfg: lfcc_mod.LFCCConfig, compute_dtype=torch.float32
) -> torch.Tensor:
    """The kernel's plain PyTorch version: same math, f32 products.

    With ``compute_dtype=bfloat16`` the frames and the windowed basis are
    rounded to bf16 first and the product still runs in f32, which is what
    the kernel's bf16 tensor-core product with f32 accumulation computes
    (a bf16 ``torch.matmul`` would round its output to bf16 as well)."""
    cos_b, sin_b, fb, dct = host_constants(cfg)
    dev = waveform.device

    def const(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype).float()

    fr = frames_by_reshape(waveform.float(), cfg).to(compute_dtype).float()
    re = fr @ const(cos_b, compute_dtype)
    im = fr @ const(sin_b, compute_dtype)
    power = re.square() + im.square()
    log_e = torch.log(torch.clamp(power @ const(fb), min=cfg.log_floor))
    return log_e @ const(dct)


_KERNEL_CFG = lfcc_mod.LFCCConfig()


def _check_kernel_cfg(cfg: lfcc_mod.LFCCConfig) -> None:
    # the kernel's tiles are compiled for the corpus geometry
    fixed = ("win_length", "hop_length", "n_fft", "n_filters", "n_ceps")
    bad = [f for f in fixed if getattr(cfg, f) != getattr(_KERNEL_CFG, f)]
    if bad:
        raise ValueError(f"the CUDA front-end is compiled for the default LFCCConfig; got other {bad}")


@functools.lru_cache(maxsize=8)
def _device_constants(cfg: lfcc_mod.LFCCConfig, device: torch.device, dtype: torch.dtype):
    basis, fb_lo, fb_hi = kernel_constants(cfg)
    _, _, fb, dct = host_constants(cfg)
    return (
        torch.as_tensor(basis, device=device).to(dtype).contiguous(),
        torch.as_tensor(fb, device=device).contiguous(),
        torch.as_tensor(fb_lo, device=device),
        torch.as_tensor(fb_hi, device=device),
        torch.as_tensor(dct, device=device).contiguous(),
    )


def _cepstra_cuda(waveform, cfg, compute_dtype):
    _check_kernel_cfg(cfg)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if waveform.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {waveform.dtype}")
    lead, n = waveform.shape[:-1], waveform.shape[-1]
    t = cfg.num_frames(n)
    if t < 1:
        raise ValueError(f"{n} samples make no {cfg.win_length}-sample frame")
    wave = waveform.reshape(-1, n).contiguous()
    n_utt = wave.shape[0]
    out = torch.empty((n_utt, t, cfg.n_ceps), device=wave.device, dtype=torch.float32)
    if n_utt == 0:
        return out.reshape(*lead, t, cfg.n_ceps)
    basis, fb, fb_lo, fb_hi, dct = _device_constants(cfg, wave.device, compute_dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    with torch.cuda.device(wave.device):
        err = lib.dfac_gemm_frontend(
            wave.data_ptr(), basis.data_ptr(), fb.data_ptr(), fb_lo.data_ptr(),
            fb_hi.data_ptr(), dct.data_ptr(), out.data_ptr(),
            n_utt, n, t, cfg.log_floor, int(compute_dtype == torch.bfloat16), stream,
        )
    _build.check(err, "gemm_frontend launch")
    _build.LAUNCHES["gemm_frontend"] += 1
    return out.reshape(*lead, t, cfg.n_ceps)


def gemm_lfcc_cepstra(
    waveform: torch.Tensor, cfg: lfcc_mod.LFCCConfig, compute_dtype=torch.float32
) -> torch.Tensor:
    """(..., N) f32 waveform -> (..., T, n_ceps) f32 static cepstra.

    ``compute_dtype=bfloat16`` feeds the DFT product bf16 frames and basis
    with f32 accumulation; filterbank, log and DCT stay f32 either way."""
    if waveform.is_cuda:
        return _cepstra_cuda(waveform, cfg, compute_dtype)
    if waveform.device.type != "cpu":
        raise ValueError(f"unsupported device {waveform.device}")
    return cepstra_plain(waveform, cfg, compute_dtype)


def append_deltas(ceps: torch.Tensor, cfg: lfcc_mod.LFCCConfig) -> torch.Tensor:
    """(..., T, 60) cepstra -> (..., T, 180) [ceps; delta; delta-delta].
    Plain PyTorch on the cepstra's device, as the JAX package leaves the
    deltas to XLA outside its kernel."""
    d1 = lfcc_mod.compute_deltas(ceps, cfg.delta_window)
    d2 = lfcc_mod.compute_deltas(d1, cfg.delta_window)
    return torch.cat([ceps, d1, d2], dim=-1)


def gemm_lfcc_features_tf(
    waveform: torch.Tensor,
    cfg: lfcc_mod.LFCCConfig = lfcc_mod.LFCCConfig(),
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """(..., N) waveform -> (..., T, 180) features, frames as rows — the
    layout the CNN2D chain takes without a transpose."""
    return append_deltas(gemm_lfcc_cepstra(waveform, cfg, compute_dtype=compute_dtype), cfg)


def gemm_lfcc_features(
    waveform: torch.Tensor,
    cfg: lfcc_mod.LFCCConfig = lfcc_mod.LFCCConfig(),
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """(..., N) waveform -> (..., 180, T) stored-orientation features."""
    return gemm_lfcc_features_tf(waveform, cfg, compute_dtype).transpose(-1, -2)
