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

The TPU's 128-lane padding is gone: K = 320 is the real size, and the
kernel computes bins 0..255 only, since bin 256 feeds no filter
(:func:`kernel_constants` checks that and the other facts of the
filterbank the kernel's epilogue relies on).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dfac_tpu_torch.features import lfcc as lfcc_mod
from dfac_tpu_torch.ops import _build

KERNEL_BINS = 256  # bins the kernel computes: the filterbank reads none past 255
MAX_BAND = 5  # bins per filter the kernel's epilogue sums, at most
# bf16 mode: chunks of 64 bins, each N = 128 columns interleaved by 8 (cos
# of 8 bins, then their sin), streamed as K slabs of 32 (rows of 64 bytes)
BF16_CHUNK_BINS, BF16_INTERLEAVE, BF16_K_SLAB = 64, 8, 32
BF16_MAX_FILTERS = 32  # filters whose last bin lies in one chunk, at most
# f32 mode: chunks of 128 bins, [cos of the chunk's bins | their sin] per K row
F32_CHUNK_BINS = 128
F32_MAX_FILTERS = 64  # filters whose last bin lies in one chunk, at most


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


def _bf16_stages(cos_b: np.ndarray, sin_b: np.ndarray) -> np.ndarray:
    """(chunks, slabs, 128, 32): the ring's stage images in logical order,
    K-major. Column n of chunk c is bin 64c + 8(n // 16) + n % 8, cos for
    n % 16 < 8, else sin; stage (c, s) holds K rows 32s..32s+31 of those
    columns."""
    win = cos_b.shape[0]
    n = np.arange(2 * BF16_CHUNK_BINS)
    cols = []
    for c in range(KERNEL_BINS // BF16_CHUNK_BINS):
        bins = c * BF16_CHUNK_BINS + (n // (2 * BF16_INTERLEAVE)) * BF16_INTERLEAVE + n % BF16_INTERLEAVE
        cols.append(np.where(n % (2 * BF16_INTERLEAVE) < BF16_INTERLEAVE, cos_b[:, bins], sin_b[:, bins]))
    basis = np.stack(cols)  # (chunks, win, 128)
    return basis.reshape(len(cols), win // BF16_K_SLAB, BF16_K_SLAB, -1).transpose(0, 1, 3, 2)


def swizzle64(stages: np.ndarray) -> np.ndarray:
    """The 64-byte swizzle of rows of 32 bf16 (64 bytes), as shared memory
    holds them for a wgmma descriptor: 16-byte chunk q of row n lies at
    chunk q ^ ((n // 2) % 4). Applied on the host, so that one bulk copy
    per stage lands in that layout."""
    n = np.arange(stages.shape[-2])[:, None]
    q = np.arange(4)[None, :]
    chunks = stages.reshape(*stages.shape[:-1], 4, 8)
    out = np.empty_like(chunks)
    out[..., n, q ^ ((n >> 1) & 3), :] = chunks
    return out.reshape(stages.shape)


def _f32_basis(cos_b: np.ndarray, sin_b: np.ndarray) -> np.ndarray:
    """(win, 512): column 256c + i is the cos of bin 128c + i, column 256c +
    128 + i its sin (c = 0, 1; i < 128)."""
    chunks = [np.concatenate([cos_b[:, lo: lo + F32_CHUNK_BINS], sin_b[:, lo: lo + F32_CHUNK_BINS]], axis=1)
              for lo in range(0, KERNEL_BINS, F32_CHUNK_BINS)]
    return np.ascontiguousarray(np.concatenate(chunks, axis=1))


@functools.lru_cache(maxsize=8)
def kernel_constants(cfg: lfcc_mod.LFCCConfig):
    """The kernel's layouts of the same constants (host numpy):
    ``(basis_bf16, basis_f32, fb_lo, fb_hi)``.

    * basis_bf16: :func:`_bf16_stages` through :func:`swizzle64`, bins 0..255;
    * basis_f32: :func:`_f32_basis`, bins 0..255;
    * fb_lo / fb_hi (n_filters,) int32: each triangular filter's first and
      last nonzero bin (:func:`~dfac_tpu_torch.features.lfcc.filter_bands`).

    Raises if the filterbank breaks what the kernel's epilogue assumes: no
    filter reads a bin past 255, a band spans at most 5 bins, the bands'
    last bins do not decrease, and at most 32 filters end in one 64-bin
    chunk (bf16 mode), 64 in one 128-bin chunk (f32 mode)."""
    cos_b, sin_b, fb, _ = host_constants(cfg)
    fb_lo, fb_hi = lfcc_mod.filter_bands(fb)
    if (fb[KERNEL_BINS:].any() or (fb_hi - fb_lo + 1).max() > MAX_BAND or (np.diff(fb_hi) < 0).any()
            or np.bincount(fb_hi // BF16_CHUNK_BINS).max() > BF16_MAX_FILTERS
            or np.bincount(fb_hi // F32_CHUNK_BINS).max() > F32_MAX_FILTERS):
        raise ValueError("the filterbank does not fit the front-end kernel's epilogue")
    return swizzle64(_bf16_stages(cos_b, sin_b)), _f32_basis(cos_b, sin_b), fb_lo, fb_hi


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


@functools.lru_cache(maxsize=8)
def _device_basis(cfg: lfcc_mod.LFCCConfig, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    basis_bf16, basis_f32, _, _ = kernel_constants(cfg)
    basis = basis_bf16 if dtype == torch.bfloat16 else basis_f32
    return torch.as_tensor(basis, device=device).to(dtype).contiguous()


def _cepstra_cuda(waveform, cfg, compute_dtype):
    lfcc_mod.check_kernel_cfg(cfg, ("win_length", "hop_length", "n_fft", "n_filters", "n_ceps"), "front-end")
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
    basis = _device_basis(cfg, wave.device, compute_dtype)
    fb, fb_lo, fb_hi, dct = lfcc_mod.banded_constants(cfg, wave.device)
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
