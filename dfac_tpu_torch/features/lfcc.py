"""Raw-waveform -> LFCC + delta + delta-delta front-end (PyTorch).

Counterpart of :mod:`dfac_tpu.features.lfcc`. The feature contract is the
same: 16 kHz audio, 20 ms Hamming window (320 samples), 10 ms hop (160),
512-point rFFT power spectrum, 120 linear triangular filters, log energies
(floor 1e-10), orthonormal DCT-II keeping 60 coefficients, then delta and
delta-delta by +-2-frame regression with edge replication — 180 features
per frame, 321 frames for 51,520 samples.

The host constants are numpy and identical to the JAX package's. The
composition here (:func:`lfcc_features`) runs the rFFT and the power
spectrum in plain PyTorch on whatever device the waveform lies on, then
either the plain filterbank/log/DCT or the post-FFT kernel
(:mod:`dfac_tpu_torch.ops.lfcc_kernel`). The serving path uses the fused
GEMM front-end (:mod:`dfac_tpu_torch.ops.gemm_frontend`) instead.
:func:`lfcc_features_batch` is the corpus driver behind
``python -m dfac_tpu_torch.cli.extract_features``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LFCCConfig:
    sample_rate: int = 16_000
    win_length: int = 320  # 20 ms
    hop_length: int = 160  # 10 ms
    n_fft: int = 512
    n_filters: int = 120
    n_ceps: int = 60
    delta_window: int = 2
    log_floor: float = 1e-10

    @property
    def feature_dim(self) -> int:
        return 3 * self.n_ceps

    def num_frames(self, n_samples: int) -> int:
        return 1 + (n_samples - self.win_length) // self.hop_length

    def num_samples(self, n_frames: int) -> int:
        """Samples needed for n_frames (321 frames -> 51,520 = 3.22 s)."""
        return self.win_length + (n_frames - 1) * self.hop_length


def hamming_window(n: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))


def linear_filterbank(cfg: LFCCConfig) -> np.ndarray:
    """(n_fft//2 + 1, n_filters) triangular filters, linear center spacing.

    Centers at ``linspace(0, nyquist, n_filters + 2)`` in Hz mapped to FFT
    bin frequencies; each filter rises from its left neighbor's center and
    falls to its right neighbor's (the MFCC construction minus the mel warp).
    """
    n_bins = cfg.n_fft // 2 + 1
    freqs = np.linspace(0, cfg.sample_rate / 2, n_bins)
    centers = np.linspace(0, cfg.sample_rate / 2, cfg.n_filters + 2)
    fb = np.zeros((n_bins, cfg.n_filters), np.float64)
    for m in range(cfg.n_filters):
        left, center, right = centers[m], centers[m + 1], centers[m + 2]
        up = (freqs - left) / max(center - left, 1e-12)
        down = (right - freqs) / max(right - center, 1e-12)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def filter_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(fb_lo, fb_hi) int32: each filter's first and last nonzero bin. The
    CUDA kernels sum only that band, which equals the dense product (the
    skipped terms are exact zeros)."""
    nz = fb != 0
    fb_lo = np.argmax(nz, axis=0).astype(np.int32)
    fb_hi = (fb.shape[0] - 1 - np.argmax(nz[::-1], axis=0)).astype(np.int32)
    return fb_lo, fb_hi


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) orthonormal DCT-II basis (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)
    return mat


def delta_kernel(window: int) -> np.ndarray:
    """Regression coefficients [-N..N] / (2 * sum n^2)."""
    n = np.arange(-window, window + 1, dtype=np.float64)
    return n / (2.0 * np.sum(np.arange(1, window + 1) ** 2.0))


def frames(waveform: torch.Tensor, cfg: LFCCConfig) -> torch.Tensor:
    """(..., N) -> (..., T, win) strided framing (a view, no copy)."""
    t = cfg.num_frames(waveform.shape[-1])
    usable = cfg.win_length + (t - 1) * cfg.hop_length
    return waveform[..., :usable].unfold(-1, cfg.win_length, cfg.hop_length)


def compute_deltas(ceps: torch.Tensor, window: int = 2) -> torch.Tensor:
    """(..., T, C) -> regression deltas with edge replication over T.

    Same sum, term by term in the same order, as the JAX version:
    ``out_t = sum_n kern[n + w] * ceps[clip(t + n)]``.
    """
    kern = delta_kernel(window)
    n_t = ceps.shape[-2]
    base = torch.arange(n_t, device=ceps.device)
    out = torch.zeros_like(ceps)
    for i in range(2 * window + 1):
        idx = (base + (i - window)).clamp_(0, n_t - 1)
        out = out + float(kern[i]) * ceps.index_select(-2, idx)
    return out


@functools.lru_cache(maxsize=16)
def device_constants(cfg: LFCCConfig, device: torch.device, dtype: torch.dtype):
    """(window, filterbank, DCT) as tensors on ``device``, made once per
    (config, device, dtype): rebuilding them per batch would put host work
    and a blocking upload between the batches. Callers only read them."""
    return tuple(
        torch.as_tensor(a, dtype=dtype, device=device)
        for a in (hamming_window(cfg.win_length), linear_filterbank(cfg), dct_matrix(cfg.n_filters, cfg.n_ceps))
    )


def check_kernel_cfg(cfg: LFCCConfig, fields: tuple[str, ...], kernel: str) -> None:
    """Raise unless ``cfg`` has the default value of every field in
    ``fields``: the CUDA kernels' tiles are compiled for the corpus geometry."""
    bad = [f for f in fields if getattr(cfg, f) != getattr(LFCCConfig(), f)]
    if bad:
        raise ValueError(f"the CUDA {kernel} is compiled for the default LFCCConfig; got other {bad}")


@functools.lru_cache(maxsize=16)
def banded_constants(cfg: LFCCConfig, device: torch.device):
    """(fb, fb_lo, fb_hi, dct) on ``device`` for the CUDA kernels' banded
    filterbank -> log -> DCT: the f32 matrices of :func:`device_constants`
    and each filter's band (:func:`filter_bands`, int32)."""
    _, fb, dct = device_constants(cfg, device, torch.float32)
    bands = filter_bands(linear_filterbank(cfg).astype(np.float32))
    return (fb, *(torch.as_tensor(a, device=device) for a in bands), dct)


def log_filterbank_energies(power: torch.Tensor, cfg: LFCCConfig) -> torch.Tensor:
    _, fb, _ = device_constants(cfg, power.device, power.dtype)
    return torch.log(torch.clamp(power @ fb, min=cfg.log_floor))


def power_spectrum(waveform: torch.Tensor, cfg: LFCCConfig) -> torch.Tensor:
    """(..., N) waveform -> (..., T, n_fft//2+1) power of the windowed rFFT."""
    window, _, _ = device_constants(cfg, waveform.device, waveform.dtype)
    spec = torch.fft.rfft(frames(waveform, cfg) * window, n=cfg.n_fft, dim=-1)
    return spec.real.square() + spec.imag.square()


def lfcc_features(
    waveform: torch.Tensor, cfg: LFCCConfig = LFCCConfig(), use_kernel: bool = False
) -> torch.Tensor:
    """(..., N) float waveform -> (..., 180, T) stored-orientation features
    through the rFFT composition (blocks [lfcc; delta; delta-delta]).

    ``use_kernel`` is the JAX package's ``use_pallas``: the filterbank, log
    and DCT go through :func:`~dfac_tpu_torch.ops.lfcc_kernel.fused_fb_log_dct`
    (the CUDA kernel on a CUDA tensor). The rFFT and the power stay plain
    PyTorch either way, as the JAX package leaves them to XLA."""
    power = power_spectrum(waveform, cfg)  # (..., T, bins)
    if use_kernel:
        from dfac_tpu_torch.ops.lfcc_kernel import fused_fb_log_dct

        ceps = fused_fb_log_dct(power, cfg)  # (..., T, n_ceps)
    else:
        _, _, dct = device_constants(cfg, waveform.device, waveform.dtype)
        ceps = log_filterbank_energies(power, cfg) @ dct
    d1 = compute_deltas(ceps, cfg.delta_window)
    d2 = compute_deltas(d1, cfg.delta_window)
    return torch.cat([ceps, d1, d2], dim=-1).transpose(-1, -2)


METHODS = ("gemm", "fft-pallas", "fft")


def batch_features(waveform: torch.Tensor, cfg: LFCCConfig, method: str = "gemm") -> torch.Tensor:
    """One device batch (B, N) -> (B, 180, T) by ``method``: 'gemm' (the
    fused GEMM front-end, K1, f32 DFT), 'fft-pallas' (rFFT + the post-FFT
    kernel, K4; named as the JAX CLI names it) or 'fft' (plain PyTorch)."""
    if method == "gemm":
        from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_features

        return gemm_lfcc_features(waveform, cfg)
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    return lfcc_features(waveform, cfg, use_kernel=(method == "fft-pallas"))


def lfcc_features_batch(
    waveforms: np.ndarray,
    cfg: LFCCConfig = LFCCConfig(),
    batch_size: int = 64,
    method: str = "gemm",
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Host driver: (N, samples) numpy -> (N, 180, T) f32 numpy, in batches
    of ``batch_size`` on ``device`` (``None`` means CUDA, see
    :func:`~dfac_tpu_torch.device.resolve_device`).

    Unlike the JAX driver, nothing falls back: a kernel that fails to build
    or launch raises, and the corpus is never re-run on 'fft'."""
    from dfac_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if len(waveforms) == 0:
        return np.zeros((0, cfg.feature_dim, 0), np.float32)
    out = np.empty((len(waveforms), cfg.feature_dim, cfg.num_frames(waveforms.shape[-1])), np.float32)
    for s in range(0, len(waveforms), batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(waveforms[s : s + batch_size], np.float32))
        # each batch lands in its rows of ``out``: no per-batch arrays to join
        torch.from_numpy(out[s : s + batch_size]).copy_(batch_features(chunk.to(dev), cfg, method))
    return out
