"""Raw-waveform -> LFCC + delta + delta-delta front-end (PyTorch).

Counterpart of :mod:`dfac_tpu.features.lfcc`. The feature contract is the
same: 16 kHz audio, 20 ms Hamming window (320 samples), 10 ms hop (160),
512-point rFFT power spectrum, 120 linear triangular filters, log energies
(floor 1e-10), orthonormal DCT-II keeping 60 coefficients, then delta and
delta-delta by +-2-frame regression with edge replication — 180 features
per frame, 321 frames for 51,520 samples.

The host constants are numpy and identical to the JAX package's. The
composition here (:func:`lfcc_features`) is plain PyTorch on whatever device
the waveform lies on; the serving path uses the fused GEMM front-end
(:mod:`dfac_tpu_torch.ops.gemm_frontend`) instead.
"""

from __future__ import annotations

import dataclasses

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


def log_filterbank_energies(power: torch.Tensor, cfg: LFCCConfig) -> torch.Tensor:
    fb = torch.as_tensor(linear_filterbank(cfg), dtype=power.dtype, device=power.device)
    return torch.log(torch.clamp(power @ fb, min=cfg.log_floor))


def lfcc_features(waveform: torch.Tensor, cfg: LFCCConfig = LFCCConfig()) -> torch.Tensor:
    """(..., N) float waveform -> (..., 180, T) stored-orientation features
    through the rFFT composition (blocks [lfcc; delta; delta-delta])."""
    window = torch.as_tensor(
        hamming_window(cfg.win_length), dtype=waveform.dtype, device=waveform.device
    )
    spec = torch.fft.rfft(frames(waveform, cfg) * window, n=cfg.n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()  # (..., T, bins)
    dct = torch.as_tensor(
        dct_matrix(cfg.n_filters, cfg.n_ceps), dtype=waveform.dtype, device=waveform.device
    )
    ceps = log_filterbank_energies(power, cfg) @ dct  # (..., T, n_ceps)
    d1 = compute_deltas(ceps, cfg.delta_window)
    d2 = compute_deltas(d1, cfg.delta_window)
    return torch.cat([ceps, d1, d2], dim=-1).transpose(-1, -2)
