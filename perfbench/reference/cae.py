"""Plain convolutional autoencoder: the per-utterance reconstruction MSE.

The architecture of ``src/model_cae.py:20-125`` of the reference
repository at base width c, on the normalized model-view grid (B, T, F):
four blocks of Conv 3x3 SAME -> BatchNorm (eval, eps 1e-5) -> ReLU ->
floor-mode 2x2 average pool (channels 1 -> c -> 2c -> 4c -> 8c), then four
transposed convs with kernel 2 and stride 2 (8c -> 4c -> 2c -> c -> 1),
BatchNorm and ReLU after the first three. Each transposed conv's output
padding restores the size its encoder stage had before the pool, except
the last one along time: the output has T - 1 frames when T is odd and is
zero-padded back to T. The score is the mean of the squared difference to
the normalized input over (T, F).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import arithmetic, operand

BN_EPS = 1e-5
ENC = (("encoder.0", "encoder.1"), ("encoder.4", "encoder.5"), ("encoder.8", "encoder.9"),
       ("encoder.12", "encoder.13"))
DEC = (("decoder.0", "decoder.1"), ("decoder.3", "decoder.4"), ("decoder.6", "decoder.7"), ("decoder.9", None))


def leaves(m: dict) -> dict:
    """name -> (shape, init rule) for :func:`perfbench.lib.seeded.state_dict`:
    weights He-uniform (``±sqrt(6 / fan_in)``), so that the reconstruction
    carries the input through eight layers and its eval BatchNorms and is
    not swamped by the MSE's ``mean(x²)``; biases torch's default."""
    c = m["base_channels"]
    enc_ch = [1, c, 2 * c, 4 * c, 8 * c]
    dec_ch = [8 * c, 4 * c, 2 * c, c, 1]
    out = {}

    def norm(bn, n):
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{field}"] = ((n,), ("bn", field))
        out[f"{bn}.num_batches_tracked"] = ((), ("count",))

    for i, (conv, bn) in enumerate(ENC):
        out[f"{conv}.weight"] = ((enc_ch[i + 1], enc_ch[i], 3, 3), ("he", 9 * enc_ch[i]))
        out[f"{conv}.bias"] = ((enc_ch[i + 1],), ("fan_in", 9 * enc_ch[i]))
        norm(bn, enc_ch[i + 1])
    for i, (conv, bn) in enumerate(DEC):
        # torch's fan-in of a transposed conv's (in, out, 2, 2) weight: out * 4
        out[f"{conv}.weight"] = ((dec_ch[i], dec_ch[i + 1], 2, 2), ("he", 4 * dec_ch[i + 1]))
        out[f"{conv}.bias"] = ((dec_ch[i + 1],), ("fan_in", 4 * dec_ch[i + 1]))
        if bn is not None:
            norm(bn, dec_ch[i + 1])
    return out


def _bn_eval(h, sd, name):
    inv = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
    return (h - sd[f"{name}.running_mean"][:, None, None]) * inv[:, None, None] + sd[f"{name}.bias"][:, None, None]


def mse(sd: dict, feats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, p: str = "f32") -> torch.Tensor:
    """(B, F, T) stored-orientation features -> (B,) reconstruction MSE."""
    with arithmetic(p):
        x = (feats.float().transpose(1, 2) - mean) / std  # (B, T, F)
        h = x[:, None]
        sizes = []
        for conv, bn in ENC:
            h = F.conv2d(operand(h, p), operand(sd[f"{conv}.weight"], p), sd[f"{conv}.bias"], padding=1)
            h = torch.relu(_bn_eval(h, sd, bn))
            sizes.append(h.shape[2:])
            h = F.avg_pool2d(h, 2)
        for i, (conv, bn) in enumerate(DEC):
            t_pre, f_pre = sizes[3 - i]
            pad = (0 if i == 3 else t_pre % 2, f_pre % 2)
            h = F.conv_transpose2d(operand(h, p), operand(sd[f"{conv}.weight"], p), sd[f"{conv}.bias"],
                                   stride=2, output_padding=pad)
            if bn is not None:
                h = torch.relu(_bn_eval(h, sd, bn))
        recon = h[:, 0, : x.shape[1]]
        if recon.shape[1] < x.shape[1]:
            recon = F.pad(recon, (0, 0, 0, x.shape[1] - recon.shape[1]))
        return (recon - x).square().mean(dim=(1, 2))


def mse_of_rows(sd, feats_host: np.ndarray, mean, std, device, p: str = "f32", block: int = 128) -> np.ndarray:
    """:func:`mse` over host rows, ``block`` rows at a time."""
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=device)
    out = []
    with torch.inference_mode():
        for s in range(0, len(feats_host), block):
            x = torch.as_tensor(np.asarray(feats_host[s : s + block], np.float32), device=device)
            out.append(mse(sd, x, mean_t, std_t, p).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def fuse(sup: np.ndarray, cae: np.ndarray, alpha: float) -> np.ndarray:
    """``alpha * minmax(sup) + (1 - alpha) * minmax(cae)`` in float64
    (``src/hybrid_ensemble.py``; a constant input maps to zeros)."""
    def minmax(s):
        s = np.asarray(s, np.float64)
        lo, hi = s.min(), s.max()
        return np.zeros_like(s) if hi - lo < 1e-12 else (s - lo) / (hi - lo)

    return alpha * minmax(sup) + (1.0 - alpha) * minmax(cae)
