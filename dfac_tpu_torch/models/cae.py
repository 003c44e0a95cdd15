"""ConvAutoencoder — the bonafide-only anomaly scorer.

Counterpart of :mod:`dfac_tpu.models.cae`; parity target reference
``src/model_cae.py:20-125``. A fully convolutional autoencoder on
normalized (T=321, F=180) spectrograms:

* encoder: 4x [Conv 3x3 SAME -> BatchNorm -> ReLU -> floor-mode 2x2
  average pool], channels 1 -> 32 -> 64 -> 128 -> 256, a 20 x 11
  bottleneck (321 -> 160 -> 80 -> 40 -> 20, 180 -> 90 -> 45 -> 22 -> 11);
* decoder: 4x ``ConvTranspose2d(k=2, s=2)``, channels 256 -> 128 -> 64 ->
  32 -> 1, BatchNorm + ReLU after the first three, no final activation.

Each decoder stage's ``output_padding`` comes from the encoder's shape
trace (:func:`decoder_output_paddings`), so the modules keep torch's
default 0 and the forward passes the traced value to
``F.conv_transpose2d``; an ``output_padding`` row or column receives the
bias alone, as JAX's pad-then-bias gives it. T's output stage stays 0: the
decoder emits T=320 and the output is zero-padded back to 321.

Parameter names are the reference ``state_dict``'s (``encoder.{0,1,4,5,8,
9,12,13}``, ``decoder.{0,1,3,4,6,7,9}``). ``forward`` returns
``(reconstruction (B, T, F), latent (B, 256, 20, 11))``: the latent is
NCHW, where JAX's is NHWC ``(B, 20, 11, 256)`` — ``latent.permute(0, 2, 3,
1)`` is JAX's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dfac_tpu_torch.models.common import BatchNorm2d, conv_bn_relu

MIN_SIDE = 16  # four floor 2x2 pools keep a nonempty bottleneck


def decoder_output_paddings(t_sizes, f_sizes):
    """Per-stage ``output_padding`` from the encoder's pre-pool shape trace
    (pre - 2 * post per stage), in decoder order. F uses the trace on every
    stage; T's output stage stays 0 (the reference emits T=320 and
    zero-pads back to 321, ``src/model_cae.py:113-121``). The folded chain
    (:func:`~dfac_tpu_torch.models.fast_infer.cae_fast_mse`) replays this
    rule."""
    f_pads = [f_sizes[k] - 2 * (f_sizes[k] // 2) for k in (3, 2, 1, 0)]
    t_pads = [t_sizes[k] - 2 * (t_sizes[k] // 2) for k in (3, 2, 1)] + [0]
    return t_pads, f_pads


def check_geometry(t: int, f: int, who: str = "ConvAutoencoder") -> None:
    if t < MIN_SIDE or f < MIN_SIDE:
        raise ValueError(
            f"{who} needs T >= 16 and F >= 16 so the 4-stage "
            f"floor-pool chain keeps a nonempty bottleneck; got {(t, f)}. "
            "(The reference geometry is T=321, F=180.)"
        )


def fit_time(h: torch.Tensor, t_orig: int) -> torch.Tensor:
    """Zero-pad or trim the time axis (dim 2 of NCHW) back to ``t_orig``."""
    t_recon = h.shape[2]
    if t_recon < t_orig:
        return F.pad(h, (0, 0, 0, t_orig - t_recon))
    return h[:, :, :t_orig]


class ConvAutoencoder(nn.Module):
    takes_bn_frozen = True  # models.common.frozen_batchnorm: the JAX model's bn_frozen

    def __init__(self, base_channels: int = 32):
        super().__init__()
        bc = base_channels
        enc: list[nn.Module] = []
        for c_in, c_out in ((1, bc), (bc, bc * 2), (bc * 2, bc * 4), (bc * 4, bc * 8)):
            enc += [*conv_bn_relu(c_in, c_out), nn.AvgPool2d(2)]
        self.encoder = nn.Sequential(*enc)
        dec: list[nn.Module] = []
        for c_in, c_out in ((bc * 8, bc * 4), (bc * 4, bc * 2), (bc * 2, bc)):
            dec += [
                nn.ConvTranspose2d(c_in, c_out, 2, stride=2),
                BatchNorm2d(c_out),
                nn.ReLU(),
            ]
        dec.append(nn.ConvTranspose2d(bc, 1, 2, stride=2))  # no BN / activation on the last block
        self.decoder = nn.Sequential(*dec)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, T, F) normalized spectrogram -> (reconstruction (B, T, F),
        latent (B, 256, T', F') NCHW)."""
        t_orig = x.shape[1]
        check_geometry(x.shape[1], x.shape[2])
        h = x.unsqueeze(1)
        t_sizes, f_sizes = [], []
        for layer in self.encoder:
            if isinstance(layer, nn.AvgPool2d):
                t_sizes.append(h.shape[2])
                f_sizes.append(h.shape[3])
            h = layer(h)
        latent = h
        pads = iter(zip(*decoder_output_paddings(t_sizes, f_sizes)))
        for layer in self.decoder:
            if isinstance(layer, nn.ConvTranspose2d):
                h = F.conv_transpose2d(h, layer.weight, layer.bias, stride=2, output_padding=next(pads))
            else:
                h = layer(h)
        return fit_time(h, t_orig)[:, 0], latent

    @staticmethod
    def widths(sd: dict) -> dict:
        """The constructor's widths that ``sd`` (a state_dict) was made with."""
        return {"base_channels": sd["encoder.0.weight"].shape[0]}


def reconstruction_mse(reconstruction: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared reconstruction error over (T, F), the CAE's
    anomaly score (reference ``src/evaluation_cae.py:50-53``). On this
    corpus the raw (+MSE) convention is the bonafide score: fakes
    reconstruct better."""
    return torch.mean(torch.square(reconstruction - x), dim=(1, 2))
