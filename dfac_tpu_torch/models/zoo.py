"""The archived model zoo: the reference's 8 historical variants.

Counterpart of :mod:`dfac_tpu.models.zoo`; parity target reference
``src/archive/models.py`` (MeanPoolMLP :5-25, StatsPoolMLP :28-52,
CNN1DSpatial :55-86, archived CNN1D :89-121, CNN2DSpatial :124-155,
CRNN/CRNN2 :158-234, CNN2D_Robust :237-298). Each trains through the
:class:`~dfac_tpu_torch.train.loop.Trainer` and scores with its eval model.

* **Parameter names** are the reference ``state_dict``'s, as the JAX
  package's ``torch_import`` maps them: ``feature_extractor.{0,3,6}``,
  ``conv.N``, ``rnn.{weight,bias}_{ih,hh}_l{k}``, ``block{b}.{0,1,3,4}``,
  ``se.{1,3}``, ``attention_pool``, ``classifier`` / ``classifier.{1,4}``.
* **Dropout**: element dropout is the byte :class:`~.common.FastDropout`,
  channel dropout (``Dropout1d``/``Dropout2d``) :class:`~.common.ChannelDropout`.
* **Widths**: ``in_features`` / ``in_channels`` are the model-view
  input's last axis (F with ``swap_tf``); the JAX modules read it from the
  data, so the port's callers pass the data's. The JAX defaults (321) are
  kept for a caller that passes none.
* Flattens are channel-major (torch's NCHW flatten), so imported
  classifier weights line up.
* The GRU runs one layer at a time through torch's GRU (cuDNN's on CUDA),
  so that the CRNN2 drops between its layers with ``FastDropout`` as the
  JAX model does (``zoo.py:185-188``); ``nn.GRU``'s own between-layer
  dropout is a Bernoulli draw of another rule. flax's ``GRUCell`` has no
  recurrent bias on r and z: weights from JAX come with ``bias_hh``'s r
  and z parts zero (:mod:`dfac_tpu_torch.utils.convert`).
"""

from __future__ import annotations

import math
import warnings

import torch
from torch import _VF, nn

from dfac_tpu_torch.models.common import (
    ChannelDropout,
    FastDropout,
    Linear,
    conv1d_bn_relu,
    conv_bn_relu,
    time_pool,
)

# one layer of a stack is not a view of one flat weight buffer: cuDNN packs
# it for each call and warns once a call site
warnings.filterwarnings("ignore", message="RNN module weights are not part of single contiguous chunk",
                        category=UserWarning, module=__name__)


def adaptive_avg_pool_1d(h: torch.Tensor, bins: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool1d`` over the last (time) axis of (B, C, T)
    with JAX's start/end rule (``zoo.py:27-38``): bin i averages ``[floor(i
    T / bins), ceil((i + 1) T / bins))`` -> (B, C, bins)."""
    t = h.shape[-1]
    if bins == 1:
        return h.mean(dim=-1, keepdim=True)
    return torch.stack([h[..., (i * t) // bins : -(-((i + 1) * t) // bins)].mean(dim=-1) for i in range(bins)], -1)


def _mlp(d_in: int, hidden: int, dropout: float) -> nn.Sequential:
    return nn.Sequential(
        Linear(d_in, hidden), nn.ReLU(), FastDropout(dropout),
        Linear(hidden, hidden), nn.ReLU(), FastDropout(dropout),
        Linear(hidden, 1),
    )


class MeanPoolMLP(nn.Module):
    """The mean over time, then a 2-hidden-layer MLP."""

    def __init__(self, in_features: int = 321, hidden_dim: int = 128, dropout: float = 0.2):
        super().__init__()
        self.feature_extractor = _mlp(in_features, hidden_dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, F) -> logits (B, 1)."""
        return self.feature_extractor(x.mean(dim=1))

    @staticmethod
    def widths(sd: dict) -> dict:
        w = sd["feature_extractor.0.weight"]
        return {"in_features": w.shape[1], "hidden_dim": w.shape[0]}


class StatsPoolMLP(nn.Module):
    """The mean, the biased std and the max over time, then the MLP."""

    def __init__(self, in_features: int = 321, hidden_dim: int = 128, dropout: float = 0.2):
        super().__init__()
        self.feature_extractor = _mlp(3 * in_features, hidden_dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.mean(dim=1), x.std(dim=1, correction=0), x.amax(dim=1)], dim=-1)
        return self.feature_extractor(pooled)

    @staticmethod
    def widths(sd: dict) -> dict:
        w = sd["feature_extractor.0.weight"]
        return {"in_features": w.shape[1] // 3, "hidden_dim": w.shape[0]}


class _CNN1DBase(nn.Module):
    """The archived CNN1D body: 128 -> 128 -> 256 channels over time,
    dropout after the first two blocks, an adaptive pool to ``pool_bins``,
    one logit."""

    spatial_dropout = False

    def __init__(self, in_channels: int = 321, dropout: float = 0.2, pool_bins: int = 1):
        super().__init__()
        drop = ChannelDropout if self.spatial_dropout else FastDropout
        self.pool_bins = pool_bins
        self.conv = nn.Sequential(
            *conv1d_bn_relu(in_channels, 128), drop(dropout),
            *conv1d_bn_relu(128, 128), drop(dropout),
            *conv1d_bn_relu(128, 256),
        )
        self.classifier = Linear(256 * pool_bins, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = adaptive_avg_pool_1d(self.conv(x.transpose(1, 2)), self.pool_bins)  # (B, 256, bins)
        return self.classifier(h.flatten(1))  # channel-major: c * bins + b

    @staticmethod
    def widths(sd: dict) -> dict:
        return {"in_channels": sd["conv.0.weight"].shape[1], "pool_bins": sd["classifier.weight"].shape[1] // 256}


class CNN1DSpatial(_CNN1DBase):
    spatial_dropout = True


class CNN1DArchive(_CNN1DBase):
    spatial_dropout = False


class CNN2DSpatial(nn.Module):
    """The CNN2D body with channel (``Dropout2d``) dropout between blocks."""

    def __init__(self, in_features: int = 321, base_channels: int = 32, dropout: float = 0.2):
        super().__init__()
        bc = base_channels
        self.conv = nn.Sequential(
            *conv_bn_relu(1, bc), time_pool(), ChannelDropout(dropout),
            *conv_bn_relu(bc, bc * 2), time_pool(), ChannelDropout(dropout),
            *conv_bn_relu(bc * 2, bc * 4),
        )
        self.classifier = Linear(bc * 4 * in_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.unsqueeze(1))  # (B, C, T', F)
        return self.classifier(h.mean(dim=2).flatten(1))  # channel-major: c * F + f

    @staticmethod
    def widths(sd: dict) -> dict:
        bc = sd["conv.0.weight"].shape[0]
        return {"base_channels": bc, "in_features": sd["classifier.weight"].shape[1] // (4 * bc)}


class GRU(nn.Module):
    """A unidirectional, batch-first GRU stack with ``nn.GRU``'s parameter
    names and init, run one layer at a time (so that a dropout of the
    caller's can sit between layers)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        for k in range(num_layers):
            d_in = input_size if k == 0 else hidden_size
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty(3 * hidden_size, d_in)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.empty(3 * hidden_size, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(3 * hidden_size)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(3 * hidden_size)))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def layer(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """Layer ``k`` over (B, T, D) from a zero state -> (B, T, H); gates
        (r, z, n) as torch's (and flax's ``GRUCell``)."""
        weights = [getattr(self, f"{n}_l{k}") for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        h0 = torch.zeros(1, x.shape[0], self.hidden_size, dtype=x.dtype, device=x.device)
        return _VF.gru(x, h0, weights, True, 1, 0.0, self.training, False, True)[0]


class CRNN(nn.Module):
    """A CNN front end (two pooled blocks) and a GRU back end, read out at
    the last step."""

    def __init__(self, in_features: int = 321, base_channels: int = 32, rnn_hidden: int = 128,
                 num_layers: int = 1, dropout: float = 0.3):
        super().__init__()
        bc = base_channels
        self.conv = nn.Sequential(
            *conv_bn_relu(1, bc), time_pool(), FastDropout(dropout),
            *conv_bn_relu(bc, bc * 2), time_pool(), FastDropout(dropout),
        )
        self.rnn = GRU(bc * 2 * in_features, rnn_hidden, num_layers)
        self.rnn_dropout = FastDropout(dropout)
        self.classifier = Linear(rnn_hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.unsqueeze(1))  # (B, C, T', F)
        h = h.permute(0, 2, 1, 3).flatten(2)  # (B, T', C * F), channel-major
        for k in range(self.rnn.num_layers):
            h = self.rnn.layer(h, k)
            if k < self.rnn.num_layers - 1:
                h = self.rnn_dropout(h)
        return self.classifier(h[:, -1])

    @staticmethod
    def widths(sd: dict) -> dict:
        bc = sd["conv.0.weight"].shape[0]
        return {"base_channels": bc, "rnn_hidden": sd["rnn.weight_hh_l0"].shape[1],
                "in_features": sd["rnn.weight_ih_l0"].shape[1] // (2 * bc)}


class CRNN2(CRNN):
    def __init__(self, in_features: int = 321, base_channels: int = 32, rnn_hidden: int = 128,
                 num_layers: int = 2, dropout: float = 0.3):
        super().__init__(in_features, base_channels, rnn_hidden, num_layers, dropout)


class CNN2DRobust(nn.Module):
    """Double-conv blocks, squeeze-and-excitation and attention pooling
    over time."""

    def __init__(self, base_channels: int = 64, dropout: float = 0.3):
        super().__init__()
        bc = base_channels
        for b, (c_in, c_out) in enumerate(((1, bc), (bc, bc * 2), (bc * 2, bc * 4)), 1):
            self.add_module(f"block{b}", nn.Sequential(
                *conv_bn_relu(c_in, c_out), *conv_bn_relu(c_out, c_out), time_pool(), ChannelDropout(dropout),
            ))
        c = bc * 4
        self.se = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c // 16, 1), nn.ReLU(), nn.Conv2d(c // 16, c, 1), nn.Sigmoid(),
        )
        self.attention_pool = Linear(c, 1)
        self.classifier = nn.Sequential(
            FastDropout(dropout), Linear(c, 256), nn.ReLU(), FastDropout(dropout), Linear(256, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block3(self.block2(self.block1(x.unsqueeze(1))))  # (B, C, T', F)
        h = h * self.se(h)
        h = h.mean(dim=3).transpose(1, 2)  # (B, T', C): the mean over features
        attn = torch.softmax(self.attention_pool(h), dim=1)  # (B, T', 1)
        return self.classifier((h * attn).sum(dim=1))

    @staticmethod
    def widths(sd: dict) -> dict:
        return {"base_channels": sd["block1.0.weight"].shape[0]}
