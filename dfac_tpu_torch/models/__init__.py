"""Model registry (counterpart of :mod:`dfac_tpu.models`).

``build_model(name, **overrides)`` resolves every architecture the
reference ships (current and archived), under the JAX registry's names.

The JAX modules read their input widths from the data; a torch module
fixes them when it is built. So a caller passes the width of the
model-view input that the model will be handed (:func:`model_width`), and
a model built for a checkpoint takes its widths from the weights' shapes
(:func:`model_from_state_dict`).
"""

from __future__ import annotations

import inspect
from typing import Any

from torch import nn

from dfac_tpu_torch.models.cae import ConvAutoencoder
from dfac_tpu_torch.models.cnn1d import CNN1D, CNN1DVariant
from dfac_tpu_torch.models.cnn2d import CNN2D
from dfac_tpu_torch.models.detector import DeepfakeDetector
from dfac_tpu_torch.models.zoo import (
    CNN1DArchive,
    CNN1DSpatial,
    CNN2DRobust,
    CNN2DSpatial,
    CRNN,
    CRNN2,
    MeanPoolMLP,
    StatsPoolMLP,
)

MODEL_REGISTRY: dict[str, type[nn.Module]] = {
    "cnn2d": CNN2D,
    "cnn1d": CNN1D,
    "cnn1d_variant": CNN1DVariant,
    "cae": ConvAutoencoder,
    "detector": DeepfakeDetector,
    # archived zoo
    "meanpool_mlp": MeanPoolMLP,
    "statspool_mlp": StatsPoolMLP,
    "cnn1d_spatial": CNN1DSpatial,
    "cnn1d_archive": CNN1DArchive,
    "cnn2d_spatial": CNN2DSpatial,
    "crnn": CRNN,
    "crnn2": CRNN2,
    "cnn2d_robust": CNN2DRobust,
}


def check_model_name(name: str) -> None:
    """Raise the JAX registry's ValueError for a name it does not hold."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{name}'; choose from {sorted(MODEL_REGISTRY)}")


def build_model(name: str, **overrides: Any) -> nn.Module:
    """Instantiate a registered model; overrides the constructor does not
    take are ignored, as in the JAX registry (CLIs pass one flag set to
    every family)."""
    check_model_name(name)
    cls = MODEL_REGISTRY[name]
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in overrides.items() if k in params})


def model_width(stored_shape, swap_tf: bool = True) -> int:
    """The last axis of the model-view input for features stored (N, F, T):
    F with ``swap_tf`` (the model sees (B, T, F)), T without."""
    return int(stored_shape[1] if swap_tf else stored_shape[2])


def width_overrides(width: int) -> dict:
    """:func:`build_model` overrides for an input of last axis ``width``:
    every family's input width is ``in_features`` or ``in_channels``."""
    return {"in_features": width, "in_channels": width}


def model_from_state_dict(name: str, state_dict: dict, **overrides: Any) -> nn.Module:
    """The ``name`` model at the widths ``state_dict``'s weights were made
    with, holding them. ``overrides`` (``compute_dtype``, ``dropout``, ...)
    go to the constructor, under the widths."""
    check_model_name(name)
    model = build_model(name, **{**overrides, **MODEL_REGISTRY[name].widths(state_dict)})
    model.load_state_dict(state_dict)
    return model
