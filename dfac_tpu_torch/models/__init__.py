"""Model registry (the ported subset of :mod:`dfac_tpu.models`)."""

from __future__ import annotations

import inspect
from typing import Any

from torch import nn

from dfac_tpu_torch.models.cnn2d import CNN2D

MODEL_REGISTRY = {"cnn2d": CNN2D}


def build_model(name: str, **overrides: Any) -> nn.Module:
    """Instantiate a registered model; overrides the constructor does not
    take are ignored, as in the JAX registry (CLIs pass one flag set to
    every family)."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model '{name}' is not ported to dfac_tpu_torch yet; see ROADMAP.md "
            f"for the order of the remaining families (ported: {sorted(MODEL_REGISTRY)})"
        )
    cls = MODEL_REGISTRY[name]
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in overrides.items() if k in params})
