"""Checkpoint loading (the read half of :mod:`dfac_tpu.train.checkpoint`).

Two on-disk formats load into the port's ``state_dict``:

* **dfac_tpu pickle checkpoints** — a pickled dict ``{format, model_state,
  optimizer_state, epoch, config}`` whose arrays are numpy. The optimizer
  state pickles optax NamedTuple classes, so a plain ``pickle.load`` would
  import optax and with it jax. :class:`_ModelStateUnpickler` stubs every
  ``jax``/``jaxlib``/``optax``/``flax`` class instead, and only
  ``model_state`` is kept.
* **reference PyTorch ``.pt`` files** — wrapped dicts or raw state_dicts
  (reference ``src/training/checkpoint.py:42-71``), read with
  ``torch.load(weights_only=True)``. A wrapped dict's ``config`` and
  ``epoch`` may hold numpy scalars, dtypes and arrays or an
  ``argparse.Namespace`` (what a training script saves), so those globals
  are allowed for the load (:func:`_reference_globals`); any other global
  in the pickle is still refused.

Orbax checkpoint directories are not supported yet.
"""

from __future__ import annotations

import argparse
import os
import pickle
import zipfile

import numpy as np
import torch

from dfac_tpu_torch.utils.convert import state_dict_from_jax

_JAX_MODULES = ("jax", "jaxlib", "optax", "flax", "orbax", "chex")


class _Stub:
    """Stand-in for a JAX-ecosystem class inside a pickle: accepts any
    constructor arguments and state, keeps nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _frozen_dict(*args, **kwargs):
    return dict(*args, **kwargs)


class _ModelStateUnpickler(pickle.Unpickler):
    """Unpickles a dfac_tpu checkpoint without importing jax."""

    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _JAX_MODULES:
            if root == "flax" and name == "FrozenDict":
                return _frozen_dict  # a params tree saved as a FrozenDict
            return type(name, (_Stub,), {"__module__": module})
        return super().find_class(module, name)


def _reference_globals() -> list:
    """The globals a reference checkpoint's metadata names besides tensors:
    numpy scalars, dtypes (and numpy 2's dtype classes) and arrays, under
    the module names of numpy 1 and 2, and ``argparse.Namespace``."""
    multiarray = np._core.multiarray if hasattr(np, "_core") else np.core.multiarray
    allowed: list = [argparse.Namespace, np.dtype, np.ndarray]
    for fn in (multiarray.scalar, multiarray._reconstruct):
        allowed += [(fn, f"numpy.{core}.multiarray.{fn.__name__}") for core in ("core", "_core")]
    dtypes = getattr(np, "dtypes", None)  # numpy >= 1.25
    if dtypes is not None:
        allowed += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return allowed


def _extract_state_dict(ckpt) -> dict:
    """Accept wrapped ``{model_state_dict: ...}`` dicts and raw state_dicts
    (reference ``src/evaluation.py:197-200`` tolerance rule)."""
    if isinstance(ckpt, dict):
        for key in ("model_state_dict", "model_state", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    if not isinstance(ckpt, dict):
        raise ValueError("unrecognized checkpoint structure")
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def load_model_variables(path: str, model_name: str = "cnn2d") -> dict[str, torch.Tensor]:
    """Load a dfac_tpu pickle checkpoint or a reference ``.pt`` file as the
    port's ``state_dict`` (CPU tensors), auto-detected."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (orbax checkpoint); orbax loading is not ported yet"
        )
    if zipfile.is_zipfile(path) or path.endswith(".pt"):
        with torch.serialization.safe_globals(_reference_globals()):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return _extract_state_dict(ckpt)
    with open(path, "rb") as f:
        ckpt = _ModelStateUnpickler(f).load()
    variables = ckpt["model_state"] if isinstance(ckpt, dict) and "model_state" in ckpt else ckpt
    return state_dict_from_jax(variables, model_name)
