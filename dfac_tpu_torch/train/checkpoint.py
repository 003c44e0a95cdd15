"""Checkpoints (counterpart of :mod:`dfac_tpu.train.checkpoint`).

The port writes the JAX package's format, so each package serves and
resumes the other's checkpoints:

* **dfac_tpu pickle checkpoints** — a pickled dict ``{format:
  "dfac_tpu.v1", model_state, optimizer_state, epoch, config,
  scheduler_state?}`` whose arrays are numpy; ``model_state`` is in the
  JAX package's layout (``{'params', 'batch_stats'}``, HWIO kernels, see
  :mod:`dfac_tpu_torch.utils.convert`). The port's AdamW state goes under
  its own key, ``torch_optimizer_state`` (numpy arrays), with
  ``optimizer_state: None``: the JAX package then resumes such a file
  with fresh Adam moments. A JAX-written ``optimizer_state`` pickles
  optax NamedTuple classes, so a plain ``pickle.load`` would import optax
  and with it jax. :class:`_ModelStateUnpickler` puts a stand-in in place
  of every ``jax``/``jaxlib``/``optax``/``flax`` class; the stand-in is a
  tuple that keeps the NamedTuple's fields in order, so the Adam moments
  of a JAX-written ``*_last.ckpt`` carry across
  (:func:`~dfac_tpu_torch.utils.convert.adam_state_from_optax`).
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
from typing import Any

import numpy as np
import torch

from dfac_tpu_torch.utils.convert import state_dict_from_jax

_JAX_MODULES = ("jax", "jaxlib", "optax", "flax", "orbax", "chex")
FORMAT = "dfac_tpu.v1"


class _Stub(tuple):
    """Stand-in for a JAX-ecosystem class inside a pickle: a tuple of its
    constructor arguments (a NamedTuple's fields, in order); any other
    state is ignored."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

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


def build_config_dict(args: Any) -> dict:
    """Snapshot hyperparameters from an argparse Namespace / dict
    (reference ``src/training/checkpoint.py:8-39``)."""
    fields = [
        "model", "batch_size", "epochs", "lr", "weight_decay", "early_stop",
        "lr_scheduler", "lr_scheduler_metric", "lr_scheduler_factor",
        "lr_scheduler_patience", "lr_scheduler_threshold", "lr_scheduler_min_lr",
        "in_features", "hidden_dim", "dropout", "seed", "label_smoothing",
        "swap_tf", "spec_augment",
    ]
    src = vars(args) if not isinstance(args, dict) else args
    return {k: src[k] for k in fields if k in src}


def _numpy_tree(node):
    """Tensors -> numpy arrays through dicts and lists (a torch optimizer
    state_dict stays readable without torch)."""
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_numpy_tree(v) for v in node)
    return node


def torch_tree(node):
    """The inverse of :func:`_numpy_tree` for an optimizer state_dict:
    numpy arrays -> tensors."""
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node))
    if isinstance(node, dict):
        return {k: torch_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(torch_tree(v) for v in node)
    return node


def save_checkpoint(
    path: str,
    variables: dict,
    epoch: int = 0,
    config: dict | None = None,
    scheduler_state: dict | None = None,
    torch_optimizer_state: dict | None = None,
) -> None:
    """Write the JAX package's pickle payload. ``variables`` is the JAX
    layout (:func:`~dfac_tpu_torch.utils.convert.jax_from_state_dict`);
    ``torch_optimizer_state`` an ``optimizer.state_dict()``, stored as
    numpy under its own key."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "format": FORMAT,
        "model_state": variables,
        "optimizer_state": None,
        "epoch": int(epoch),
        "config": config or {},
    }
    if scheduler_state is not None:
        payload["scheduler_state"] = scheduler_state
    if torch_optimizer_state is not None:
        payload["torch_optimizer_state"] = _numpy_tree(torch_optimizer_state)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_checkpoint(path: str) -> dict:
    """The whole payload of a dfac_tpu pickle checkpoint, read without jax
    (a raw variables tree comes back wrapped). Orbax directories are not
    ported."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (orbax checkpoint); orbax loading is not ported yet"
        )
    with open(path, "rb") as f:
        ckpt = _ModelStateUnpickler(f).load()
    if isinstance(ckpt, dict) and "model_state" in ckpt:
        return ckpt
    return {"model_state": ckpt, "optimizer_state": None, "epoch": 0, "config": {}}


def load_model_variables(path: str, model_name: str = "cnn2d") -> dict[str, torch.Tensor]:
    """Load a dfac_tpu pickle checkpoint or a reference ``.pt`` file as the
    port's ``state_dict`` (CPU tensors), auto-detected. ``model_name`` is
    one of :mod:`dfac_tpu_torch.utils.convert`'s families (cnn2d, cnn1d,
    cae, detector); a ``.pt`` already carries the port's names. A
    detector checkpoint of either package holds its eval variables (the
    EMA parameters with the live BatchNorm statistics)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (orbax checkpoint); orbax loading is not ported yet"
        )
    if zipfile.is_zipfile(path) or path.endswith(".pt"):
        with torch.serialization.safe_globals(_reference_globals()):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return _extract_state_dict(ckpt)
    return state_dict_from_jax(load_checkpoint(path)["model_state"], model_name)
