"""JAX model variables -> the port's ``state_dict``.

Same layout rules as ``flax_to_torch`` in ``dfac_tpu/utils/torch_export.py``,
written again here so that the port never imports ``dfac_tpu``:

* conv kernel HWIO ``(kh, kw, I, O)`` -> OIHW ``(O, I, kh, kw)``;
* Dense kernel ``(I, O)`` -> Linear weight ``(O, I)``;
* BatchNorm ``scale/bias`` params and ``mean/var`` batch stats ->
  ``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``).
"""

from __future__ import annotations

import numpy as np
import torch

# (torch prefix, kind, JAX path) — the reference CNN2D Sequential indices
_CNN2D = [
    entry
    for i, (ci, bi) in enumerate([(0, 1), (5, 6), (10, 11)], 1)
    for entry in ((f"conv.{ci}", "conv2d", (f"conv{i}", "conv")), (f"conv.{bi}", "bn", (f"bn{i}",)))
] + [("classifier", "linear", ("classifier", "dense"))]


def _get(tree: dict, path: tuple[str, ...]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def state_dict_from_jax(variables: dict, model_name: str = "cnn2d") -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree of numpy arrays -> state_dict."""
    if model_name != "cnn2d":
        raise NotImplementedError(f"no JAX -> torch mapping for '{model_name}' yet (see ROADMAP.md)")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for prefix, kind, path in _CNN2D:
        if kind == "bn":
            sd[f"{prefix}.weight"] = _t(_get(params, path + ("scale",)))
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("bias",)))
            sd[f"{prefix}.running_mean"] = _t(_get(stats, path + ("mean",)))
            sd[f"{prefix}.running_var"] = _t(_get(stats, path + ("var",)))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif kind == "linear":
            sd[f"{prefix}.weight"] = _t(_get(params, path + ("kernel",)).T)
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("bias",)))
        else:  # conv2d
            sd[f"{prefix}.weight"] = _t(np.transpose(_get(params, path + ("kernel",)), (3, 2, 0, 1)))
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("bias",)))
    return sd
