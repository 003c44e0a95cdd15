"""JAX model variables <-> the port's ``state_dict``, and optax's Adam
moments -> torch's.

Same layout rules as ``flax_to_torch`` / ``torch_to_flax`` in
``dfac_tpu/utils/``, written again here so that the port never imports
``dfac_tpu``:

* conv kernel HWIO ``(kh, kw, I, O)`` <-> OIHW ``(O, I, kh, kw)``;
* conv1d kernel ``(k, I, O)`` <-> ``(O, I, k)``;
* transposed-conv kernel ``(kh, kw, I, O)`` <-> ConvTranspose2d's
  ``(I, O, kh, kw)`` **flipped in both spatial axes**: ``lax.conv_transpose``
  correlates where torch's transposed conv (the gradient of a conv) flips,
  so an unflipped copy still runs and gives plausible, wrong outputs;
* Dense kernel ``(I, O)`` <-> Linear weight ``(O, I)``;
* BatchNorm ``scale/bias`` params and ``mean/var`` batch stats <->
  ``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked``,
  which JAX does not keep: momentum is fixed, so it is never read);
* GRU: flax's ``GRUCell`` (``ir/iz/in`` Dense kernels with biases,
  ``hr/hz`` without, ``hn`` with) <-> ``weight_ih_l{k}`` / ``weight_hh_l{k}``
  row blocks ``[r; z; n]`` and ``bias_ih_l{k}`` / ``bias_hh_l{k}``. flax
  has no recurrent bias on r and z, so JAX -> torch puts ``[b_ir, b_iz,
  b_in]`` on the input side and ``[0, 0, b_hn]`` on the recurrent one;
  torch -> JAX folds ``bias_hh``'s r and z parts into the input biases
  (an exact reparametrization, as ``torch_import``'s).
"""

from __future__ import annotations

import numpy as np
import torch

def _blocks(prefix: str, kind: str, pairs, conv: str, bn: str) -> list:
    return [
        entry
        for i, (ci, bi) in enumerate(pairs, 1)
        for entry in ((f"{prefix}.{ci}", kind, (f"{conv}{i}", "conv")), (f"{prefix}.{bi}", "bn", (f"{bn}{i}",)))
    ]


_CLASSIFIER = [("classifier", "linear", ("classifier", "dense"))]
_CNN2D = _blocks("conv", "conv2d", [(0, 1), (5, 6), (10, 11)], "conv", "bn") + _CLASSIFIER
_CNN1D = _blocks("conv", "conv1d", [(0, 1), (4, 5), (8, 9)], "conv", "bn") + _CLASSIFIER
_MLP = [(f"feature_extractor.{ti}", "linear", (f"fc{i}", "dense")) for i, ti in enumerate((0, 3, 6), 1)]


def _crnn(num_layers: int) -> list:
    return (_blocks("conv", "conv2d", [(0, 1), (5, 6)], "conv", "bn")
            + [(f"rnn#{k}", "gru", (f"gru{k + 1}", "cell")) for k in range(num_layers)] + _CLASSIFIER)

# (torch prefix, kind, JAX path) per family, in the torch module's order: the
# reference state_dicts' Sequential indices (the JAX package's torch_import
# tables, dfac_tpu/utils/torch_import.py:71-92)
_MAPPINGS = {
    "cnn2d": _CNN2D,
    "cnn2d_spatial": _CNN2D,
    "cnn1d": _CNN1D,
    "cnn1d_variant": _CNN1D,
    "cnn1d_spatial": _CNN1D,
    "cnn1d_archive": _CNN1D,
    "meanpool_mlp": _MLP,
    "statspool_mlp": _MLP,
    "crnn": _crnn(1),
    "crnn2": _crnn(2),
    "cnn2d_robust": [
        entry
        for b in (1, 2, 3)
        for entry in _blocks(f"block{b}", "conv2d", [(0, 1), (3, 4)], f"block{b}_conv", f"block{b}_bn")
    ]
    + [("se.1", "conv2d", ("se_fc1", "conv")), ("se.3", "conv2d", ("se_fc2", "conv")),
       ("attention_pool", "linear", ("attention_pool", "dense")),
       ("classifier.1", "linear", ("head_fc1", "dense")), ("classifier.4", "linear", ("head_fc2", "dense"))],
    "cae": _blocks("encoder", "conv2d", [(0, 1), (4, 5), (8, 9), (12, 13)], "enc_conv", "enc_bn")
    + [
        entry
        for i, ti in enumerate([0, 3, 6, 9], 1)
        for entry in [(f"decoder.{ti}", "convt2d", (f"dec_convt{i}",))]
        + ([(f"decoder.{ti + 1}", "bn", (f"dec_bn{i}",))] if i < 4 else [])  # the last block has no BN
    ],
    "detector": _blocks("enc.net", "conv1d", [(0, 1), (4, 5), (8, 9)], "enc_conv", "enc_bn")
    + [("head.0", "linear", ("head_fc1", "dense")), ("head.3", "linear", ("head_fc2", "dense"))],
}

# torch parameter suffix -> JAX leaf path under the entry's path, per kind
# (BN statistics apart); a transposed conv's kernel sits one level down
_GATES = (("r", "ir", "hr"), ("z", "iz", "hz"), ("n", "in", "hn"))
_LEAVES = {"gru": {}, "conv2d": {"weight": ("kernel",), "bias": ("bias",)},
           "conv1d": {"weight": ("kernel",), "bias": ("bias",)},
           "convt2d": {"weight": ("convt", "kernel"), "bias": ("bias",)},
           "linear": {"weight": ("kernel",), "bias": ("bias",)},
           "bn": {"weight": ("scale",), "bias": ("bias",)}}


def _get(tree: dict, path: tuple[str, ...]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _put(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy


def _to_torch_layout(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return a
    if kind == "conv2d":
        return np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
    if kind == "conv1d":
        return np.transpose(a, (2, 1, 0))  # (k, I, O) -> (O, I, k)
    if kind == "convt2d":
        return np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1]  # (kh, kw, I, O) -> (I, O, kh, kw), flipped
    if kind == "linear":
        return a.T
    return a


def _to_jax_layout(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return a
    if kind == "conv2d":
        return np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
    if kind == "conv1d":
        return np.transpose(a, (2, 1, 0))  # (O, I, k) -> (k, I, O)
    if kind == "convt2d":
        return np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1))  # flip, then (I, O, kh, kw) -> (kh, kw, I, O)
    if kind == "linear":
        return a.T
    return a


def _mapping(model_name: str) -> list:
    if model_name not in _MAPPINGS:
        raise ValueError(f"no JAX <-> torch mapping for model '{model_name}' (mapped: {sorted(_MAPPINGS)})")
    return _MAPPINGS[model_name]


def params_from_jax(params: dict, model_name: str = "cnn2d") -> dict[str, torch.Tensor]:
    """A JAX ``params`` tree (or a tree of its shape, such as Adam's
    moments) -> ``{torch parameter name: tensor}`` in torch's layouts."""
    out: dict[str, torch.Tensor] = {}
    for prefix, kind, path in _mapping(model_name):
        if kind == "gru":
            out.update(_gru_from_jax(params, prefix, path))
        for leaf, jleaf in _LEAVES[kind].items():
            out[f"{prefix}.{leaf}"] = _t(_to_torch_layout(kind, leaf, _get(params, path + jleaf)))
    return out


def _gru_from_jax(params: dict, prefix: str, path: tuple) -> dict[str, torch.Tensor]:
    """One ``GRUCell``'s tree (or a tree of its shape) -> layer k's four
    torch tensors, ``prefix`` ``"rnn#k"``."""
    base, k = prefix.split("#")
    kernel = {name: _get(params, path + (name, "kernel")).T for _, i, h in _GATES for name in (i, h)}
    b_in = {i: _get(params, path + (i, "bias")) for _, i, _ in _GATES}
    b_hn = _get(params, path + ("hn", "bias"))
    zeros = np.zeros_like(b_hn)
    return {
        f"{base}.weight_ih_l{k}": _t(np.concatenate([kernel[i] for _, i, _ in _GATES], 0)),
        f"{base}.weight_hh_l{k}": _t(np.concatenate([kernel[h] for _, _, h in _GATES], 0)),
        f"{base}.bias_ih_l{k}": _t(np.concatenate([b_in[i] for _, i, _ in _GATES])),
        f"{base}.bias_hh_l{k}": _t(np.concatenate([zeros, zeros, b_hn])),
    }


def _gru_to_jax(sd: dict, prefix: str, path: tuple, params: dict) -> None:
    """The inverse of :func:`_gru_from_jax`, folding ``bias_hh``'s r and z
    parts into the input-side biases."""
    base, k = prefix.split("#")
    blocks = {n: np.split(sd[f"{base}.{n}_l{k}"], 3) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    for g, (gate, i, h) in enumerate(_GATES):
        _put(params, path + (i, "kernel"), np.ascontiguousarray(blocks["weight_ih"][g].T))
        _put(params, path + (h, "kernel"), np.ascontiguousarray(blocks["weight_hh"][g].T))
        if gate == "n":
            _put(params, path + (i, "bias"), blocks["bias_ih"][g])
            _put(params, path + (h, "bias"), blocks["bias_hh"][g])
        else:
            _put(params, path + (i, "bias"), blocks["bias_ih"][g] + blocks["bias_hh"][g])


def state_dict_from_jax(variables: dict, model_name: str = "cnn2d") -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree of numpy arrays -> state_dict."""
    params = params_from_jax(variables["params"], model_name)
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for prefix, kind, path in _mapping(model_name):
        if kind == "gru":
            base, k = prefix.split("#")
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                sd[f"{base}.{n}_l{k}"] = params[f"{base}.{n}_l{k}"]
        for leaf in _LEAVES[kind]:
            sd[f"{prefix}.{leaf}"] = params[f"{prefix}.{leaf}"]
        if kind == "bn":
            sd[f"{prefix}.running_mean"] = _t(_get(stats, path + ("mean",)))
            sd[f"{prefix}.running_var"] = _t(_get(stats, path + ("var",)))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def jax_from_state_dict(state_dict: dict, model_name: str = "cnn2d") -> dict:
    """The inverse of :func:`state_dict_from_jax`: a state_dict (tensors on
    any device) -> JAX ``{'params', 'batch_stats'}`` of f32 numpy arrays,
    the layout the JAX package's checkpoints hold (no ``batch_stats`` for
    a model without BatchNorm, as the JAX trainer's ``variables()``)."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items() if v.is_floating_point()}
    params: dict = {}
    stats: dict = {}
    for prefix, kind, path in _mapping(model_name):
        if kind == "gru":
            _gru_to_jax(sd, prefix, path, params)
        for leaf, jleaf in _LEAVES[kind].items():
            _put(params, path + jleaf, np.ascontiguousarray(_to_jax_layout(kind, leaf, sd[f"{prefix}.{leaf}"])))
        if kind == "bn":
            _put(stats, path + ("mean",), sd[f"{prefix}.running_mean"])
            _put(stats, path + ("var",), sd[f"{prefix}.running_var"])
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _find_adam(node):
    """The ``ScaleByAdamState(count, mu, nu)`` inside an optax state (a
    NamedTuple, or the field-keeping stand-in of a checkpoint read
    without optax), searched depth first through tuples and lists."""
    if type(node).__name__ == "ScaleByAdamState":
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, param_names: list[str], model_name: str = "cnn2d") -> dict:
    """optax's Adam(W) state -> ``{param index: {step, exp_avg,
    exp_avg_sq}}``, the ``state`` of a torch Adam/AdamW ``state_dict`` for
    parameters in the order ``param_names``.

    ``opt_state`` is what ``optax.inject_hyperparams(optax.adamw)`` keeps
    (``InjectHyperparamsState`` holding ``(ScaleByAdamState(count, mu, nu),
    ...)``): the moments take the parameters' layout transposes, and
    ``count`` (optax's update count) is torch's ``step``."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    count, mu, nu = tuple(adam)[:3]
    mu_t, nu_t = params_from_jax(mu, model_name), params_from_jax(nu, model_name)
    step = float(np.asarray(count))
    return {
        i: {"step": torch.tensor(step), "exp_avg": mu_t[name], "exp_avg_sq": nu_t[name]}
        for i, name in enumerate(param_names)
    }
