"""bf16 compute in the PyTorch port against the JAX package's
``compute_dtype=bfloat16``, on the CPU at small widths: CNN2D and CNN1D
(base 4) and the detector (hidden 16), 16 frames of 12 features, B=8.

The port writes JAX's casts out (``models/common.py``): f32 parameters
cast to bf16 for each conv and matmul, the bias added in bf16, BatchNorm
statistics in f32 from the bf16 input, the result cast back, the pools and
activations in bf16, the logits in f32 (the detector's stats pool in
f32). Bounds: the eval forward within 2e-2 of JAX's on the same weights
(two bf16 chains, ``tests/test_conv_block.py:45``'s bound); one training
step (dropout 0: the draws are each package's own) from the same weights:
the loss within rtol 2e-2 of JAX's; every gradient within 3e-2 * max|g|
of JAX's (a bf16 sum carries rounding of ~2^-8 of its terms; measured:
0.6%, 0.9% and 1.9% of max|g|); every parameter after the step within 0.1
* lr of JAX's where both gradients agree in sign and exceed 5e-2 * max|g|
(Adam's first step moves a parameter by ~lr in its gradient's sign; a
smaller gradient can change sign between the JAX package's own jitted step
and an eager evaluation of it), which holds for more than a quarter of the
parameters, and no parameter more than 2 * lr from JAX's.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfac_tpu.models import build_model as jbuild
from dfac_tpu.ops.train_chain import cnn2d_hand_loss_and_grad
from dfac_tpu.train import detector_loop as jdet
from dfac_tpu.train import loop as jloop
from dfac_tpu.train import optim as joptim
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.train import detector_loop as tdet
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.utils.convert import params_from_jax, state_dict_from_jax

B, T_, F_ = 8, 16, 12
LR, SMOOTH = 1e-3, 0.05
WIDTHS = {"cnn2d": dict(in_features=F_, base_channels=4), "cnn1d": dict(in_features=F_, base_channels=4),
          "detector": dict(in_channels=F_, hidden=16)}
FWD_ATOL, LOSS_RTOL = 2e-2, 2e-2


def _x(seed, shape=(B, T_, F_)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _variables(name):
    model = jbuild(name, **WIDTHS[name])
    v = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.asarray(_x(0))))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree.map(lambda a: (0.5 + rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    return v


@pytest.mark.parametrize("name", list(WIDTHS))
def test_bf16_eval_forward_matches_jax(name):
    v = _variables(name)
    x = _x(1)
    want = np.asarray(jbuild(name, compute_dtype=jnp.bfloat16, **WIDTHS[name]).apply(v, jnp.asarray(x)))
    model = tbuild(name, compute_dtype=torch.bfloat16, **WIDTHS[name])
    model.load_state_dict(state_dict_from_jax(v, name))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL)
    f32 = tbuild(name, **WIDTHS[name])
    f32.load_state_dict(model.state_dict())
    assert not torch.equal(f32.eval()(torch.from_numpy(x)), got)  # the layers did run in bf16


def _jax_step(name, v, feats, labels):
    """JAX's bf16 step: the trainer's for CNN2D (its hand-scheduled chain)
    and CNN1D, the detector trainer's for the detector."""
    kw = dict(WIDTHS[name], compute_dtype=jnp.bfloat16, dropout=0.0)
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v["batch_stats"])
    if name == "detector":
        model = jbuild(name, encoder_dropout=0.0, **kw)
        cfg = jdet.DetectorConfig(batch_size=B, lr=LR, hidden=16, dropout=0.0, encoder_dropout=0.0, seed=0,
                                  compute_dtype="bfloat16")
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adamw(LR, weight_decay=cfg.weight_decay))
        state = jdet.DetectorState(params=params, batch_stats=stats, ema_params=params, opt_state=tx.init(params),
                                   key=jax.random.key(0))
        lens = np.full(B, T_, np.int32)

        def loss_fn(p):
            logits, _ = model.apply({"params": p, "batch_stats": stats}, jnp.transpose(jnp.asarray(feats), (0, 2, 1)),
                                    lengths=jnp.asarray(lens), train=True, mutable=["batch_stats"])
            return jdet.pos_weight_bce(logits, jnp.asarray(labels), 1.0)

        new, loss = jdet.make_detector_train_step(model, tx, cfg, 1.0)(
            state, jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(labels))
        return float(loss), jax.grad(loss_fn)(params), new.params
    model = jbuild(name, **kw)
    tx = joptim.build_optimizer(name, LR)
    state = jloop.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params), key=jax.random.key(0))

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, jnp.transpose(jnp.asarray(feats), (0, 2, 1)),
                             train=True, mutable=["batch_stats"])
        smoothed = joptim.smooth_labels(jnp.asarray(labels), SMOOTH)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(out.reshape(-1), smoothed))

    step = jloop.make_train_step(model, tx, swap_tf=True, label_smoothing=SMOOTH, augment_fn=None)
    new, loss_sum, count = step(state, jnp.asarray(feats), jnp.asarray(labels), jnp.ones(B, jnp.float32))
    if name == "cnn2d":  # the gradient the step took: its hand-scheduled chain's, in bf16
        x = jnp.transpose(jnp.asarray(feats), (0, 2, 1))
        (_, _), grads = cnn2d_hand_loss_and_grad(
            params, stats, x, jax.random.split(jax.random.key(1), 2), jnp.asarray(labels), jnp.ones(B, jnp.float32),
            dropout_rate=0.0, label_smoothing=SMOOTH, compute_dtype=jnp.bfloat16)
    else:
        grads = jax.grad(loss_fn)(params)
    return float(loss_sum) / float(count), grads, new.params


def _torch_step(name, v, feats, labels):
    sd = state_dict_from_jax(v, name)
    x, y = torch.from_numpy(feats), torch.from_numpy(labels)
    if name == "detector":
        trainer = tdet.DetectorTrainer(tdet.DetectorConfig(batch_size=B, lr=LR, hidden=16, dropout=0.0,
                                                           encoder_dropout=0.0, seed=0, compute_dtype="bfloat16"),
                                       in_channels=F_, device="cpu")
        trainer.init_state(sd)
        loss = float(trainer.train_step(x, torch.full((B,), T_, dtype=torch.int32), y, 1.0))
        return loss, trainer.model
    cfg = tloop.TrainConfig(model=name, batch_size=B, lr=LR, dropout=0.0, label_smoothing=SMOOTH,
                            compute_dtype="bfloat16", in_features=F_)
    trainer = tloop.Trainer(cfg, device="cpu", model=tbuild(name, compute_dtype=torch.bfloat16, dropout=0.0,
                                                            **WIDTHS[name]))
    trainer.init_state(sd)
    loss_sum, count = trainer.train_step(x, y, torch.ones(B))
    return float(loss_sum) / float(count), trainer.model


@pytest.mark.parametrize("name", list(WIDTHS))
def test_bf16_train_step_matches_jax(name):
    v = _variables(name)
    feats, labels = _x(2, (B, F_, T_)), (np.arange(B) % 2).astype(np.float32)
    want_loss, want_grads, want_params = _jax_step(name, v, feats, labels)
    got_loss, model = _torch_step(name, v, feats, labels)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    grads = params_from_jax(jax.tree.map(np.asarray, want_grads), name)
    after_jax = params_from_jax(jax.tree.map(np.asarray, want_params), name)
    g_max = max(float(g.abs().max()) for g in grads.values())
    n_held = 0
    for pname, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        g_j, g_t = grads[pname].numpy(), p.grad.numpy()
        delta = np.abs(p.detach().numpy() - after_jax[pname].numpy())
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=3e-2 * g_max, err_msg=pname)
        held = (np.sign(g_j) == np.sign(g_t)) & (np.abs(g_j) > 5e-2 * g_max) & (np.abs(g_t) > 5e-2 * g_max)
        np.testing.assert_array_less(delta[held], 0.1 * LR, err_msg=pname)
        assert delta.max() <= 2 * LR, pname
        n_held += int(held.sum())
    assert n_held > 0.25 * sum(p.numel() for p in model.parameters())


def test_no_module_of_the_port_uses_autocast():
    root = pathlib.Path(__file__).resolve().parents[1] / "dfac_tpu_torch"
    users = [str(p.relative_to(root)) for p in root.rglob("*.py") if "autocast(" in p.read_text()]
    assert users == []
