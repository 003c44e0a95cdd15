"""The archived zoo and ``cnn1d_variant`` in the PyTorch port against the
JAX package, on the CPU at small widths (base 4, hidden 8, 16 frames of
12 features, B=4).

For each model: the parameter names both ways (the JAX package's own
``flax_to_torch`` names them), the eval forward on the same weights (atol
1e-5, rtol 1e-4: ``tests/test_torch_parity.py``'s bound), and one train
step through each package's trainer on the same dropout draws: the JAX
step's ``jax.random.bits`` / ``jax.random.bernoulli`` return seeded numpy
draws, recorded in call order, and the port replays them in its layouts
(NHWC -> NCHW) through ``models.common.random_bytes`` / ``keep_draws``.
The step's tolerances are ``tests/test_torch_port_train.py``'s: the loss
rtol 1e-5, the grads rtol 1e-4 + atol 1e-6 * max|g|, BN running statistics
1e-5, the parameters after one AdamW step 1e-6 where |g| > 1e-6. The
GRU's conversion is checked with nonzero recurrent r and z biases
against ``torch_to_flax`` / ``flax_to_torch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfac_tpu.models import build_model as jbuild
from dfac_tpu.train import loop as jloop
from dfac_tpu.train import optim as joptim
from dfac_tpu.utils.torch_export import flax_to_torch
from dfac_tpu.utils.torch_import import torch_to_flax
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import common as tcommon
from dfac_tpu_torch.models import model_from_state_dict
from dfac_tpu_torch.models.zoo import adaptive_avg_pool_1d
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.utils.convert import jax_from_state_dict, params_from_jax, state_dict_from_jax

B, T_, F_ = 4, 16, 12
LR, SMOOTH, DROPOUT = 1e-3, 0.05, 0.3
WIDTHS = dict(in_features=F_, in_channels=F_, base_channels=4, hidden_dim=8, rnn_hidden=8, dropout=DROPOUT)
ZOO = ["meanpool_mlp", "statspool_mlp", "cnn1d_spatial", "cnn1d_archive", "cnn2d_spatial", "crnn", "crnn2",
       "cnn2d_robust", "cnn1d_variant"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These torch fits are tiny: one intra-op thread a process runs them
    fastest, alone or beside other test processes (module scope, so the
    module's fixtures run pinned too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _widths(name):
    return {**WIDTHS, "kernel_sizes": (5, 3, 3)} if name == "cnn1d_variant" else WIDTHS


def _x(seed=0, shape=(B, T_, F_)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_variables(name):
    """JAX init with BatchNorm statistics moved off (0, 1)."""
    model = jbuild(name, **_widths(name))
    v = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                                            jnp.asarray(_x())))
    rng = np.random.default_rng(5)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(lambda a: (0.5 + rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    return model, v


def _torch_names(name):
    return "cnn1d" if name == "cnn1d_variant" else name  # the JAX exporter has no cnn1d_variant table


@pytest.mark.parametrize("name", ZOO)
def test_names_both_ways_and_eval_forward_match_jax(name):
    jmodel, v = _jax_variables(name)
    sd = state_dict_from_jax(v, name)
    assert set(sd) == set(flax_to_torch(_torch_names(name), v))
    tmodel = tbuild(name, **_widths(name))
    assert set(tmodel.state_dict()) == set(sd)
    tmodel.load_state_dict(sd)
    back = jax_from_state_dict(sd, name)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    jax.tree.map(np.testing.assert_array_equal, back, v)
    x = _x(1)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x)))
    got = tmodel.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    again = model_from_state_dict(name, sd).eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(again, got)  # the widths read back from the weights


def test_adaptive_pool_takes_jax_bins():
    from dfac_tpu.models.zoo import adaptive_avg_pool_1d as jpool

    x = _x(2, (2, 17, 6))
    for bins in (1, 2, 3, 5, 17):
        want = np.asarray(jpool(jnp.asarray(x), bins))  # (B, bins, C)
        got = adaptive_avg_pool_1d(torch.from_numpy(x).transpose(1, 2), bins).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_weights_both_ways_with_recurrent_r_and_z_biases(layers):
    name = "crnn2" if layers == 2 else "crnn"
    tmodel = tbuild(name, **WIDTHS).eval()
    with torch.no_grad():
        for k in range(layers):  # nonzero recurrent biases on every gate
            getattr(tmodel.rnn, f"bias_hh_l{k}").uniform_(-0.5, 0.5)
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    assert np.abs(sd["rnn.bias_hh_l0"][:16]).min() > 0
    want = torch_to_flax(name, sd)  # the JAX importer folds b_hh's r and z parts
    got = jax_from_state_dict(tmodel.state_dict(), name)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=1e-7), got["params"], want["params"])
    x = _x(3)
    jout = np.asarray(jbuild(name, **WIDTHS).apply(got, jnp.asarray(x)))
    np.testing.assert_allclose(tmodel(torch.from_numpy(x)).detach().numpy(), jout, atol=1e-5, rtol=1e-4)
    # JAX -> port: the exporter's layout (zero r, z recurrent biases) and the same function
    sd_back = state_dict_from_jax(got, name)
    exported = flax_to_torch(name, got)
    for k in exported:
        np.testing.assert_allclose(sd_back[k].numpy(), exported[k], atol=1e-7, err_msg=k)
    assert not sd_back["rnn.bias_hh_l0"][:16].any()
    back = model_from_state_dict(name, sd_back).eval()
    np.testing.assert_allclose(back(torch.from_numpy(x)).detach().numpy(), jout, atol=1e-5, rtol=1e-4)


class SharedDraws:
    """Seeded draws in call order, one sequence per JAX trace (the gradient's
    and the step's draw the same arrays); the port replays the first."""

    def __init__(self):
        self.traces = []

    def new_trace(self):
        self.traces.append([])

    def _draw(self, make):
        a = make(np.random.default_rng(1000 + len(self.traces[-1])))
        self.traces[-1].append(a)
        return jnp.asarray(a)

    def jax_bits(self, key, shape=(), dtype=jnp.uint8):
        return self._draw(lambda rng: rng.integers(0, 256, shape, dtype=np.uint8))

    def jax_bernoulli(self, key, p=0.5, shape=None):
        return self._draw(lambda rng: rng.random(shape) < p)

    def start_replay(self):
        self.replay = iter(self.traces[0])

    def _next(self, shape):
        a = next(self.replay)
        if a.shape != tuple(shape):  # channels-last -> NCHW / (B, C, T)
            a = np.moveaxis(a, -1, 1)
            if a.shape != tuple(shape):  # a channel mask: (B, 1, .., C) -> (B, C, 1, ..)
                a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    def torch_bytes(self, shape, device, generator):
        return self._next(shape)

    def torch_keep(self, shape, keep, device, generator):
        return self._next(shape)


def _jax_step(name, monkeypatch, draws):
    """The JAX gradient (``value_and_grad`` as the flax-AD step takes it)
    and one ``make_train_step`` step, each trace on the same draws."""
    jmodel, v = _jax_variables(name)
    x, labels = _x(4, (B, F_, T_)), np.array([0, 1, 1, 0], np.float32)
    tx = joptim.build_optimizer(name, LR)
    params = jax.tree.map(jnp.asarray, v["params"])
    stats = jax.tree.map(jnp.asarray, v.get("batch_stats", {}))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "bits", draws.jax_bits)
        m.setattr(jax.random, "bernoulli", draws.jax_bernoulli)

        def loss_fn(p):
            variables = {"params": p, **({"batch_stats": stats} if stats else {})}
            out, _ = jmodel.apply(variables, jnp.transpose(jnp.asarray(x), (0, 2, 1)), train=True,
                                  mutable=["batch_stats"], rngs={"dropout": jax.random.key(2)})
            smoothed = joptim.smooth_labels(jnp.asarray(labels), SMOOTH)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(out.reshape(-1), smoothed))

        draws.new_trace()
        grads = jax.grad(loss_fn)(params)
        draws.new_trace()
        step = jloop.make_train_step(jmodel, tx, swap_tf=True, label_smoothing=SMOOTH, augment_fn=None)
        state = jloop.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params), key=jax.random.key(3))
        new_state, loss_sum, count = step(state, jnp.asarray(x), jnp.asarray(labels), jnp.ones(B, jnp.float32))
    after = {"params": new_state.params, **({"batch_stats": new_state.batch_stats} if stats else {})}
    return (v, x, labels, float(loss_sum) / float(count), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, after))


@pytest.mark.parametrize("name", ZOO)
def test_one_train_step_matches_jax_on_the_same_draws(name, monkeypatch):
    draws = SharedDraws()
    v, x, labels, want_loss, want_grads, want_after = _jax_step(name, monkeypatch, draws)
    assert len(draws.traces) == 2 and len(draws.traces[0]) == len(draws.traces[1]) > 0
    for a, b in zip(*draws.traces):
        np.testing.assert_array_equal(a, b)

    draws.start_replay()
    monkeypatch.setattr(tcommon, "random_bytes", draws.torch_bytes)
    monkeypatch.setattr(tcommon, "keep_draws", draws.torch_keep)
    cfg = tloop.TrainConfig(model=name, batch_size=B, lr=LR, dropout=DROPOUT, label_smoothing=SMOOTH,
                            in_features=F_)
    trainer = tloop.Trainer(cfg, device="cpu", model=tbuild(name, **_widths(name)))
    trainer.init_state(state_dict_from_jax(v, name))
    before = {k: t.clone() for k, t in trainer.model.state_dict().items()}
    loss_sum, count = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels), torch.ones(B))
    assert next(draws.replay, None) is None  # every draw used, in order
    np.testing.assert_allclose(float(loss_sum) / float(count), want_loss, rtol=1e-5)

    grads = params_from_jax(want_grads, name)
    after_jax = state_dict_from_jax(want_after, name)
    g_max = max(float(g.abs().max()) for g in grads.values())
    after = trainer.model.state_dict()
    for pname, p in trainer.model.named_parameters():
        # JAX has no recurrent r, z biases: compare the n part of bias_hh
        rows = slice(2 * p.shape[0] // 3, None) if pname.startswith("rnn.bias_hh") else slice(None)
        g_want = grads[pname].numpy()[rows]
        np.testing.assert_allclose(p.grad.numpy()[rows], g_want, rtol=1e-4, atol=1e-6 * g_max, err_msg=pname)
        big = np.abs(g_want) > 1e-6
        np.testing.assert_allclose(after[pname].numpy()[rows][big], after_jax[pname].numpy()[rows][big], atol=1e-6,
                                   err_msg=pname)
        assert np.abs(after[pname].numpy() - before[pname].numpy()).max() <= 2 * LR
    for k in after:
        if "running" in k:
            np.testing.assert_allclose(after[k].numpy(), after_jax[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ZOO)
def test_optimizer_policy_is_jax_s(name):
    """AdamW with weight decay 0.01 for the names that start with ``cnn``,
    Adam for the rest (the MLPs and the CRNNs), as the JAX package's
    ``build_optimizer``; an explicit weight decay forces AdamW."""
    from dfac_tpu_torch.train.optim import build_optimizer

    params = [torch.nn.Parameter(torch.zeros(2))]
    opt = build_optimizer(name, params, LR)
    if name.startswith("cnn"):
        assert type(opt) is torch.optim.AdamW and opt.defaults["weight_decay"] == 0.01
    else:
        assert type(opt) is torch.optim.Adam and opt.defaults["weight_decay"] == 0.0
    assert type(build_optimizer(name, params, LR, weight_decay=1e-4)) is torch.optim.AdamW
    # JAX's: the same rule keyed on the same names (dfac_tpu/train/optim.py)
    jtx = joptim.build_optimizer(name, LR)
    state = jtx.init({"w": jnp.ones(2)})
    updates, _ = jtx.update({"w": jnp.zeros(2)}, state, {"w": jnp.ones(2)})  # a zero gradient: only decay moves
    assert bool(np.any(np.asarray(updates["w"]) != 0)) == name.startswith("cnn")
