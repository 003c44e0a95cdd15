"""CAE training in the PyTorch port against the JAX package.

A small ConvAutoencoder (base channels 4, 37 frames (odd, so the decoder's
output padding is traced), 20 features) starts from the JAX fit's own
init, carried across by ``state_dict_from_jax`` (the transposed convs
flipped). Tolerances as ``tests/test_torch_port_train.py``: the loss rtol
1e-5, the grads rtol 1e-4 + atol 1e-6 * max|g| over the whole gradient
(the pre-BatchNorm conv biases' gradients are 0 in exact arithmetic: each
side's is held to 1e-5 * max|g| instead), BN running statistics 1e-5,
parameters after one AdamW step 1e-6 where |g| > 1e-6 (within 2 * lr
elsewhere: Adam's first step divides by |g|);
the validation MSE of each epoch rtol 1e-3, the same best epoch, learning
rates and stop (the port's host-fed, resident, chunked and fused fits); the
normalizer rtol 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfac_tpu.data import normalizer as jnorm
from dfac_tpu.data import pipeline as jpipe
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models.cae import reconstruction_mse as j_mse
from dfac_tpu.train import cae_loop as jloop
from dfac_tpu.train import checkpoint as jckpt
from dfac_tpu.train.loop import TrainState
from dfac_tpu_torch.data import normalizer as tnorm
from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.train import cae_loop as tloop
from dfac_tpu_torch.train import checkpoint as tckpt
from dfac_tpu_torch.utils.convert import params_from_jax, state_dict_from_jax

F_, T_, BC, B = 20, 37, 4, 4
LR = 1e-4
N_TRAIN, N_DEV = 24, 16  # 12 bonafide rows at B=4; 8 bonafide dev rows
# the biases of the convs that a BatchNorm follows: BN subtracts the batch mean, so their
# gradient is 0 in exact arithmetic
PRE_BN_BIASES = {f"encoder.{i}.bias" for i in (0, 4, 8, 12)} | {f"decoder.{i}.bias" for i in (0, 3, 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These torch fits are tiny: one intra-op thread a process runs them
    fastest, alone or beside other test processes (module scope, so the
    module's fixtures run pinned too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(mod, n, seed):
    """Half bonafide; each row scaled by its own factor, the spoof rows'
    larger on average, so the CAE's EER lies between 0 and 0.5."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, F_, T_)).astype(np.float32)
    feats *= (rng.uniform(0.8, 1.2, size=n) + 0.2 * (labels == 0)).astype(np.float32)[:, None, None]
    return mod.ArrayDataset([f"u{seed}_{i}" for i in range(n)], feats, labels)


def _init(train):
    """The JAX fit's init: ``split(key(seed))[0]`` on the first bonafide row."""
    init_key, _ = jax.random.split(jax.random.key(0))
    x0 = jnp.transpose(jnp.asarray(train.filter_label(1).features[:1]), (0, 2, 1))
    variables = jbuild("cae", base_channels=BC).init({"params": init_key, "dropout": init_key}, x0)
    return jax.tree.map(np.asarray, variables)


def _cfg(mod, **kw):
    # plateau patience 0 and early stop 1: epoch 2's validation MSE rises on this corpus, so the
    # second epoch both halves the learning rate and ends the fit
    base = dict(batch_size=B, epochs=3, lr=LR, base_channels=BC, seed=0, lr_scheduler_patience=0, early_stop=1)
    return mod.CAEConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_cae")
    train, dev = _corpus(jpipe, N_TRAIN, 1), _corpus(jpipe, N_DEV, 2)
    variables = _init(train)
    norm = jnorm.build_normalizer(train.features, train.labels)
    mean, std = jnp.asarray(norm.mean), jnp.asarray(norm.std)

    # one step on the first B bonafide rows
    trainer = jloop.CAETrainer(_cfg(jloop))
    model, tx = trainer.model, trainer.tx
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = TrainState(params=params, batch_stats=stats, opt_state=tx.init(params), key=jax.random.key(0))
    feats = jnp.asarray(train.filter_label(1).features[:B])
    weights = jnp.ones(B, jnp.float32)
    x = (jnp.transpose(feats, (0, 2, 1)) - mean) / std

    def loss_fn(p):
        (recon, _), _ = model.apply({"params": p, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return jnp.mean(j_mse(recon, x))

    grads = jax.grad(loss_fn)(params)
    new, loss_sum, count = jloop.make_cae_train_step(model, tx, mean, std)(state, feats, weights)
    one_step = {
        "loss": float(loss_sum) / float(count), "grads": jax.tree.map(np.asarray, grads),
        "after": jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
    }

    result = trainer.fit(train, dev, checkpoint_dir=str(root))
    return {"variables": variables, "one_step": one_step, "history": result["history"], "root": root,
            "best": result["best_val_mse"]}


def test_one_train_step_matches_jax(jax_runs):
    want = jax_runs["one_step"]
    train = _corpus(tpipe, N_TRAIN, 1)
    trainer = tloop.CAETrainer(_cfg(tloop), device="cpu")
    trainer.init_state(state_dict_from_jax(jax_runs["variables"], "cae"))
    trainer.use_normalizer(tnorm.build_normalizer(train.features, train.labels))
    loss_sum, count = trainer.train_step(torch.from_numpy(train.filter_label(1).features[:B]), torch.ones(B))
    np.testing.assert_allclose(float(loss_sum) / float(count), want["loss"], rtol=1e-5)

    grads = params_from_jax(want["grads"], "cae")
    g_max = max(float(g.abs().max()) for g in grads.values())
    before = state_dict_from_jax(jax_runs["variables"], "cae")
    after_jax = state_dict_from_jax(want["after"], "cae")
    after = trainer.model.state_dict()
    for name, p in trainer.model.named_parameters():
        g_want = grads[name].numpy()
        if name in PRE_BN_BIASES:  # 0 in exact arithmetic: rounding noise on each side
            assert max(np.abs(g_want).max(), p.grad.abs().max().item()) <= 1e-5 * g_max, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=1e-4, atol=1e-6 * g_max, err_msg=name)
        big = np.abs(g_want) > 1e-6
        np.testing.assert_allclose(after[name].numpy()[big], after_jax[name].numpy()[big], atol=1e-6, err_msg=name)
        assert np.abs(after[name].numpy() - before[name].numpy()).max() <= 2 * LR
        assert np.abs(after_jax[name].numpy() - before[name].numpy()).max() <= 2 * LR
    for name in after:
        if "running" in name:
            np.testing.assert_allclose(after[name].numpy(), after_jax[name].numpy(), atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def torch_fits(jax_runs, tmp_path_factory):
    out = {}
    for resident in (False, True):
        root = tmp_path_factory.mktemp(f"torch_cae_{resident}")
        trainer = tloop.CAETrainer(_cfg(tloop, device_resident=resident), device="cpu")
        trainer.init_state(state_dict_from_jax(jax_runs["variables"], "cae"))
        result = trainer.fit(_corpus(tpipe, N_TRAIN, 1), _corpus(tpipe, N_DEV, 2), checkpoint_dir=str(root))
        out[resident] = (trainer, result, root)
    return out


def test_two_epochs_match_jax_trainer_with_a_plateau_step_and_an_early_stop(jax_runs, torch_fits):
    _, result, _ = torch_fits[False]
    got, want = result["history"], jax_runs["history"]
    assert [m.epoch for m in got] == [m.epoch for m in want] == [1, 2]  # early stop after epoch 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=1e-3)
        np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=1e-3)
        assert (g.is_best, g.epochs_no_improve, g.learning_rate) == (w.is_best, w.epochs_no_improve,
                                                                      w.learning_rate)
    assert [m.learning_rate for m in got] == [LR, LR / 2]  # the plateau step
    assert [m.is_best for m in got] == [True, False]
    # the rise the decisions rest on is far above the tolerance
    assert got[1].dev_loss > got[0].dev_loss * (1 + 1e-4)
    np.testing.assert_allclose(result["best_val_mse"], jax_runs["best"], rtol=1e-3)


@pytest.mark.parametrize("mode", ["chunked", "fused"])
def test_chunked_and_fused_fits_match_jax_trainer(jax_runs, mode):
    """The chunked feed (chunks of 2 batches; the JAX package's chunked fit
    equals its host-fed one up to XLA reassociation, ``tests/test_chunked.py``)
    and fit_fused (the resident fit with no display), from the JAX init, against
    the JAX fit: the same epochs, plateau step and stop."""
    trainer = tloop.CAETrainer(_cfg(tloop, resident_chunk_batches=2 if mode == "chunked" else 0), device="cpu")
    trainer.init_state(state_dict_from_jax(jax_runs["variables"], "cae"))
    fit = trainer.fit if mode == "chunked" else trainer.fit_fused
    result = fit(_corpus(tpipe, N_TRAIN, 1), _corpus(tpipe, N_DEV, 2))
    got, want = result["history"], jax_runs["history"]
    assert [m.epoch for m in got] == [m.epoch for m in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=1e-3)
        np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=1e-3)
        assert (g.is_best, g.epochs_no_improve, g.learning_rate) == (w.is_best, w.epochs_no_improve,
                                                                      w.learning_rate)
    np.testing.assert_allclose(result["best_val_mse"], jax_runs["best"], rtol=1e-3)


def test_device_resident_fit_equals_host_fed(torch_fits):
    host, resident = torch_fits[False], torch_fits[True]
    for a, b in zip(host[1]["history"], resident[1]["history"]):
        assert (a.train_loss, a.dev_loss, a.learning_rate, a.is_best) == (b.train_loss, b.dev_loss,
                                                                           b.learning_rate, b.is_best)
    for k, v in host[0].model.state_dict().items():
        torch.testing.assert_close(resident[0].model.state_dict()[k], v, rtol=0, atol=0)


def test_artifacts_match_jax_and_cross_packages(jax_runs, torch_fits):
    trainer, result, root = torch_fits[False]
    jroot = jax_runs["root"]
    for name in ("cae_best.ckpt", "cae_last.ckpt", "normalizer.npz"):
        assert (root / name).exists() and (jroot / name).exists()
    with np.load(root / "normalizer.npz") as got, np.load(jroot / "normalizer.npz") as want:
        for key in ("mean", "std"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    with open(root / "cae_best.ckpt", "rb") as f:
        best = pickle.load(f)  # plain pickle: numpy arrays and builtins only
    assert best["epoch"] == 1 and best["optimizer_state"] is None and best["torch_optimizer_state"]["state"]
    assert best["scheduler_state"] == {**best["scheduler_state"], "num_bad_epochs": 0}  # before epoch 1's step
    last = tckpt.load_checkpoint(str(root / "cae_last.ckpt"))
    assert last["epoch"] == 2 and "scheduler_state" not in last
    assert last["torch_optimizer_state"]["param_groups"][0]["lr"] == LR / 2

    # the port's best checkpoint, served by both packages
    dev_j, dev_t = _corpus(jpipe, N_DEV, 2), _corpus(tpipe, N_DEV, 2)
    jvars = jckpt.load_model_variables(str(root / "cae_best.ckpt"), model_name="cae")
    jrep = jloop.evaluate_cae(jbuild("cae", base_channels=BC), jvars, dev_j,
                              jnorm.FeatureNormalizer.load(str(root / "normalizer.npz")), B)
    model = trainer.model.__class__(base_channels=BC)
    model.load_state_dict(tckpt.load_model_variables(str(root / "cae_best.ckpt"), model_name="cae"))
    trep = tloop.evaluate_cae(model, dev_t, tnorm.FeatureNormalizer.load(str(root / "normalizer.npz")), B)
    assert trep["eer"] == jrep["eer"] and trep["convention"] == jrep["convention"]
    assert 0.0 < trep["eer"] < 0.5
    np.testing.assert_allclose(trep["scores"], jrep["scores"], rtol=1e-5)
    # the best epoch's validation MSE is the mean of its bonafide scores
    np.testing.assert_allclose(trep["scores"][dev_t.labels == 1].mean(), result["best_val_mse"], rtol=1e-6)


def test_loaded_normalizer_is_used_and_saved(jax_runs, tmp_path):
    train = _corpus(tpipe, N_TRAIN, 1)
    norm = tnorm.FeatureNormalizer(mean=np.full(F_, 0.1, np.float32), std=np.full(F_, 2.0, np.float32))
    trainer = tloop.CAETrainer(_cfg(tloop, epochs=1), device="cpu")
    trainer.init_state(state_dict_from_jax(jax_runs["variables"], "cae"))
    result = trainer.fit(train, _corpus(tpipe, N_DEV, 2), checkpoint_dir=str(tmp_path), normalizer=norm)
    assert result["normalizer"] is norm
    saved = tnorm.FeatureNormalizer.load(str(tmp_path / "normalizer.npz"))
    np.testing.assert_array_equal(saved.mean, norm.mean)
    np.testing.assert_array_equal(saved.std, norm.std)


def test_train_cae_cli_final_line_matches_the_jax_cli(jax_runs, tmp_path, capsys, monkeypatch):
    """Both CLIs on one corpus; the port's trainer starts from the JAX
    CLI's init (the two packages draw their inits differently)."""
    import pandas as pd

    from dfac_tpu.cli import train_cae as jcli
    from dfac_tpu_torch.cli import train_cae as tcli

    paths = []
    for name, n, seed in (("train", N_TRAIN, 1), ("dev", N_DEV, 2)):
        ds = _corpus(jpipe, n, seed)
        f, lab = str(tmp_path / f"{name}_f.pkl"), str(tmp_path / f"{name}_l.pkl")
        pd.DataFrame({"uttid": ds.uttids, "features": [torch.from_numpy(m) for m in ds.features]}).to_pickle(f)
        pd.DataFrame({"uttid": ds.uttids, "label": ds.labels.astype(np.int64)}).to_pickle(lab)
        paths += [f"--{name}-features", f, f"--{name}-labels", lab]
    flags = [*paths, "--epochs", "3", "--batch-size", str(B), "--base-channels", str(BC),
             "--lr-scheduler-patience", "0", "--early-stop", "1", "--no-rich"]
    jcli.main([*flags, "--checkpoint-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().out.strip().splitlines()

    init_state = tloop.CAETrainer.init_state
    monkeypatch.setattr(tloop.CAETrainer, "init_state", lambda self, sd=None: init_state(
        self, sd if sd is not None else state_dict_from_jax(jax_runs["variables"], "cae")))
    for extra in ((), ("--device-resident",)):
        out = str(tmp_path / f"port{len(extra)}")
        tcli.main([*flags, "--checkpoint-dir", out, "--device", "cpu", *extra])
        got = capsys.readouterr().out.strip().splitlines()
        prefix = "best val reconstruction MSE: "
        assert got[-1].startswith(prefix) and want[-1].startswith(prefix)
        np.testing.assert_allclose(float(got[-1][len(prefix):]), float(want[-1][len(prefix):]), rtol=1e-3)
        # the plain dashboard's lines: one an epoch, early stop, best
        assert [ln.split()[:2] for ln in got if ln.startswith("  epoch")] == [["epoch", "1"], ["epoch", "2"]]
        assert any(ln.startswith("Early stopping at epoch 2") for ln in got)
        for name in ("cae_best.ckpt", "cae_last.ckpt", "normalizer.npz"):
            assert (tmp_path / f"port{len(extra)}" / name).exists()
