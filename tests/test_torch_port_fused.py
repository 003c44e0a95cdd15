"""The fused fit and the BatchNorm freeze tail in the PyTorch port.

Fused (``dfac_tpu_torch.train.fused_fit``): the seven cases of
``tests/test_fused_fit.py``, held to the port's per-epoch resident ``fit``
(a fused run is that fit with no display and no checkpoint written): the
histories, the final and the best variables are equal (``==``,
``torch.equal``), the best rule, plateau, early stop, resume and the
unset best of a resume that never improves are the JAX fused entry
point's. The CAE's fused fit against the JAX CAE trainer's fit
and CNN2D's (the JAX fused programs shuffle on the device; ``ROADMAP.md``
§3.3) sit beside their JAX fits in ``tests/test_torch_port_cae_train.py``
and ``tests/test_torch_port_train.py``; the detector's fused fit runs here
against the JAX ``fit_fused`` itself, from the JAX init: losses rtol 1e-3,
the dev EER equal.

Freeze (``models.common.frozen_batchnorm``): ``tests/test_alt_trainer_fast.py``
and the freeze cases of ``tests/test_train.py``. The frozen step of CNN2D,
the CAE and the detector against the JAX ``bn_frozen=True`` step on the
same weights and batch at ``tests/test_torch_port_train.py``'s step
tolerances (loss rtol 1e-5, parameters 1e-6 where |g| > 1e-6 and within
2 * lr elsewhere), BatchNorm statistics unchanged bit for bit; the boundary
``epoch > round(epochs * frac)`` (half to even) in the host-fed, resident,
chunked and fused modes of all three trainers; ``--train-fast`` per CLI;
the JAX package's ``TypeError`` for a model without ``bn_frozen``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfac_tpu.cli import train as jtrain_cli
from dfac_tpu.cli import train_cae as jcae_cli
from dfac_tpu.cli import train_detector as jdet_cli
from dfac_tpu.data import pipeline as jpipe
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.train import cae_loop as jcae
from dfac_tpu.train import detector_loop as jdet
from dfac_tpu.train import loop as jloop
from dfac_tpu.train.loop import TrainState
from dfac_tpu.train.optim import build_optimizer as jbuild_optimizer
from dfac_tpu_torch.cli import train as ttrain_cli
from dfac_tpu_torch.cli import train_cae as tcae_cli
from dfac_tpu_torch.cli import train_detector as tdet_cli
from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models.common import frozen_batchnorm
from dfac_tpu_torch.train import cae_loop as tcae
from dfac_tpu_torch.train import checkpoint as tckpt
from dfac_tpu_torch.train import detector_loop as tdet
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.train.evaluate import evaluate_classifier
from dfac_tpu_torch.utils.convert import params_from_jax, state_dict_from_jax


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These fits are tiny (16-24 features): one thread a process runs them
    fastest, alone or beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ds(mod, seed, n=48, f=16, t=24, shift=2.0, lengths=False):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, f, t)).astype(np.float32)
    feats[labels == 1, : f // 2] += shift
    lens = None
    if lengths:
        lens = rng.integers(t // 2, t + 1, size=n).astype(np.int32)
        for i, ln in enumerate(lens):
            feats[i, :, ln:] = 0.0
    return mod.ArrayDataset([f"u{seed}_{i}" for i in range(n)], feats, labels, lengths=lens)


def _cfg(**kw):
    base = dict(model="cnn1d", batch_size=16, epochs=3, lr=2e-3, seed=4, in_features=16, device_resident=True,
                label_smoothing=0.05, lr_scheduler="plateau", lr_scheduler_patience=0)
    return tloop.TrainConfig(**{**base, **kw})


def _trainer(**kw):
    return tloop.Trainer(_cfg(**kw), device="cpu")


def _same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _rows(history):
    return [(m.epoch, m.train_loss, m.dev_loss, m.dev_eer, m.is_best, m.improved, m.epochs_no_improve,
             m.learning_rate) for m in history]


def _trainer_state(trainer, r):
    return {"best_eer": r["best_eer"], "best_train_loss": r["best_train_loss"], "best_dev_loss": r["best_dev_loss"],
            "epochs_no_improve": r["epochs_no_improve"], "lr": trainer._lr}


# -- the seven cases of tests/test_fused_fit.py --------------------------------------------


@pytest.mark.parametrize("model", ["cnn1d", "cnn2d"])
def test_fused_fit_equals_per_epoch_trainer(model):
    train_ds, dev_ds = _ds(tpipe, 0), _ds(tpipe, 1, n=22)  # a ragged dev tail
    ref_t, got_t = _trainer(model=model), _trainer(model=model)
    ref, got = ref_t.fit(train_ds, dev_ds), got_t.fit_fused(train_ds, dev_ds)
    assert _rows(got["history"]) == _rows(ref["history"])
    assert [m.learning_rate for m in got["history"]] == [2e-3, 1e-3, 5e-4]  # the plateau ran
    for key in ("best_eer", "best_train_loss", "best_dev_loss"):
        assert got[key] == ref[key]
    _same_state(got_t.model.state_dict(), ref_t.model.state_dict())
    _same_state(got_t.best_variables(), ref_t.best_variables())
    assert got_t._lr == ref_t._lr and got_t.scheduler == ref_t.scheduler


def test_fused_fit_early_stop():
    train_ds, dev_ds = _ds(tpipe, 2, n=16), _ds(tpipe, 3, n=16)
    cfg = dict(epochs=20, lr=0.0, early_stop=2, lr_scheduler="none")
    got = _trainer(**cfg).fit_fused(train_ds, dev_ds)
    ref = _trainer(**cfg).fit(train_ds, dev_ds)
    # lr = 0: epoch 1 sets the best, two epochs without a better EER stop the run
    assert len(got["history"]) <= 4 and _rows(got["history"]) == _rows(ref["history"])
    assert got["epochs_no_improve"] == 2


def test_fused_best_snapshot_matches_per_epoch_best_checkpoint(tmp_path):
    """Weakly separable data: the dev EER is best at epoch 1, so the best
    snapshot precedes the last epoch and must hold epoch 1's parameters
    and BatchNorm statistics, as the per-epoch best checkpoint does."""
    train_ds, dev_ds = _ds(tpipe, 26, shift=0.1), _ds(tpipe, 46, n=22, shift=0.1)
    cfg = dict(lr_scheduler="none")
    ref_t = _trainer(**cfg)
    ref = ref_t.fit(train_ds, dev_ds, checkpoint_dir=str(tmp_path))
    ref_best = tckpt.load_model_variables(str(tmp_path / "cnn1d_best.ckpt"), "cnn1d")
    ref_best_epoch = max(m.epoch for m in ref["history"] if m.is_best)
    fused = _trainer(**cfg)
    got = fused.fit_fused(train_ds, dev_ds)
    best = fused.best_variables()
    assert ref_best_epoch < ref["history"][-1].epoch  # the scenario holds
    assert got["best_epoch"] == ref_best_epoch
    assert (got["best_train_loss"], got["best_dev_loss"]) == (ref["best_train_loss"], ref["best_dev_loss"])
    _same_state(best, ref_t.best_variables())
    for k, v in ref_best.items():  # the checkpoint's layout has no num_batches_tracked
        assert torch.equal(best[k], v) or k.endswith("num_batches_tracked"), k
    final = fused.model.state_dict()
    assert any(not torch.equal(best[k], final[k]) for k in final if "running" in k)  # the statistics moved on


def test_fused_resume_continues_run(tmp_path):
    """2 epochs, a checkpoint, 2 more resumed == one 4-epoch fused run
    (dropout 0: the generator is not in the checkpoint)."""
    train_ds, dev_ds = _ds(tpipe, 9), _ds(tpipe, 10, n=22)
    ckpt = str(tmp_path / "resume.ckpt")
    t1 = _trainer(epochs=2, dropout=0.0)
    r1 = t1.fit_fused(train_ds, dev_ds)
    t1._save(ckpt, r1["history"][-1].epoch, None, _trainer_state(t1, r1))
    t2, tc = _trainer(epochs=4, dropout=0.0), _trainer(epochs=4, dropout=0.0)
    r2 = t2.fit_fused(train_ds, dev_ds, resume_from=ckpt)
    rc = tc.fit_fused(train_ds, dev_ds)
    assert [m.epoch for m in r2["history"]] == [3, 4]
    for a, b in zip(r2["history"], rc["history"][2:]):
        assert (a.train_loss, a.dev_loss, a.dev_eer, a.learning_rate) == (b.train_loss, b.dev_loss, b.dev_eer,
                                                                          b.learning_rate)
    for k, v in tc.model.state_dict().items():  # the checkpoint's layout has no num_batches_tracked
        assert torch.equal(t2.model.state_dict()[k], v) or k.endswith("num_batches_tracked"), k
    assert r2["best_eer"] == rc["best_eer"]


def test_fused_fit_best_variables_score_the_best_eer():
    train_ds, dev_ds = _ds(tpipe, 5), _ds(tpipe, 6, n=24)
    trainer = _trainer(epochs=2, lr_scheduler="none")
    got = trainer.fit_fused(train_ds, dev_ds)
    best = trainer.best_variables()
    assert got["best_variables"] is best
    model = tbuild("cnn1d", in_features=16)
    model.load_state_dict(best)
    metrics, _, _ = evaluate_classifier(model, dev_ds, batch_size=16, label_smoothing=0.05)
    assert metrics["eer"] == got["best_eer"]


def test_fused_resume_already_complete_is_a_noop(tmp_path, capsys):
    """A resume whose checkpoint reached --epochs trains nothing, reports no
    best, and the CLI rewrites neither checkpoint."""
    train_ds, dev_ds = _ds(tpipe, 10), _ds(tpipe, 11, n=22)
    t1 = _trainer(epochs=2)
    r1 = t1.fit_fused(train_ds, dev_ds)
    ckpt = str(tmp_path / "done.ckpt")
    t1._save(ckpt, r1["history"][-1].epoch, None, _trainer_state(t1, r1))
    t2 = _trainer(epochs=2)
    r2 = t2.fit_fused(train_ds, dev_ds, resume_from=ckpt)
    assert r2["history"] == [] and r2["best_variables"] is None and t2._best_state is None
    root = tmp_path / "cli"
    ttrain_cli._save_fused(t2, r2, str(root), ttrain_cli.parse_args(["--model", "cnn1d"]), {})
    assert os.listdir(root) == []


def test_fused_resume_without_improvement_keeps_the_best_unset(tmp_path):
    train_ds, dev_ds = _ds(tpipe, 12), _ds(tpipe, 13, n=22)
    t1 = _trainer(epochs=3)
    r1 = t1.fit_fused(train_ds, dev_ds)
    ckpt = str(tmp_path / "r1.ckpt")
    t1._save(ckpt, 3, None, {**_trainer_state(t1, r1), "epochs_no_improve": 3, "lr": 0.0})
    t2 = _trainer(epochs=5, lr=0.0)  # lr 0: the resumed epochs cannot improve the best
    r2 = t2.fit_fused(train_ds, dev_ds, resume_from=ckpt)
    assert [m.epoch for m in r2["history"]] == [4, 5] and not any(m.is_best for m in r2["history"])
    assert r2["best_variables"] is None and t2._best_state is None
    assert r2["best_eer"] == r1["best_eer"] and r2["best_epoch"] == 3  # the resumed checkpoint's, as JAX
    assert r2["epochs_no_improve"] == 5


# -- the CAE's and the detector's fused fits ----------------------------------------------

CF, CT = 16, 20


def _cae_cfg(mod, **kw):
    base = dict(batch_size=8, epochs=3, base_channels=4, lr=1e-3, seed=2, lr_scheduler_patience=0, early_stop=2)
    return mod.CAEConfig(**{**base, **kw})


def test_cae_fused_fit_equals_per_epoch_resident(tmp_path):
    """History, final and best weights, and the artifacts: cae_best.ckpt
    holds the best epoch's weights, AdamW state and the scheduler before
    that epoch's plateau step, as fit() writes it."""
    train, dev = _ds(tpipe, 7, n=30, f=CF, t=CT, shift=0.3), _ds(tpipe, 8, n=16, f=CF, t=CT, shift=0.3)
    ref_t = tcae.CAETrainer(_cae_cfg(tcae, device_resident=True, bn_freeze_after_frac=0.5), device="cpu")
    got_t = tcae.CAETrainer(_cae_cfg(tcae, bn_freeze_after_frac=0.5), device="cpu")
    ref = ref_t.fit(train, dev, checkpoint_dir=str(tmp_path / "ref"))
    got = got_t.fit_fused(train, dev, checkpoint_dir=str(tmp_path / "got"))
    assert _rows(got["history"]) == _rows(ref["history"]) and got["best_val_mse"] == ref["best_val_mse"]
    _same_state(got_t.model.state_dict(), ref_t.model.state_dict())
    assert got_t._lr == ref_t._lr and got_t.scheduler == ref_t.scheduler
    for name in ("cae_best.ckpt", "cae_last.ckpt"):
        a, b = (tckpt.load_checkpoint(str(tmp_path / d / name)) for d in ("ref", "got"))
        assert a["epoch"] == b["epoch"] and a.get("scheduler_state") == b.get("scheduler_state")
        for k, v in a["model_state"]["params"].items():
            jax.tree.map(np.testing.assert_array_equal, v, b["model_state"]["params"][k])
        oa, ob = a["torch_optimizer_state"], b["torch_optimizer_state"]
        assert oa["param_groups"] == ob["param_groups"]
        jax.tree.map(np.testing.assert_array_equal, oa["state"], ob["state"])
    with np.load(tmp_path / "got" / "normalizer.npz") as n:
        np.testing.assert_array_equal(n["mean"], got["normalizer"].mean)


def _det_cfg(mod, **kw):
    base = dict(batch_size=8, epochs=3, hidden=8, dropout=0.0, encoder_dropout=0.0, ema=True, ema_decay=0.9,
                lr=1e-3, seed=3, patience=1)
    return mod.DetectorConfig(**{**base, **kw})


def _det_data(mod):
    return (_ds(mod, 3, n=26, f=CF, t=CT, shift=0.4, lengths=True),
            _ds(mod, 4, n=16, f=CF, t=CT, shift=0.4, lengths=True))


@pytest.mark.parametrize("kw", [dict(), dict(bn_freeze_after_frac=0.5, patience=10, dropout=0.3, specaug=True)],
                         ids=["patience", "freeze"])
def test_detector_fused_fit_equals_per_epoch_resident(kw, tmp_path):
    train, dev = _det_data(tpipe)
    ref_t = tdet.DetectorTrainer(_det_cfg(tdet, device_resident=True, **kw), in_channels=CF, device="cpu")
    got_t = tdet.DetectorTrainer(_det_cfg(tdet, **kw), in_channels=CF, device="cpu")
    ref = ref_t.fit(train, dev, ckpt_path=str(tmp_path / "ref.ckpt"))
    got = got_t.fit_fused(train, dev, ckpt_path=str(tmp_path / "got.ckpt"))
    assert got == ref
    _same_state(got_t.eval_variables(), ref_t.eval_variables())
    a, b = (tckpt.load_checkpoint(str(tmp_path / f"{n}.ckpt")) for n in ("ref", "got"))
    assert a["epoch"] == b["epoch"]
    jax.tree.map(np.testing.assert_array_equal, a["model_state"], b["model_state"])


def test_detector_fused_fit_matches_jax_fit_fused():
    """The JAX ``fit_fused`` and the port's, from the JAX init: the same
    (epochs, N) weighted orders, EMA eval variables (the patience path is
    held to the per-epoch fit above)."""
    want = jdet.DetectorTrainer(_det_cfg(jdet, epochs=2, patience=10), in_channels=CF).fit_fused(*_det_data(jpipe))
    init_key, _ = jax.random.split(jax.random.key(3))
    init = jax.jit(jbuild("detector", in_channels=CF, hidden=8, dropout=0.0, encoder_dropout=0.0).init)(
        {"params": init_key, "dropout": init_key}, jnp.zeros((1, CT, CF)))
    trainer = tdet.DetectorTrainer(_det_cfg(tdet, epochs=2, patience=10), in_channels=CF, device="cpu")
    trainer.init_state(state_dict_from_jax(jax.tree.map(np.asarray, init), "detector"))
    got = trainer.fit_fused(*_det_data(tpipe))
    assert [h["epoch"] for h in got["history"]] == [h["epoch"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-3)
        np.testing.assert_allclose(g["dev_eer"], w["dev_eer"], rtol=1e-6)  # JAX's EER is an f32 quotient
    assert got["best_eer"] == pytest.approx(want["best_eer"], rel=1e-6)


# -- the frozen step against JAX's bn_frozen=True step -------------------------------------


def _random_stats(variables, seed):
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)
    for d in out["batch_stats"].values():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
    return out


def _check_step(trainer, before, after_jax, model_name, loss, want_loss, lr):
    """The step-parity tolerances; ``before`` is the port's state_dict
    before the step: BatchNorm's statistics and ``num_batches_tracked`` stay
    as they were, bit for bit (JAX's statistics too)."""
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    after = trainer.model.state_dict()
    want = state_dict_from_jax(after_jax, model_name)
    for name, p in trainer.model.named_parameters():
        big = np.abs(p.grad.numpy()) > 1e-6
        np.testing.assert_allclose(after[name].numpy()[big], want[name].numpy()[big], atol=1e-6, err_msg=name)
        assert np.abs(after[name].numpy() - before[name].numpy()).max() <= 2 * lr
    assert any(not torch.equal(after[n], before[n]) for n, _ in trainer.model.named_parameters())  # they train
    buffers = [n for n, _ in trainer.model.named_buffers()]
    assert any("running_var" in n for n in buffers)
    for name in buffers:
        assert torch.equal(after[name], before[name]), name
        if "running" in name:
            np.testing.assert_array_equal(want[name].numpy(), before[name].numpy(), err_msg=name)


def test_cnn2d_frozen_step_matches_jax():
    F, T, B, lr = 12, 16, 8, 1e-3
    model = jbuild("cnn2d", in_features=F, base_channels=4, dropout=0.0)
    variables = _random_stats(jax.jit(model.init)({"params": jax.random.key(0)}, jnp.zeros((1, T, F))), 1)
    ds = _ds(jpipe, 5, n=B, f=F, t=T, shift=0.5)
    tx = jbuild_optimizer("cnn2d", lr)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), key=jax.random.key(0))
    step = jloop.make_train_step(model, tx, swap_tf=True, label_smoothing=0.05, augment_fn=None, bn_frozen=True)
    labels = ds.labels.astype(np.float32)
    new, loss_sum, count = step(state, jnp.asarray(ds.features), jnp.asarray(labels), jnp.ones(B))
    trainer = tloop.Trainer(tloop.TrainConfig(model="cnn2d", batch_size=B, lr=lr, dropout=0.0, label_smoothing=0.05,
                                              in_features=F), device="cpu",
                            model=tbuild("cnn2d", in_features=F, base_channels=4, dropout=0.0))
    trainer.init_state(state_dict_from_jax(variables))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got_sum, got_count = trainer.train_step(torch.from_numpy(ds.features), torch.from_numpy(labels), torch.ones(B),
                                            frozen=True)
    after = jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats})
    _check_step(trainer, before, after, "cnn2d", float(got_sum) / float(got_count), float(loss_sum) / float(count),
                lr)
    assert trainer.model.training and all(m.training for m in trainer.model.modules())  # modes restored


def test_cae_frozen_step_matches_jax():
    B, lr = 4, 1e-3
    ds = _ds(jpipe, 6, n=2 * B, f=CF, t=CT, shift=0.3)
    jtrainer = jcae.CAETrainer(_cae_cfg(jcae, lr=lr))
    x0 = jnp.zeros((1, CT, CF))
    variables = _random_stats(jax.jit(jtrainer.model.init)({"params": jax.random.key(1)}, x0), 2)
    mean, std = np.float32(0.1), np.float32(1.3)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=jtrainer.tx.init(params), key=jax.random.key(0))
    feats = ds.features[:B]
    new, loss_sum, count = jcae.make_cae_train_step(jtrainer.model, jtrainer.tx, mean, std, bn_frozen=True)(
        state, jnp.asarray(feats), jnp.ones(B))
    trainer = tcae.CAETrainer(_cae_cfg(tcae, lr=lr), device="cpu")
    trainer.init_state(state_dict_from_jax(variables, "cae"))
    from dfac_tpu_torch.data.normalizer import FeatureNormalizer

    trainer.use_normalizer(FeatureNormalizer(mean=np.full(CF, mean), std=np.full(CF, std)))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got_sum, got_count = trainer.train_step(torch.from_numpy(feats), torch.ones(B), frozen=True)
    after = jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats})
    _check_step(trainer, before, after, "cae", float(got_sum) / float(got_count), float(loss_sum) / float(count), lr)
    assert any(k.startswith("decoder") and "running_mean" in k for k in trainer.model.state_dict())


def test_detector_frozen_step_with_ema_matches_jax():
    B, lr, decay = 8, 1e-3, 0.9
    ds = _ds(jpipe, 7, n=B, f=CF, t=CT, shift=0.4, lengths=True)
    cfg = _det_cfg(jdet, lr=lr, ema_decay=decay)
    model = jbuild("detector", in_channels=CF, hidden=8, dropout=0.0, encoder_dropout=0.0)
    variables = _random_stats(jax.jit(model.init)({"params": jax.random.key(2)}, jnp.zeros((1, CT, CF))), 3)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adamw(lr, weight_decay=cfg.weight_decay))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jdet.DetectorState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                               ema_params=params, opt_state=tx.init(params), key=jax.random.key(0))
    labels = ds.labels.astype(np.float32)
    new, loss = jdet.make_detector_train_step(model, tx, cfg, 1.5, bn_frozen=True)(
        state, jnp.asarray(ds.features), jnp.asarray(ds.lengths), jnp.asarray(labels))
    trainer = tdet.DetectorTrainer(_det_cfg(tdet, lr=lr, ema_decay=decay), in_channels=CF, device="cpu")
    trainer.init_state(state_dict_from_jax(variables, "detector"))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    got = trainer.train_step(torch.from_numpy(ds.features), torch.from_numpy(ds.lengths), torch.from_numpy(labels),
                             1.5, frozen=True)
    after = jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats})
    _check_step(trainer, before, after, "detector", float(got), float(loss), lr)
    ema_want = params_from_jax(jax.tree.map(np.asarray, new.ema_params), "detector")
    ema = trainer.eval_variables()
    for name, p in trainer.model.named_parameters():
        big = np.abs(p.grad.numpy()) > 1e-6
        np.testing.assert_allclose(ema[name].numpy()[big], ema_want[name].numpy()[big], atol=1e-7, err_msg=name)
    for name, v in trainer.model.state_dict().items():
        if "running" in name:
            assert torch.equal(ema[name], v)  # the eval variables keep the live (fixed) statistics


# -- the freeze boundary ----------------------------------------------------------------------


@pytest.mark.parametrize("epochs,frac", [(3, 0.5), (5, 0.5), (1, 0.5), (4, 0.25), (10, 0.25), (2, 1e-9), (4, 0.0)])
def test_boundary_rounds_half_to_even_as_jax(epochs, frac):
    want = [jloop.Trainer(jloop.TrainConfig(model="cnn1d", epochs=epochs, bn_freeze_after_frac=frac))._bn_frozen_at(e)
            for e in range(1, epochs + 1)]
    assert want == [bool(frac) and e > round(epochs * frac) for e in range(1, epochs + 1)]
    for trainer in (tloop.Trainer(tloop.TrainConfig(epochs=epochs, bn_freeze_after_frac=frac), device="cpu"),
                    tcae.CAETrainer(tcae.CAEConfig(epochs=epochs, bn_freeze_after_frac=frac), device="cpu"),
                    tdet.DetectorTrainer(tdet.DetectorConfig(epochs=epochs, bn_freeze_after_frac=frac), device="cpu")):
        assert [trainer._bn_frozen_at(e) for e in range(1, epochs + 1)] == want


def _stats(state: dict) -> dict:
    return {k: v.clone() for k, v in state.items() if "running" in k or "num_batches" in k}


MODES = {"host": {}, "resident": {"device_resident": True}, "chunked": {"resident_chunk_batches": 2}, "fused": {}}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("which", ["cnn2d", "cae", "detector"])
def test_freeze_tail_leaves_the_running_statistics(which, mode):
    """3 epochs at frac 0.5: round(1.5) = 2, so epoch 3 is frozen. Its
    statistics stay bit for bit where epoch 2 left them (the stats after 2
    epochs come from the same run stopped there), the parameters move."""
    def run(epochs):
        kw = dict(MODES[mode], epochs=epochs, bn_freeze_after_frac=0.5 if epochs == 3 else 0.0)
        if which == "cnn2d":
            t = tloop.Trainer(tloop.TrainConfig(model="cnn2d", batch_size=8, in_features=16, dropout=0.2, seed=1,
                                                **kw), device="cpu")
            data = (_ds(tpipe, 1, n=20), _ds(tpipe, 2, n=12))
        elif which == "cae":
            t = tcae.CAETrainer(_cae_cfg(tcae, early_stop=0, **kw), device="cpu")
            data = (_ds(tpipe, 3, n=20, f=CF, t=CT), _ds(tpipe, 4, n=12, f=CF, t=CT))
        else:
            t = tdet.DetectorTrainer(_det_cfg(tdet, patience=10, dropout=0.3, **kw), in_channels=CF, device="cpu")
            data = (_ds(tpipe, 5, n=20, f=CF, t=CT, lengths=True), _ds(tpipe, 6, n=12, f=CF, t=CT, lengths=True))
        (t.fit_fused if mode == "fused" else t.fit)(*data)
        return t.model.state_dict()

    two, three = run(2), run(3)
    for k, v in _stats(two).items():
        assert torch.equal(three[k], v), k
    assert any(not torch.equal(three[k], two[k]) for k in two if k not in _stats(two))


def test_freeze_from_the_start_keeps_the_init_statistics():
    """tests/test_alt_trainer_fast.py: a boundary at epoch 0 freezes every
    epoch; every BatchNorm's statistics end at their init, in each mode."""
    for mode, kw in MODES.items():
        t = tdet.DetectorTrainer(_det_cfg(tdet, bn_freeze_after_frac=1e-9, patience=10, **kw), in_channels=CF,
                                 device="cpu")
        (t.fit_fused if mode == "fused" else t.fit)(*_det_data(tpipe))
        for k, v in t.model.state_dict().items():
            if "running_mean" in k:
                assert torch.equal(v, torch.zeros_like(v)), (mode, k)
            elif "running_var" in k:
                assert torch.equal(v, torch.ones_like(v)), (mode, k)
            elif "num_batches" in k:
                assert int(v) == 0, (mode, k)


def test_train_fast_fused_switches_at_the_per_epoch_boundary():
    """tests/test_train.py::test_bn_freeze_fused_matches_per_epoch: CNN2D,
    4 epochs at frac 0.5, fused == per-epoch resident."""
    train, dev = _ds(tpipe, 14, n=40), _ds(tpipe, 15, n=24)
    cfg = dict(model="cnn2d", batch_size=16, epochs=4, in_features=16, seed=0, dropout=0.0, bn_freeze_after_frac=0.5,
               device_resident=True)
    ref_t = tloop.Trainer(tloop.TrainConfig(**cfg), device="cpu")
    got_t = tloop.Trainer(tloop.TrainConfig(**cfg), device="cpu")
    ref, got = ref_t.fit(train, dev), got_t.fit_fused(train, dev)
    assert _rows(got["history"]) == _rows(ref["history"])
    _same_state(got_t.model.state_dict(), ref_t.model.state_dict())


def test_frozen_batchnorm_helper():
    model = tbuild("cnn2d", in_features=8, base_channels=4, dropout=0.5)
    model.train()
    x = torch.randn(4, 10, 8)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with frozen_batchnorm(model):
        assert all(not m.training for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
        assert model.conv[4].training  # dropout stays in train mode
        out = model(x).sum()
        out.backward()
    assert all(m.training for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k  # running stats and num_batches_tracked
    assert model.conv[1].weight.grad is not None and model.conv[1].bias.grad.abs().sum() > 0
    with frozen_batchnorm(model, frozen=False):
        model(x)
    assert not torch.equal(model.conv[1].running_mean, before["conv.1.running_mean"])


def test_a_model_without_bn_frozen_raises_as_jax(tmp_path):
    """JAX ``model.apply(..., bn_frozen=True)`` raises TypeError for CNN1D
    and the zoo; ``train --bn-freeze-after`` trains the epochs before the
    boundary, then stops there with it; the fused run stops before any.
    The JAX trainer's frozen step raises it where it is traced: at the
    boundary epoch in ``fit``, up front in ``fit_fused``."""
    jm = jbuild("cnn1d", in_features=16)
    v = jax.jit(jm.init)({"params": jax.random.key(0)}, jnp.zeros((1, 24, 16)))
    with pytest.raises(TypeError, match="bn_frozen"):
        jm.apply(v, jnp.zeros((2, 24, 16)), train=True, bn_frozen=True, mutable=["batch_stats"],
                 rngs={"dropout": jax.random.key(0)})
    # the frozen step the JAX trainer builds at the boundary epoch (loop.py:482-498) fails as it is traced
    jt = jloop.Trainer(jloop.TrainConfig(model="meanpool_mlp", batch_size=8, in_features=16, bn_freeze_after_frac=0.5))
    jt.init_state(np.zeros((1, 16, 24), np.float32))
    with pytest.raises(TypeError, match="unexpected keyword argument 'bn_frozen'"):
        jt._frozen_train_step()(jt.state, jnp.zeros((2, 16, 24)), jnp.zeros(2), jnp.ones(2))
    train, dev = _ds(tpipe, 16, n=20), _ds(tpipe, 17, n=12)
    for name in ("cnn1d", "meanpool_mlp"):
        t = tloop.Trainer(tloop.TrainConfig(model=name, batch_size=8, epochs=2, in_features=16,
                                            bn_freeze_after_frac=0.5), device="cpu")
        with pytest.raises(TypeError, match="unexpected keyword argument 'bn_frozen'"):
            t.fit(train, dev, checkpoint_dir=str(tmp_path / name))
        assert tckpt.load_checkpoint(str(tmp_path / name / f"{name}_last.ckpt"))["epoch"] == 1
        with pytest.raises(TypeError, match="bn_frozen"):
            tloop.Trainer(t.cfg, device="cpu").fit_fused(train, dev)


# -- the CLIs ------------------------------------------------------------------------------

CLIS = {"train": (jtrain_cli, ttrain_cli), "train_cae": (jcae_cli, tcae_cli),
        "train_detector": (jdet_cli, tdet_cli)}
FAST = [["--train-fast"], ["--train-fast", "--bn-freeze-after", "0.8"], ["--train-fast", "--fused-fit"],
        ["--bn-freeze-after", "0.3"]]


@pytest.mark.parametrize("flags", FAST, ids=" ".join)
@pytest.mark.parametrize("cli", list(CLIS))
def test_train_fast_settings_equal_jax(cli, flags):
    jcli, tcli = CLIS[cli]
    want, got = jcli.parse_args(flags), tcli.parse_args(flags)
    for key in ("dropout", "encoder_dropout", "bn_freeze_after", "fused_fit"):
        assert getattr(got, key, None) == getattr(want, key, None), key


CONFLICTS = [["--fused-fit", "--resident-chunk-batches", "4"], ["--device-resident", "--resident-chunk-batches", "4"]]


@pytest.mark.parametrize("flags", CONFLICTS, ids=" ".join)
@pytest.mark.parametrize("cli", list(CLIS))
def test_conflicting_flags_error_as_jax(cli, flags, capsys):
    jcli, tcli = CLIS[cli]
    with pytest.raises(SystemExit) as want:
        jcli.parse_args(flags)
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        tcli.parse_args(flags)
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split(": error: ")[1] == want_err.split(": error: ")[1]


def test_chunk_ingest_without_chunks_raises_the_config_error(tmp_path):
    """The JAX CLIs have no parse-time check: the configuration refuses it
    (after the data is read in train and train_cae, before it in
    train_detector, as in JAX)."""
    import pandas as pd

    paths = []
    for name, seed in (("train", 1), ("dev", 2)):
        ds = _ds(tpipe, seed, n=8, f=CF, t=CT)
        f, lab = str(tmp_path / f"{name}_f.pkl"), str(tmp_path / f"{name}_l.pkl")
        pd.DataFrame({"uttid": ds.uttids, "features": [torch.from_numpy(m) for m in ds.features]}).to_pickle(f)
        pd.DataFrame({"uttid": ds.uttids, "label": ds.labels.astype(np.int64)}).to_pickle(lab)
        paths += [f"--{name}-features", f, f"--{name}-labels", lab]
    flags = ["--chunk-ingest", "int8", "--device", "cpu"]
    with pytest.raises(ValueError, match="needs resident_chunk_batches > 0"):
        ttrain_cli.main([*paths, *flags, "--checkpoint-dir", str(tmp_path / "a")])
    with pytest.raises(ValueError, match="needs resident_chunk_batches > 0"):
        tcae_cli.main([*paths, *flags, "--checkpoint-dir", str(tmp_path / "b")])
    with pytest.raises(ValueError, match="needs resident_chunk_batches > 0"):
        tdet_cli.main(["--data-dir", str(tmp_path / "missing"), *flags])
