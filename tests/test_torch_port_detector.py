"""The dlqueen detector in the PyTorch port against the JAX package.

A small detector (20 features, 40 frames, hidden 16) starts from the JAX
init carried across by ``state_dict_from_jax``. Dropout and SpecAugment
draw from different generators in the two packages, so the ops are held
on JAX's own draws and the step and the fits run with both dropouts at 0
and SpecAugment off. Tolerances: the eval forward atol 1e-5; the loss
rtol 1e-5 (``pos_weight_bce`` rtol 1e-6); the clipped grads rtol 1e-4 +
atol 1e-6 * max|g|; BN running statistics 1e-5; parameters and EMA
parameters after one step 1e-6 where |g| > 1e-6 (within 2 * lr
elsewhere: Adam's first step divides by |g|), as
``tests/test_torch_port_train.py``; two epochs' losses rtol 1e-3 and the
dev EER equal (host-fed and chunked); the folded chain f32 atol 1e-5, bf16
2e-2.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfac_tpu.data import augment as jaug
from dfac_tpu.data import pipeline as jpipe
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import detector as jdet
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.train import checkpoint as jckpt
from dfac_tpu.train import detector_loop as jloop
from dfac_tpu.utils.torch_import import torch_to_flax
from dfac_tpu_torch.data import augment as taug
from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import detector as tdet
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.ops import eer as teer
from dfac_tpu_torch.train import checkpoint as tckpt
from dfac_tpu_torch.train import detector_loop as tloop
from dfac_tpu_torch.utils.convert import jax_from_state_dict, params_from_jax, state_dict_from_jax

C_, T_, H, B = 20, 40, 16, 8
LR, CLIP, EMA_DECAY = 1e-3, 0.05, 0.9
N_TRAIN, N_DEV = 30, 24  # 30 at B=8 leaves a true-size tail of 6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These torch fits are tiny: one intra-op thread a process runs them
    fastest, alone or beside other test processes (module scope, so the
    module's fixtures run pinned too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(dropout=0.0):
    return jbuild("detector", in_channels=C_, hidden=H, dropout=dropout, encoder_dropout=dropout)


def _torch_model(variables=None):
    model = tbuild("detector", in_channels=C_, hidden=H, dropout=0.0, encoder_dropout=0.0)
    if variables is not None:
        model.load_state_dict(state_dict_from_jax(variables, "detector"))
    return model


def _init(seed=0):
    """The JAX fit's init: ``split(key(seed))[0]`` for params and dropout."""
    init_key, _ = jax.random.split(jax.random.key(seed))
    variables = _jax_model().init({"params": init_key, "dropout": init_key}, jnp.zeros((1, T_, C_)))
    return jax.tree.map(np.asarray, variables)


def _random_bn(variables, seed=5):
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)
    for d in out["batch_stats"].values():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
    return out


def _corpus(mod, n, seed):
    """Imbalanced labels (a third positive), varied lengths, pad frames zero."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 3 == 0).astype(np.int32)
    feats = rng.normal(size=(n, C_, T_)).astype(np.float32)
    feats[labels == 1, : C_ // 2] += 0.4
    lengths = rng.integers(T_ // 2, T_ + 1, size=n).astype(np.int32)
    for i, ln in enumerate(lengths):
        feats[i, :, ln:] = 0.0
    return mod.ArrayDataset([f"u{seed}_{i}" for i in range(n)], feats, labels, lengths=lengths)


# -- weights, model, pool ------------------------------------------------------


def test_state_dict_names_follow_torch_import_and_round_trip():
    variables = _init()
    model = _torch_model()
    sd = state_dict_from_jax(variables, "detector")
    assert list(sd) == list(model.state_dict())
    assert {k.rsplit(".", 1)[0] for k in sd} == {"enc.net.0", "enc.net.1", "enc.net.4", "enc.net.5", "enc.net.8",
                                                   "enc.net.9", "head.0", "head.3"}
    model.load_state_dict(sd)
    # the JAX package's own importer reads the port's state_dict (its .pt names)
    imported = torch_to_flax("detector", {k: v.numpy() for k, v in model.state_dict().items()})
    back = jax_from_state_dict(model.state_dict(), "detector")
    for tree in (imported, back):
        for want, got in zip(jax.tree.leaves(variables), jax.tree.leaves(jax.tree.map(np.asarray, tree))):
            np.testing.assert_array_equal(got, want)
        assert jax.tree.structure(jax.tree.map(np.asarray, tree)) == jax.tree.structure(variables)


def test_eval_forward_matches_jax_with_length_mask():
    variables = _random_bn(_init(3))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, T_, C_)).astype(np.float32)
    lengths = np.array([1, T_ // 2, T_, 7], np.int32)
    want = np.asarray(_jax_model().apply(variables, jnp.asarray(x), lengths=jnp.asarray(lengths)))
    model = _torch_model(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
        full = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    want_full = np.asarray(_jax_model().apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(full, want_full, atol=1e-5)
    assert got.dtype == np.float32 and got.shape == (4,)


def test_stats_pool_matches_jax_including_length_zero():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 9, 6)).astype(np.float32)
    lengths = np.array([0, 1, 4, 9, 12], np.int32)  # 0: the clamped denominator; 12 > T: every frame
    want = np.asarray(jdet.stats_pool(jnp.asarray(x), jnp.asarray(lengths)))
    got = tdet.stats_pool(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[0], np.concatenate([np.zeros(6), np.full(6, 1e-3)]).astype(np.float32))


# -- losses and augmentation ---------------------------------------------------------


@pytest.mark.parametrize("labels", [[1, 0, 0, 0], [0, 0, 0], [1, 1], [1, 0, 1, 0, 0]])
def test_class_weights_equal_jax(labels):
    labels = np.array(labels)
    assert tloop.compute_class_weights(labels) == jloop.compute_class_weights(labels)


def test_pos_weight_bce_matches_jax_and_torch():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=33) * 4).astype(np.float32)
    labels = (rng.random(33) > 0.7).astype(np.float32)
    want = np.asarray(jloop.pos_weight_bce_per(jnp.asarray(logits), jnp.asarray(labels), 2.5))
    got = tloop.pos_weight_bce_per(torch.from_numpy(logits), torch.from_numpy(labels), 2.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mean = float(tloop.pos_weight_bce(torch.from_numpy(logits), torch.from_numpy(labels), 2.5))
    np.testing.assert_allclose(mean, float(jloop.pos_weight_bce(jnp.asarray(logits), jnp.asarray(labels), 2.5)),
                               rtol=1e-6)
    ref = torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor([2.5]))(torch.from_numpy(logits),
                                                                    torch.from_numpy(labels))
    np.testing.assert_allclose(mean, float(ref), rtol=1e-6)


def _count_mask_draws(key, length, max_width, n):
    """The widths and start uniforms ``jaug._per_sample_count_mask`` draws."""
    widths, us = [], []
    for _ in range(n):
        kw, ks, key = jax.random.split(key, 3)
        widths.append(int(jax.random.randint(kw, (), 0, min(max_width, length) + 1)))
        us.append(float(jax.random.uniform(ks, ())))
    return widths, us


@pytest.mark.parametrize("tmax,tn,fmax,fn", [(30, 2, 24, 2), (8, 3, 6, 1), (50, 2, 40, 2), (0, 2, 5, 0)])
def test_dlqueen_spec_augment_equals_jax_on_its_draws(tmax, tn, fmax, fn):
    b, t, c = 6, T_, C_
    x = np.random.default_rng(7).normal(size=(b, t, c)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jaug.dlqueen_spec_augment(key, jnp.asarray(x), tmax, tn, fmax, fn))
    tw, tu, fw, fu = [], [], [], []
    for key_i in jax.random.split(key, b):
        kt, kf = jax.random.split(key_i)
        for (w, u), length, mx, n in (((tw, tu), t, tmax, tn), ((fw, fu), c, fmax, fn)):
            ws, us = _count_mask_draws(kt if length == t else kf, length, mx, n)
            w.append(ws)
            u.append(us)
    draws = [(torch.tensor(w, dtype=torch.int64).reshape(b, -1), torch.tensor(u, dtype=torch.float32).reshape(b, -1))
             for w, u in ((tw, tu), (fw, fu))]
    got = taug.dlqueen_spec_augment(torch.from_numpy(x), *draws).numpy()
    np.testing.assert_array_equal(got, want)
    if tn and tmax:
        assert (got == 0).any()


def test_dlqueen_draws_stay_in_range():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, T_, C_)
    (tw, tu), (fw, fu) = taug.draw_dlqueen_masks(gen, x, 30, 2, 24, 2)
    assert tw.shape == fw.shape == (64, 2) and tu.shape == fu.shape == (64, 2)
    assert int(tw.min()) >= 0 and int(tw.max()) <= 30 and int(fw.max()) <= min(24, C_)
    assert 0 <= float(tu.min()) and float(tu.max()) < 1
    y = taug.dlqueen_spec_augment(x, (tw, tu), (fw, fu))
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    assert not all(torch.equal(y[0], y[i]) for i in range(1, 64))  # per-sample masks


# -- one train step -----------------------------------------------------------------


def _jcfg(**kw):
    base = dict(epochs=2, batch_size=B, lr=LR, hidden=H, dropout=0.0, encoder_dropout=0.0, grad_clip=CLIP,
                ema=True, ema_decay=EMA_DECAY, seed=0, patience=6)
    return jloop.DetectorConfig(**{**base, **kw})


def _tcfg(**kw):
    base = dict(epochs=2, batch_size=B, lr=LR, hidden=H, dropout=0.0, encoder_dropout=0.0, grad_clip=CLIP,
                ema=True, ema_decay=EMA_DECAY, seed=0, patience=6)
    return tloop.DetectorConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_step():
    variables = _random_bn(_init(), 9)
    ds = _corpus(jpipe, N_TRAIN, 1)
    pos_weight = jloop.compute_class_weights(ds.labels)[0]
    feats, lens, labels = ds.features[:B], ds.lengths[:B], ds.labels[:B].astype(np.float32)
    model, cfg = _jax_model(), _jcfg()
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=cfg.weight_decay))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jloop.DetectorState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                ema_params=params, opt_state=tx.init(params), key=jax.random.key(0))
    x = jnp.transpose(jnp.asarray(feats), (0, 2, 1))

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats": state.batch_stats}, x, lengths=jnp.asarray(lens),
                                train=True, mutable=["batch_stats"])
        return jloop.pos_weight_bce(logits, jnp.asarray(labels), pos_weight)

    grads = jax.grad(loss_fn)(params)
    norm = float(optax.global_norm(grads))
    new, loss = jloop.make_detector_train_step(model, tx, cfg, pos_weight)(
        state, jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(labels))
    return {
        "variables": variables, "batch": (feats, lens, labels), "pos_weight": pos_weight, "loss": float(loss),
        "norm": norm, "clipped": jax.tree.map(lambda g: np.asarray(g) / norm * CLIP, grads),
        "after": jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
        "ema": jax.tree.map(np.asarray, {"params": new.ema_params, "batch_stats": new.batch_stats}),
    }


def test_one_train_step_with_ema_and_a_binding_clip_matches_jax(jax_step):
    want = jax_step
    assert want["norm"] > 4 * CLIP  # the clip binds
    trainer = tloop.DetectorTrainer(_tcfg(), in_channels=C_, device="cpu")
    trainer.init_state(state_dict_from_jax(want["variables"], "detector"))
    feats, lens, labels = (torch.from_numpy(a) for a in want["batch"])
    loss = trainer.train_step(feats, lens, labels, want["pos_weight"])
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)

    grads = params_from_jax(want["clipped"], "detector")
    g_max = max(float(g.abs().max()) for g in grads.values())
    got_norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in trainer.model.parameters())))
    np.testing.assert_allclose(got_norm, CLIP, rtol=1e-5)  # clipped to the bound
    before = state_dict_from_jax(want["variables"], "detector")
    after_jax = state_dict_from_jax(want["after"], "detector")
    ema_jax = state_dict_from_jax(want["ema"], "detector")
    after, ema = trainer.model.state_dict(), trainer.eval_variables()
    for name, p in trainer.model.named_parameters():
        g_want = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=1e-4, atol=1e-6 * g_max, err_msg=name)
        big = np.abs(g_want) > 1e-6
        for got_sd, want_sd in ((after, after_jax), (ema, ema_jax)):
            np.testing.assert_allclose(got_sd[name].numpy()[big], want_sd[name].numpy()[big], atol=1e-6,
                                       err_msg=name)
            assert np.abs(got_sd[name].numpy() - before[name].numpy()).max() <= 2 * LR
        # the EMA is decay * init + (1 - decay) * new
        np.testing.assert_allclose(ema[name].numpy(), EMA_DECAY * before[name].numpy()
                                   + (1 - EMA_DECAY) * after[name].numpy(), atol=1e-7, err_msg=name)
    for name in after:
        if "running" in name:
            np.testing.assert_allclose(after[name].numpy(), after_jax[name].numpy(), atol=1e-5, err_msg=name)
            torch.testing.assert_close(ema[name], after[name], rtol=0, atol=0)  # live statistics, not averaged


def test_clip_by_global_norm_is_optax():
    """Binding, not binding, and a norm of ~1e-4, where torch's
    ``clip_grad_norm_`` (``max_norm / (norm + 1e-6)``) would be 1% off."""
    rng = np.random.default_rng(8)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    for scale, max_norm in ((1.0, 0.5), (1.0, 100.0), (2e-5, 5e-5)):
        scaled = {k: (v * scale).astype(np.float32) for k, v in tree.items()}
        want, _ = optax.clip_by_global_norm(max_norm).update(jax.tree.map(jnp.asarray, scaled), None)
        got = [torch.from_numpy(scaled["a"].copy()), torch.from_numpy(scaled["b"].copy())]
        tloop.clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, (want["a"], want["b"])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# -- two epochs of fit -----------------------------------------------------------------


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Two epochs of the JAX fit and of the port's, host-fed and resident,
    from the JAX fit's own init, with checkpoints."""
    root = tmp_path_factory.mktemp("detector_fit")
    jtrain, jdev = _corpus(jpipe, N_TRAIN, 1), _corpus(jpipe, N_DEV, 2)
    jtrainer = jloop.DetectorTrainer(_jcfg(), in_channels=C_)
    jresult = jtrainer.fit(jtrain, jdev, ckpt_path=str(root / "jax.ckpt"))
    jscores = jtrainer.scores(jdev)
    out = {"jax": jresult, "jax_dev_scores": jscores, "root": root}
    for resident in (False, True):
        trainer = tloop.DetectorTrainer(_tcfg(device_resident=resident), in_channels=C_, device="cpu")
        trainer.init_state(state_dict_from_jax(_init(), "detector"))
        orders = []
        epoch = trainer.train_epoch

        def recording(ds, order, pos_weight, *frozen, epoch=epoch):
            orders.append(order.copy())
            return epoch(ds, order, pos_weight, *frozen)

        trainer.train_epoch = recording
        ckpt = str(root / f"port_{resident}.ckpt")
        result = trainer.fit(_corpus(tpipe, N_TRAIN, 1), _corpus(tpipe, N_DEV, 2), ckpt_path=ckpt)
        out["resident" if resident else "host"] = (trainer, result, orders, ckpt)
    return out


def test_two_epochs_match_jax_trainer(fits):
    _, result, orders, _ = fits["host"]
    want = fits["jax"]["history"]
    # the JAX fit's weighted draws, replayed with its numpy calls
    labels = _corpus(jpipe, N_TRAIN, 1).labels
    rng = np.random.default_rng(0)
    _, w0, w1 = jloop.compute_class_weights(labels)
    p = np.where(labels == 1, w1, w0).astype(np.float64)
    p /= p.sum()
    for order in orders:
        np.testing.assert_array_equal(order, rng.choice(N_TRAIN, size=N_TRAIN, replace=True, p=p))
    assert [h["epoch"] for h in result["history"]] == [h["epoch"] for h in want] == [1, 2]
    for got, w in zip(result["history"], want):
        np.testing.assert_allclose(got["train_loss"], w["train_loss"], rtol=1e-3)
        assert got["dev_eer"] == w["dev_eer"]
    assert result["best_eer"] == fits["jax"]["best_eer"]
    # the JAX EER search agrees with calculate_eer here (no tied minima, ROADMAP.md 3.4)
    jscores = fits["jax_dev_scores"]
    assert teer.calculate_eer(jscores, _corpus(jpipe, N_DEV, 2).labels)[0] == fits["jax"]["history"][-1]["dev_eer"]


def test_chunked_fit_matches_jax_trainer(fits):
    """The chunked feed (chunks of 2 batches of the weighted draws) from
    the JAX init against the JAX fit (the JAX package's chunked fit equals
    its host-fed one up to XLA reassociation, ``tests/test_chunked.py``), at
    the two-epoch tolerances; and equal to the port's host-fed fit."""
    trainer = tloop.DetectorTrainer(_tcfg(resident_chunk_batches=2), in_channels=C_, device="cpu")
    trainer.init_state(state_dict_from_jax(_init(), "detector"))
    result = trainer.fit(_corpus(tpipe, N_TRAIN, 1), _corpus(tpipe, N_DEV, 2))
    want = fits["jax"]["history"]
    assert [h["epoch"] for h in result["history"]] == [h["epoch"] for h in want] == [1, 2]
    for got, w in zip(result["history"], want):
        np.testing.assert_allclose(got["train_loss"], w["train_loss"], rtol=1e-3)
        assert got["dev_eer"] == w["dev_eer"]
    assert result["history"] == fits["host"][1]["history"]


def test_device_resident_fit_equals_host_fed(fits):
    host, resident = fits["host"], fits["resident"]
    assert resident[1]["history"] == host[1]["history"]
    for a, b in zip(host[2], resident[2]):
        np.testing.assert_array_equal(a, b)
    for k, v in host[0].eval_variables().items():
        torch.testing.assert_close(resident[0].eval_variables()[k], v, rtol=0, atol=0)


def test_port_checkpoint_holds_the_eval_variables_and_serves_in_jax(fits):
    trainer, result, _, ckpt = fits["host"]
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)  # plain pickle: numpy arrays and builtins only
    assert payload["format"] == "dfac_tpu.v1" and payload["optimizer_state"] is None
    best_epoch = max(h["epoch"] for h in result["history"] if h["dev_eer"] == result["best_eer"])
    assert payload["epoch"] <= best_epoch and payload["config"]["ema"] is True
    variables = jckpt.load_model_variables(ckpt, model_name="detector")
    dev = _corpus(jpipe, N_DEV, 2)
    scores = jloop.detector_scores(_jax_model(), variables, dev, dev.lengths, B)
    assert teer.eer_device(scores, dev.labels)[0] == result["best_eer"]
    if payload["epoch"] == result["history"][-1]["epoch"]:
        np.testing.assert_allclose(scores, trainer.scores(_corpus(tpipe, N_DEV, 2)), atol=1e-5)


def test_load_model_variables_reads_jax_pickles_and_reference_pt(fits, tmp_path):
    from test_torch_parity import TorchDetector

    jax_sd = tckpt.load_model_variables(str(fits["root"] / "jax.ckpt"), model_name="detector")
    model = _torch_model()
    model.load_state_dict(jax_sd)
    want = jckpt.load_model_variables(str(fits["root"] / "jax.ckpt"), model_name="detector")
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    jax.tree.leaves(jax_from_state_dict(model.state_dict(), "detector"))):
        np.testing.assert_array_equal(a, b)
    ref = TorchDetector(in_ch=C_, hidden=H)
    path = str(tmp_path / "dlqueen.pt")
    torch.save({"model_state_dict": ref.state_dict(), "epoch": 3}, path)
    sd = tckpt.load_model_variables(path, model_name="detector")
    model.load_state_dict(sd)
    x, lengths = torch.randn(3, T_, C_), torch.tensor([T_, 9, 1])
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x, lengths), ref.eval()(x.transpose(1, 2), lengths))


# -- the folded chain --------------------------------------------------------------------------


def test_folded_chain_matches_the_eval_model():
    variables = _random_bn(_init(4), 6)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(6, C_, T_)).astype(np.float32)  # stored (B, C, T)
    lengths = np.array([1, 5, T_ // 2, T_, 33, 2], np.int32)
    model = _torch_model(variables).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(feats).transpose(1, 2), torch.from_numpy(lengths)).numpy()
    want_jax = np.asarray(_jax_model().apply(variables, jnp.asarray(feats.transpose(0, 2, 1)),
                                             lengths=jnp.asarray(lengths)))
    folded = tfast.fold_detector(model.state_dict())
    for dt, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        got = tfast.detector_fast_scores(folded, torch.from_numpy(feats), torch.from_numpy(lengths),
                                         compute_dtype=dt).numpy()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=str(dt))
        np.testing.assert_allclose(got, want_jax, atol=atol, err_msg=str(dt))
    jfolded = jfast.fold_detector(jax.tree.map(jnp.asarray, variables))
    for name, v in folded.items():
        np.testing.assert_allclose(v.numpy(), np.transpose(np.asarray(jfolded[name]), (2, 1, 0)) if v.dim() == 3
                                   else np.asarray(jfolded[name]), rtol=1e-6, atol=1e-7, err_msg=name)
    probs = tfast.detector_fast_scores(folded, torch.from_numpy(feats).transpose(1, 2), torch.from_numpy(lengths),
                                       swap_tf=False, apply_sigmoid=True, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(probs, 1 / (1 + np.exp(-want)), atol=1e-6)


def test_detector_scores_fast_corpus_matches_detector_scores():
    variables = _random_bn(_init(5), 7)
    ds = _corpus(tpipe, 21, 9)  # a padded tail at B=8
    model = _torch_model(variables)
    slow = tloop.detector_scores(model, ds, ds.lengths, batch_size=B)
    fast = tfast.detector_scores_fast(model.state_dict(), ds, ds.lengths, torch.device("cpu"), batch_size=B,
                                      compute_dtype=torch.float32)
    assert fast.shape == slow.shape == (21,)
    np.testing.assert_allclose(fast, slow, atol=1e-5)
    jds = _corpus(jpipe, 21, 9)
    want = jloop.detector_scores(_jax_model(), jax.tree.map(jnp.asarray, variables), jds, jds.lengths, B,
                                 apply_sigmoid=True)
    np.testing.assert_allclose(tloop.detector_scores(model, ds, ds.lengths, B, apply_sigmoid=True), want, atol=1e-6)


# -- the train_detector CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """train / dev / test2 splits as the reference's pickles: per-utterance
    tensors of their true lengths (the loaders pad them and keep the
    lengths)."""
    import pandas as pd

    root = tmp_path_factory.mktemp("detector_data")
    for split, n, seed in (("train", N_TRAIN, 1), ("dev", N_DEV, 2), ("test2", 13, 3)):
        ds = _corpus(jpipe, n, seed)
        d = root / split
        d.mkdir()
        pd.DataFrame({"uttid": ds.uttids, "features": [torch.from_numpy(ds.features[i][:, : ds.lengths[i]].copy())
                                                       for i in range(n)]}).to_pickle(d / "features.pkl")
        pd.DataFrame({"uttid": ds.uttids, "label": ds.labels.astype(np.int64)}).to_pickle(d / "labels.pkl")
    return root


def _score_cli(module, data_dir, ckpt, out, *extra, device=True):
    module.main(["--data-dir", str(data_dir), "--epochs", "0", "--hidden", str(H), "--batch-size", str(B),
                 "--ckpt-path", str(ckpt), "--prediction-pkl", str(out), *extra, *(["--device", "cpu"] if device
                                                                                     else [])])
    import pandas as pd

    return pd.read_pickle(out)


def test_cli_scores_jax_checkpoints_as_the_jax_cli_does(fits, data_dir, tmp_path, capsys):
    from dfac_tpu.cli import train_detector as jcli
    from dfac_tpu_torch.cli import train_detector as tcli

    ckpt = fits["root"] / "jax.ckpt"
    want = _score_cli(jcli, data_dir, ckpt, tmp_path / "jax.pkl", device=False)
    want_lines = capsys.readouterr().out.strip().splitlines()
    for extra in ((), ("--fast",)):
        got = _score_cli(tcli, data_dir, ckpt, tmp_path / "port.pkl", *extra)
        got_lines = capsys.readouterr().out.strip().splitlines()
        assert list(got["uttid"]) == list(want["uttid"]) and len(got) == 13
        np.testing.assert_allclose(got["predictions"], want["predictions"], atol=1e-5, err_msg=str(extra))
        assert got_lines[-1] == want_lines[-1] and got_lines[-1].startswith("EER on split 'test2': ")
    jfast = _score_cli(jcli, data_dir, ckpt, tmp_path / "jax_fast.pkl", "--fast", device=False)
    np.testing.assert_allclose(got["predictions"], jfast["predictions"], atol=1e-5)
    bf16 = _score_cli(tcli, data_dir, ckpt, tmp_path / "bf16.pkl", "--fast", "--bf16")
    np.testing.assert_allclose(bf16["predictions"], want["predictions"], atol=2e-2)
    probs = _score_cli(tcli, data_dir, ckpt, tmp_path / "probs.pkl", "--use-prob")
    np.testing.assert_allclose(probs["predictions"], 1 / (1 + np.exp(-want["predictions"])), atol=1e-6)


def test_cli_trained_checkpoint_is_scored_by_the_jax_cli(data_dir, tmp_path, capsys):
    from dfac_tpu.cli import train_detector as jcli
    from dfac_tpu_torch.cli import train_detector as tcli

    ckpt, pred = tmp_path / "port.ckpt", tmp_path / "port.pkl"
    tcli.main(["--data-dir", str(data_dir), "--epochs", "2", "--hidden", str(H), "--batch-size", str(B),
               "--ckpt-path", str(ckpt), "--prediction-pkl", str(pred), "--ema", "--specaug", "--time-mask-max",
               "8", "--freq-mask-max", "4", "--device-resident", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("Training done. Best dev EER: ") and lines[-1].startswith("EER on split 'test2': ")
    import pandas as pd

    got = pd.read_pickle(pred)
    want = _score_cli(jcli, data_dir, ckpt, tmp_path / "jax.pkl", device=False)
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=1e-5)
    assert capsys.readouterr().out.strip().splitlines()[-1] == lines[-1]
    jfast = _score_cli(jcli, data_dir, ckpt, tmp_path / "jax_fast.pkl", "--fast", device=False)
    np.testing.assert_allclose(jfast["predictions"], got["predictions"], atol=1e-5)
