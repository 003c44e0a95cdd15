"""CNN2D training in the PyTorch port against the JAX package.

A tiny CNN2D (12 features, 16 frames, base channels 4) starts from the JAX
init carried across by ``state_dict_from_jax``; dropout 0 and no
augmentation, so both packages compute the same function (their dropout
and augmentation draws come from different generators). Each JAX
computation runs once, in a module-scoped fixture. Tolerances: the loss
rtol 1e-5, the grads rtol 1e-4 + atol 1e-6 * max|g| over the whole
gradient (f32 convs summed in another order; the pre-BatchNorm conv
biases' gradients are zero up to rounding on both sides), BN running statistics 1e-5, parameters after one AdamW
step 1e-6 where |g| > 1e-6 (within 2 * lr elsewhere: Adam's first step
divides by |g|), two epochs' losses rtol 1e-3 and the dev EER equal (the
port's host-fed, chunked and fused fits).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_eer import GOLDEN

from dfac_tpu.data import pipeline as jpipe
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.ops import eer as jeer
from dfac_tpu.ops.train_chain import cnn2d_hand_loss_and_grad
from dfac_tpu.train import checkpoint as jckpt
from dfac_tpu.train import loop as jloop
from dfac_tpu.train import optim as joptim
from dfac_tpu.train.evaluate import evaluate_classifier as j_evaluate
from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.ops import eer as teer
from dfac_tpu_torch.train import checkpoint as tckpt
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.train import optim as toptim
from dfac_tpu_torch.utils.convert import (
    adam_state_from_optax,
    jax_from_state_dict,
    params_from_jax,
    state_dict_from_jax,
)

F_, T_, BC, B = 12, 16, 4, 8
LR, SMOOTH = 1e-3, 0.05
N_TRAIN, N_DEV = 20, 12  # a 32-utterance corpus; 20 at B=8 leaves a true-size tail of 4


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, F_, T_)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats[labels == 1, :4] += 0.5  # learnable, not separated at init
    return [f"u{seed}_{i}" for i in range(n)], feats, labels


def _datasets(mod, split):
    uttids, feats, labels = split
    return mod.ArrayDataset(uttids=uttids, features=feats, labels=labels)


def _jax_model():
    return jbuild("cnn2d", in_features=F_, base_channels=BC, dropout=0.0)


def _torch_model():
    return tbuild("cnn2d", in_features=F_, base_channels=BC, dropout=0.0)


def _cfg(mod, **kw):
    base = dict(model="cnn2d", batch_size=B, epochs=2, lr=LR, dropout=0.0, seed=0, label_smoothing=SMOOTH,
                in_features=F_, lr_scheduler="plateau")
    return mod.TrainConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's step, two-epoch fit (with checkpoints) and a
    resumed third epoch, once for the module."""
    root = tmp_path_factory.mktemp("jax_train")
    train, dev = _corpus(N_TRAIN, 1), _corpus(N_DEV, 2)
    model = _jax_model()
    variables = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_))))

    # one step on the first B rows
    tx = joptim.build_optimizer("cnn2d", LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = jloop.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params), key=jax.random.key(0))
    feats, labels = train[1][:B], train[2][:B].astype(np.float32)
    weights = np.ones(B, np.float32)
    step = jloop.make_train_step(model, tx, swap_tf=True, label_smoothing=SMOOTH, augment_fn=None)
    new_state, loss_sum, count = step(state, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(weights))
    x = jnp.transpose(jnp.asarray(feats), (0, 2, 1))
    (_, _), grads = cnn2d_hand_loss_and_grad(
        params, stats, x, jax.random.split(jax.random.key(1), 2), jnp.asarray(labels), jnp.asarray(weights),
        dropout_rate=0.0, label_smoothing=SMOOTH,
    )
    one_step = {
        "loss": float(loss_sum) / float(count),
        "grads": jax.tree.map(np.asarray, grads),
        "after": jax.tree.map(np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}),
    }

    # two epochs, then a third resumed from the JAX-written *_last.ckpt
    trainer = jloop.Trainer(_cfg(jloop), model=model)
    trainer.init_state(train[1][:B])
    init = jax.tree.map(np.asarray, trainer.variables())
    result = trainer.fit(_datasets(jpipe, train), _datasets(jpipe, dev), checkpoint_dir=str(root))
    resumed = jloop.Trainer(_cfg(jloop, epochs=3), model=model)
    third = resumed.fit(_datasets(jpipe, train), _datasets(jpipe, dev), resume_from=str(root / "cnn2d_last.ckpt"))
    return {
        "variables": variables, "one_step": one_step, "train": train, "dev": dev, "init": init,
        "history": result["history"], "third": third["history"], "last": str(root / "cnn2d_last.ckpt"),
    }


def _torch_trainer(cfg, variables):
    trainer = tloop.Trainer(cfg, device="cpu", model=_torch_model())
    trainer.init_state(state_dict_from_jax(variables))
    return trainer


def test_one_train_step_matches_jax(jax_runs):
    want = jax_runs["one_step"]
    trainer = _torch_trainer(_cfg(tloop), jax_runs["variables"])
    _, feats, labels = jax_runs["train"]
    loss_sum, count = trainer.train_step(
        torch.from_numpy(feats[:B]), torch.from_numpy(labels[:B].astype(np.float32)), torch.ones(B)
    )
    np.testing.assert_allclose(float(loss_sum) / float(count), want["loss"], rtol=1e-5)

    grads = params_from_jax(want["grads"])
    g_max = max(float(g.abs().max()) for g in grads.values())  # over the whole gradient
    before = state_dict_from_jax(jax_runs["variables"])
    after_jax = state_dict_from_jax(want["after"])
    after = trainer.model.state_dict()
    for name, p in trainer.model.named_parameters():
        g_want = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_want, rtol=1e-4, atol=1e-6 * g_max, err_msg=name)
        big = np.abs(g_want) > 1e-6
        np.testing.assert_allclose(after[name].numpy()[big], after_jax[name].numpy()[big], atol=1e-6, err_msg=name)
        # where |g| is tiny, Adam's first step moves each side by at most ~lr
        assert np.abs(after[name].numpy() - before[name].numpy()).max() <= 2 * LR
        assert np.abs(after_jax[name].numpy() - before[name].numpy()).max() <= 2 * LR
    for name in after:
        if "running" in name:
            np.testing.assert_allclose(after[name].numpy(), after_jax[name].numpy(), atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def torch_fit(jax_runs, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    trainer = _torch_trainer(_cfg(tloop), jax_runs["init"])
    result = trainer.fit(_datasets(tpipe, jax_runs["train"]), _datasets(tpipe, jax_runs["dev"]),
                         checkpoint_dir=str(root))
    return trainer, result, root


def test_two_epochs_match_jax_trainer(jax_runs, torch_fit):
    _, result, _ = torch_fit
    assert [m.epoch for m in result["history"]] == [m.epoch for m in jax_runs["history"]] == [1, 2]
    for got, want in zip(result["history"], jax_runs["history"]):
        np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-3)
        np.testing.assert_allclose(got.dev_loss, want.dev_loss, rtol=1e-3)
        assert got.dev_eer == want.dev_eer
        assert (got.is_best, got.learning_rate) == (want.is_best, want.learning_rate)
    assert result["history"][1].train_loss < result["history"][0].train_loss


@pytest.mark.parametrize("mode", ["chunked", "fused"])
def test_chunked_and_fused_fits_match_jax_trainer(jax_runs, mode):
    """The chunked feed (chunks of 2 batches; the JAX package's chunked run
    equals its host-fed one up to XLA reassociation, ``tests/test_chunked.py``)
    and the fused fit (the resident fit with no display), from the JAX init,
    against the JAX fit at the two-epoch tolerances."""
    trainer = _torch_trainer(_cfg(tloop, resident_chunk_batches=2) if mode == "chunked" else
                             _cfg(tloop, device_resident=True), jax_runs["init"])
    fit = trainer.fit if mode == "chunked" else trainer.fit_fused
    result = fit(_datasets(tpipe, jax_runs["train"]), _datasets(tpipe, jax_runs["dev"]))
    assert [m.epoch for m in result["history"]] == [m.epoch for m in jax_runs["history"]] == [1, 2]
    for got, want in zip(result["history"], jax_runs["history"]):
        np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-3)
        np.testing.assert_allclose(got.dev_loss, want.dev_loss, rtol=1e-3)
        assert got.dev_eer == want.dev_eer
        assert (got.is_best, got.learning_rate) == (want.is_best, want.learning_rate)


def test_device_resident_epochs_equal_host_fed(jax_runs, torch_fit):
    """The resident feed gathers the same rows in the same order on the
    device: on the CPU the two runs are the same computation."""
    trainer = _torch_trainer(_cfg(tloop, device_resident=True), jax_runs["init"])
    result = trainer.fit(_datasets(tpipe, jax_runs["train"]), _datasets(tpipe, jax_runs["dev"]))
    host = torch_fit[1]["history"]
    for got, want in zip(result["history"], host):
        assert (got.train_loss, got.dev_loss, got.dev_eer) == (want.train_loss, want.dev_loss, want.dev_eer)


def test_port_best_checkpoint_serves_in_jax(jax_runs, torch_fit):
    trainer, result, root = torch_fit
    with open(root / "cnn2d_best.ckpt", "rb") as f:
        payload = pickle.load(f)  # plain pickle: numpy arrays and builtins only
    assert payload["format"] == "dfac_tpu.v1" and payload["optimizer_state"] is None
    assert payload["torch_optimizer_state"]["state"]  # the port's AdamW state, as numpy
    variables = jckpt.load_model_variables(str(root / "cnn2d_best.ckpt"), model_name="cnn2d")
    metrics, _, _ = j_evaluate(_jax_model(), variables, _datasets(jpipe, jax_runs["dev"]), batch_size=B,
                               label_smoothing=SMOOTH)
    assert metrics["eer"] == result["best_eer"]
    best_epoch = next(m for m in reversed(result["history"]) if m.is_best)
    np.testing.assert_allclose(metrics["avg_loss"], best_epoch.dev_loss, rtol=1e-5)


def test_jax_last_checkpoint_resumes_in_port_with_adam_moments(jax_runs, tmp_path):
    ckpt = tckpt.load_checkpoint(jax_runs["last"])  # read without jax: stand-ins keep optax's fields
    trainer = tloop.Trainer(_cfg(tloop, epochs=3), device="cpu", model=_torch_model())
    restored = trainer.restore(jax_runs["last"])
    assert restored["epoch"] == 2
    names = [n for n, _ in trainer.model.named_parameters()]
    opt_state = trainer.optimizer.state_dict()["state"]
    with open(jax_runs["last"], "rb") as f:
        real = pickle.load(f)["optimizer_state"]  # optax's own NamedTuples
    want = adam_state_from_optax(real, names)
    assert set(opt_state) == set(want) == set(range(len(names)))
    for i in want:
        assert float(opt_state[i]["step"]) == float(want[i]["step"]) == 6.0  # 2 epochs x 3 steps
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt_state[i][key], want[i][key], rtol=0, atol=0)
    assert trainer.scheduler.state_dict() == ckpt["scheduler_state"]
    result = trainer.fit(_datasets(tpipe, jax_runs["train"]), _datasets(tpipe, jax_runs["dev"]),
                         resume_from=jax_runs["last"])
    (got,), (want,) = result["history"], jax_runs["third"]
    assert got.epoch == want.epoch == 3
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-3)
    np.testing.assert_allclose(got.dev_loss, want.dev_loss, rtol=1e-3)


def test_port_last_checkpoint_resumes_in_port_and_jax(jax_runs, torch_fit):
    trainer, _, root = torch_fit
    again = tloop.Trainer(_cfg(tloop), device="cpu", model=_torch_model())
    restored = again.restore(str(root / "cnn2d_last.ckpt"))
    assert restored["epoch"] == 2
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):  # not in the JAX layout; momentum is fixed, so never read
            torch.testing.assert_close(again.model.state_dict()[k], v, rtol=0, atol=0)
    got, want = again.optimizer.state_dict(), trainer.optimizer.state_dict()
    for i, s in want["state"].items():
        for key, v in s.items():
            torch.testing.assert_close(got["state"][i][key], v, rtol=0, atol=0)
    # the JAX package resumes it too, with fresh Adam moments
    jt = jloop.Trainer(_cfg(jloop), model=_jax_model())
    jrestored = jt.restore(str(root / "cnn2d_last.ckpt"))
    assert jrestored["epoch"] == 2 and jrestored["trainer_state"]["lr"] == trainer._lr


def test_plateau_state_round_trips(tmp_path):
    sched = toptim.PlateauScheduler(patience=1)
    lr = 1e-3
    for metric in (0.5, 0.4, 0.45, 0.41, 0.42):
        lr = sched.step(metric, lr)
    jsched = joptim.PlateauScheduler(patience=1)
    jlr = 1e-3
    for metric in (0.5, 0.4, 0.45, 0.41, 0.42):
        jlr = jsched.step(metric, jlr)
    assert lr == jlr == 5e-4 and sched.state_dict() == jsched.state_dict()
    path = str(tmp_path / "c.ckpt")
    tckpt.save_checkpoint(path, jax_from_state_dict(_torch_model().state_dict()), scheduler_state=sched.state_dict())
    assert toptim.PlateauScheduler.from_state_dict(tckpt.load_checkpoint(path)["scheduler_state"]) == sched
    assert joptim.PlateauScheduler.from_state_dict(jckpt.load_checkpoint(path)["scheduler_state"]) == jsched


def test_state_dict_round_trips_through_jax_layout():
    model = _torch_model()
    sd = model.state_dict()
    back = state_dict_from_jax(jax_from_state_dict(sd))
    assert list(back) == list(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_optimizer_policy_matches_jax():
    params = list(_torch_model().parameters())
    for name, wd, kind, want_wd in (("cnn2d", 0.0, torch.optim.AdamW, 0.01), ("cnn1d", 0.0, torch.optim.AdamW, 0.01),
                                    ("statspool_mlp", 0.0, torch.optim.Adam, 0), ("statspool_mlp", 0.1,
                                                                                   torch.optim.AdamW, 0.1)):
        opt = toptim.build_optimizer(name, params, 1e-3, wd)
        assert type(opt) is kind and opt.param_groups[0]["weight_decay"] == want_wd
        jopt = joptim.build_optimizer(name, 1e-3, wd).init({"w": jnp.zeros(2)})
        assert jopt.hyperparams.get("weight_decay", 0) == pytest.approx(want_wd)
        assert toptim.get_lr(toptim.set_lr(opt, 5e-4)) == 5e-4
    assert toptim.smooth_labels(torch.tensor([0.0, 1.0]), 0.05).tolist() == pytest.approx([0.025, 0.975])


# -- EER on the device ------------------------------------------------------------


def _tied_split(n, seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) > 0.45).astype(np.int64)
    scores = (np.round((rng.normal(size=n) + 0.8 * labels) * 40) / 40).astype(np.float32)  # heavy ties
    return scores, labels


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_device_eer_byte_exact_on_golden_cases(case):
    scores, labels = GOLDEN[case][:2]
    want = jeer.calculate_eer(scores, labels)
    assert teer.calculate_eer(scores, labels) == want
    assert teer.eer_device(scores, labels) == want
    assert teer.eer_device(torch.as_tensor(scores), torch.as_tensor(labels)) == want
    got = teer.eer_torch(torch.as_tensor(scores), torch.as_tensor(labels))
    assert tuple(float(v) for v in got) == want


def test_device_eer_takes_the_first_of_tied_minima():
    """|FAR - FRR| can reach its minimum at two positions (here 0.5 at 1 and
    2: bona, spoof, bona); the reference's ``np.argmin`` takes the first.
    Where the exact values tie but float64 rounds them apart, the
    reference takes the smaller float: the port computes those floats
    (the JAX package's integer search takes the first exact tie there and
    disagrees with its own ``calculate_eer``)."""
    scores, labels = np.array([0.1, 0.2, 0.3], np.float32), np.array([1, 0, 1])
    want = jeer.calculate_eer(scores, labels)
    assert want == (0.75, float(np.float32(0.1)))
    assert teer.eer_device(scores, labels) == want
    assert tuple(float(v) for v in teer.eer_torch(torch.from_numpy(scores), torch.from_numpy(labels))) == want
    # exact ties |9 - 6| = |9 - 12| at positions 4 and 5; 0.5 - 1/3 rounds above 2/3 - 0.5
    scores = np.array([0, 2, 5, 1, 3, 2, 2, 0, 1], np.float32)
    labels = np.array([0, 1, 0, 0, 0, 0, 1, 0, 1])
    want = jeer.calculate_eer(scores, labels)
    assert want == (0.5833333333333333, 2.0) != jeer.eer_device(scores, labels) == (0.41666666666666663, 1.0)
    assert teer.eer_device(scores, labels) == want
    assert tuple(float(v) for v in teer.eer_torch(torch.from_numpy(scores), torch.from_numpy(labels))) == want
    rng = np.random.default_rng(21)
    tied_minima = 0
    for _ in range(300):
        n = int(rng.integers(3, 30))
        labels = (rng.random(n) > rng.uniform(0.2, 0.8)).astype(np.int64)
        scores = rng.integers(0, 6, n).astype(np.float32)
        want = teer.calculate_eer(scores, labels)
        assert teer.eer_device(scores, labels) == want, (scores, labels)
        order = np.argsort(scores, kind="stable")
        nb, ns = labels.sum(), n - labels.sum()
        far = ns - np.concatenate([[0], np.cumsum(labels[order] == 0)])
        frr = np.concatenate([[0], np.cumsum(labels[order] == 1)])
        dist = np.abs(nb * far - ns * frr)
        tied_minima += nb > 0 and ns > 0 and (dist == dist.min()).sum() > 1
    assert tied_minima > 10  # the draws do reach the rule


def test_device_eer_byte_exact_on_100k_tied_split():
    scores, labels = _tied_split(100_000, 11)
    want = jeer.calculate_eer(scores, labels)
    assert teer.calculate_eer(scores, labels) == want
    assert teer.eer_device(scores, labels) == want
    got = teer.eer_torch(torch.from_numpy(scores), torch.from_numpy(labels))
    assert tuple(float(v) for v in got) == want
    thr = want[1]
    counts = [int(v) for v in teer.confusion_at_threshold_torch(torch.from_numpy(scores), torch.from_numpy(labels),
                                                                thr)[:4]]
    assert tuple(counts) == teer.confusion_at_threshold(scores, labels, thr)[:4]


def test_device_eer_empty_and_single_class():
    assert teer.eer_device(np.zeros(0, np.float32), np.zeros(0, np.int64)) == (0.0, 0.0)
    assert teer.eer_device(np.arange(5, dtype=np.float32), np.zeros(5, np.int64)) == (0.0, 0.0)
    eer, thr = teer.eer_torch(torch.arange(5.0), torch.ones(5, dtype=torch.int64))
    assert (float(eer), float(thr)) == (0.0, 0.0)


# -- shuffled batches ---------------------------------------------------------------


@pytest.mark.parametrize("n,batch,drop_last,pad_tail", [(21, 8, False, False), (21, 8, True, False),
                                                        (21, 8, False, True), (24, 8, False, False)])
def test_shuffled_batch_iterator_matches_jax(n, batch, drop_last, pad_tail):
    uttids, feats, labels = _corpus(n, 3)
    kw = dict(shuffle=True, seed=1234, drop_last=drop_last, pad_tail=pad_tail)
    got = list(tpipe.batch_iterator(_datasets(tpipe, (uttids, feats, labels)), batch, **kw))
    want = list(jpipe.batch_iterator(_datasets(jpipe, (uttids, feats, labels)), batch, **kw))
    assert len(got) == len(want) == tpipe.num_batches(n, batch, drop_last) == jpipe.num_batches(n, batch, drop_last)
    for g, w in zip(got, want):
        for field in ("index", "features", "labels", "weights"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


def test_filter_label_and_create_datasets(tmp_path):
    import pandas as pd

    uttids, feats, labels = _corpus(9, 4)
    ds = _datasets(tpipe, (uttids, feats, labels))
    bona = ds.filter_label(1)
    assert bona.uttids == [u for u, lab in zip(uttids, labels) if lab == 1]
    np.testing.assert_array_equal(bona.features, feats[labels == 1])
    paths = {}
    for name in ("train", "dev"):
        paths[name] = (str(tmp_path / f"{name}_f.pkl"), str(tmp_path / f"{name}_l.pkl"))
        pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(paths[name][0])
        pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(paths[name][1])
    train, dev, test = tpipe.create_datasets(*paths["train"], *paths["dev"])
    assert test is None and train.uttids == dev.uttids == uttids
    np.testing.assert_array_equal(train.labels, labels)
