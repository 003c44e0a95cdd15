"""Data-parallel training in the PyTorch port against the JAX package's shard_map steps.

The port runs on two gloo ranks on the CPU: one module-scoped
:class:`~dfac_tpu_torch.parallel.data_parallel.RankPool` (one intra-op
thread a rank, each task bounded by a timeout) runs the ``_rank_*``
functions below, which import torch and the port only (the ranks import
this module by name; JAX is imported inside the tests and fixtures). The
JAX side runs its shard_map steps and ``data_parallel=2`` trainers on two
of the 8 virtual CPU devices of ``tests/conftest.py``. Inputs come from
numpy seeds, weights cross over through ``state_dict_from_jax``.

Tolerances: synced BatchNorm's output atol 1e-5 (f32; bf16: one last bit,
rtol 2^-7 + atol 1e-2), its running mean atol 1e-6 and var rtol 1e-4, its
gradients rtol 1e-4 + atol 1e-6 * max|g| (bf16 input gradient rtol 2^-7 +
atol 1e-2 * max|g|); the DP steps as ``tests/test_parallel.py:60-91`` and
``:268-375`` (SGD; the loss sum rtol 1e-5, parameters atol 2e-6, BatchNorm
mean atol 1e-6 and var rtol 1e-4; the CAE's and the detector's buffers and
EMA atol 2e-6), the AdamW step as ``tests/test_torch_port_train.py``
(parameters 1e-6 where |g| > 1e-6, within 2 * lr elsewhere); fits: train
and dev loss rtol 1e-3, EER, best epoch and learning rate equal.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.data.augment import AugmentConfig
from dfac_tpu_torch.data.normalizer import FeatureNormalizer
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models.common import BatchNorm1d, BatchNorm2d, random_bytes, set_batchnorm_group
from dfac_tpu_torch.parallel import data_parallel as dp
from dfac_tpu_torch.train import cae_loop as tcae
from dfac_tpu_torch.train import detector_loop as tdet
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.train.evaluate import evaluate_classifier as t_evaluate
from dfac_tpu_torch.utils.convert import params_from_jax, state_dict_from_jax

WORLD = 2
TASK_TIMEOUT_S = 120.0
F_, T_, BC = 12, 16, 4  # CNN2D
B_STEP = 16  # the global batch of the one-step cases (8 rows a rank)
B, LR, SMOOTH = 8, 1e-3, 0.05  # the fits (tests/test_torch_port_train.py's)
N_TRAIN, N_DEV = 20, 12  # 20 at B=8: a 4-row tail, 2 a rank
CF, CT, CB = 20, 37, 4  # the CAE (tests/test_torch_port_cae_train.py's geometry); 14 bonafide rows: a 2-row tail
DC, DT, DH = 12, 20, 16  # the detector
BF16_RTOL = 2.0**-7


@pytest.fixture(scope="module")
def pool():
    with dp.RankPool(["cpu"] * WORLD, backend="gloo", timeout_s=TASK_TIMEOUT_S, threads=1) as p:
        yield p


def _run(pool, fn, *args) -> list:
    return pool.run(fn, *args, timeout_s=TASK_TIMEOUT_S)


def _local(a, rank: int):
    """Rank ``rank``'s contiguous rows of a global batch."""
    k = len(a) // WORLD
    return a[rank * k : (rank + 1) * k]


def _np_sd(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


# -- what the ranks run (torch and the port only) ----------------------------------------------------------

def _rank_bn(kind, dtype_name, x, g, weight, bias, mean0, var0):
    rank = dist.get_rank()
    dtype = getattr(torch, dtype_name)
    bn = (BatchNorm1d if kind == "1d" else BatchNorm2d)(x.shape[1])
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias), (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    set_batchnorm_group(bn, dist.group.WORLD)
    xl = torch.from_numpy(_local(x, rank)).to(dtype).requires_grad_()
    y = bn(xl)
    (y.float() * torch.from_numpy(_local(g, rank))).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)  # the gradient of the global sum, as the DP step's reduce
    return {"y": y.float().detach().numpy(), "gx": xl.grad.float().numpy(), "gw": grads[: x.shape[1]].numpy(),
            "gb": grads[x.shape[1]:].numpy(), "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _cnn2d_cfg(**kw):
    base = dict(model="cnn2d", batch_size=B, epochs=2, lr=LR, dropout=0.0, seed=0, label_smoothing=SMOOTH,
                in_features=F_, lr_scheduler="plateau")
    return tloop.TrainConfig(**{**base, **kw})


def _cae_cfg(**kw):
    base = dict(batch_size=CB, epochs=3, lr=1e-4, base_channels=BC, seed=0, lr_scheduler_patience=0, early_stop=1)
    return tcae.CAEConfig(**{**base, **kw})


def _det_cfg(**kw):
    base = dict(epochs=2, batch_size=B, lr=LR, hidden=DH, dropout=0.0, encoder_dropout=0.0, grad_clip=5.0,
                ema=True, seed=0, patience=6)
    return tdet.DetectorConfig(**{**base, **kw})


def _trainer(kind, cfg, sd=None):
    if kind == "cnn2d":
        t = tloop.Trainer(cfg, device="cpu", model=tbuild("cnn2d", in_features=F_, base_channels=BC,
                                                          dropout=cfg.dropout))
    elif kind == "cae":
        t = tcae.CAETrainer(cfg, device="cpu")
    else:
        t = tdet.DetectorTrainer(cfg, in_channels=DC, device="cpu")
    t.init_state(sd)
    return t


def _rank_step(kind, sd, batch, sgd_lr, extra):
    """One DP step of ``kind`` on this rank's rows of the global ``batch``;
    the state afterwards (and, with AdamW, the reduced gradients)."""
    rank = dist.get_rank()
    local = [torch.from_numpy(_local(a, rank)) for a in batch]
    n = len(batch[0])
    if kind == "cnn2d":
        t = _trainer(kind, _cnn2d_cfg(batch_size=n, data_parallel=WORLD), sd)
    elif kind == "cae":
        t = _trainer(kind, _cae_cfg(batch_size=n, data_parallel=WORLD), sd)
        t.use_normalizer(FeatureNormalizer(*extra))
    else:
        t = _trainer(kind, _det_cfg(batch_size=n, data_parallel=WORLD), sd)
    if sgd_lr:
        t.optimizer = torch.optim.SGD(t.model.parameters(), lr=sgd_lr)
    if kind == "cnn2d":
        loss, count = t.train_step(local[0], local[1], torch.ones(len(local[0])))
    elif kind == "cae":
        loss, count = t.train_step(local[0], torch.ones(len(local[0])))
    else:
        loss, count = t.train_step(*local, extra) * n, n
    out = {"loss_sum": float(loss), "count": float(count), "sd": _np_sd(t.model.state_dict())}
    if kind == "detector":
        out["ema"] = _np_sd(t.eval_variables())
    if not sgd_lr:
        out["grads"] = {k: p.grad.numpy().copy() for k, p in t.model.named_parameters()}
    return out


def _rank_draws(cfg, feats, labels):
    t = _trainer("cnn2d", cfg)
    bits = random_bytes((256,), torch.device("cpu"), t.generator).numpy()
    masked = t.augment_fn(torch.ones(4, T_, F_), t.generator).numpy()
    rank = dist.get_rank() if t.ranks else 0
    x, y = (torch.from_numpy(_local(a, rank) if t.ranks else a) for a in (feats, labels))
    loss, count = t.train_step(x, y, torch.ones(len(x)))
    return bits, masked, float(loss) / float(count)


def _rank_fit(kind, cfg, sd, train, dev, ckpt):
    """A ``data_parallel`` fit from ``sd``; rank 0 writes to ``ckpt``. The
    history, the number of files this rank wrote, and rank 0's final model's
    dev scores (CNN2D)."""
    t = _trainer(kind, cfg, sd)
    saves = []
    if kind == "cnn2d":
        save = t._save
        t._save = lambda path, *a: (saves.append(path), save(path, *a))
        result = t.fit(train, dev, checkpoint_dir=ckpt)
        scores = t_evaluate(t.model, dev, batch_size=B, swap_tf=True, label_smoothing=SMOOTH)[1]
        return result["history"], len(saves), scores
    if kind == "cae":
        return t.fit(train, dev)["history"], 0, None
    return t.fit(train, dev)["history"], 0, None


def _rank_refusal(kind, mode, train, dev):
    """The error a data-parallel fit of ``kind`` raises: ``mode`` fused,
    host-fed or chunked (an indivisible tail)."""
    chunk = dict(resident_chunk_batches=2) if mode == "chunked" else {}
    cfg = {"cnn2d": _cnn2d_cfg, "cae": _cae_cfg, "detector": _det_cfg}[kind](data_parallel=WORLD, **chunk)
    t = _trainer(kind, cfg)
    try:
        t.fit_fused(train, dev) if mode == "fused" else t.fit(train, dev)
    except ValueError as e:
        return str(e)
    return None


# -- synced BatchNorm ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_synced_batchnorm_matches_jax_under_shard_map(pool, kind, dtype_name):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from dfac_tpu.models.common import TorchBatchNorm
    from dfac_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    c = 6
    shape = (8, c, 10) if kind == "1d" else (8, c, 5, 4)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    if dtype_name == "bfloat16":  # values bf16 holds exactly: both packages see the same input
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    g = rng.normal(size=shape).astype(np.float32)
    weight, bias = (rng.normal(size=c) * 0.5 + 1).astype(np.float32), rng.normal(size=c).astype(np.float32)
    mean0, var0 = (rng.normal(size=c) * 0.3).astype(np.float32), (rng.random(c) + 0.5).astype(np.float32)
    got = _run(pool, _rank_bn, kind, dtype_name, x, g, weight, bias, mean0, var0)

    to_last = (0, 2, 1) if kind == "1d" else (0, 2, 3, 1)
    from_last = (0, 2, 1) if kind == "1d" else (0, 3, 1, 2)
    dtype = getattr(jnp, dtype_name)
    bn = TorchBatchNorm(axis_name="data", dtype=dtype)

    def per_shard(params, stats, xs, gs):
        def f(p, xx):
            y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, use_running_average=False,
                              mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * gs), (y, mut["batch_stats"])

        (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, xs)
        return y, new_stats, gp, gx

    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
                             out_specs=(P("data"), P(), P(), P("data"))))
    y, stats, gp, gx = step({"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                            {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
                            jnp.asarray(x.transpose(to_last), dtype), jnp.asarray(g.transpose(to_last)))
    want_y = np.asarray(y.astype(jnp.float32)).transpose(from_last)
    want_gx = np.asarray(gx.astype(jnp.float32)).transpose(from_last)
    got_y = np.concatenate([r["y"] for r in got])
    got_gx = np.concatenate([r["gx"] for r in got])
    if dtype_name == "float32":
        np.testing.assert_allclose(got_y, want_y, atol=1e-5)
        np.testing.assert_allclose(got_gx, want_gx, rtol=1e-4, atol=1e-6 * np.abs(want_gx).max())
    else:
        np.testing.assert_allclose(got_y, want_y, rtol=BF16_RTOL, atol=1e-2)
        np.testing.assert_allclose(got_gx, want_gx, rtol=BF16_RTOL, atol=1e-2 * np.abs(want_gx).max())
    for r in got:  # every rank holds the same statistics and the same reduced parameter gradients
        np.testing.assert_allclose(r["mean"], np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(stats["var"]), rtol=1e-4)
        for name, want in (("gw", gp["scale"]), ("gb", gp["bias"])):
            want = np.asarray(want)
            np.testing.assert_allclose(r[name], want, rtol=1e-4, atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_batchnorm_without_a_group_is_torch_batchnorm():
    """No process group set: the module is ``nn.BatchNorm2d``'s own path, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 3, 5, 6)).astype(np.float32))
    ours, ref = BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    torch.testing.assert_close(ours(x), ref(x), rtol=0, atol=0)
    torch.testing.assert_close(ours.running_var, ref.running_var, rtol=0, atol=0)
    assert ours.sync_group is None


def test_cae_decoder_batchnorms_sync_and_a_foreign_batchnorm_is_refused():
    model = tbuild("cae", base_channels=BC)
    set_batchnorm_group(model, "g")
    assert [m.sync_group for m in model.decoder if isinstance(m, BatchNorm2d)] == ["g"] * 3
    with pytest.raises(TypeError, match="cannot sync"):
        set_batchnorm_group(torch.nn.Sequential(torch.nn.BatchNorm1d(3)), "g")


# -- one step ----------------------------------------------------------------------------------------------

def _cnn2d_batch(n=B_STEP, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, F_, T_)).astype(np.float32), (np.arange(n) % 2).astype(np.float32)


def _jax_cnn2d(axis_name=None, dropout=0.0):
    from dfac_tpu.models import build_model as jbuild

    return jbuild("cnn2d", in_features=F_, base_channels=BC, dropout=dropout, axis_name=axis_name)


def _assert_state(got_sd, want_sd, params_atol=2e-6):
    for k, want in want_sd.items():
        want = want.numpy()
        if "running_mean" in k:
            np.testing.assert_allclose(got_sd[k], want, atol=1e-6, err_msg=k)
        elif "running_var" in k:
            np.testing.assert_allclose(got_sd[k], want, rtol=1e-4, err_msg=k)
        elif "num_batches" not in k:
            np.testing.assert_allclose(got_sd[k], want, atol=params_atol, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_cnn2d_dp_step_matches_jax_shard_map_step_and_the_single_device_step(pool, opt):
    import jax
    import jax.numpy as jnp
    import optax

    from dfac_tpu.parallel.data_parallel import make_shard_map_train_step
    from dfac_tpu.parallel.mesh import make_mesh
    from dfac_tpu.train import loop as jloop
    from dfac_tpu.train import optim as joptim

    feats, labels = _cnn2d_batch()
    model = _jax_cnn2d("data")
    variables = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_))))
    tx = optax.sgd(0.1) if opt == "sgd" else joptim.build_optimizer("cnn2d", LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jloop.TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             opt_state=tx.init(params), key=jax.random.key(7))
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = make_shard_map_train_step(model, tx, mesh, swap_tf=True, label_smoothing=SMOOTH)
    new, loss_sum, count = step(state, jnp.asarray(feats), jnp.asarray(labels), jnp.ones(B_STEP, jnp.float32))
    want = state_dict_from_jax(jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
    sd = state_dict_from_jax(variables)

    got = _run(pool, _rank_step, "cnn2d", sd, (feats, labels), 0.1 if opt == "sgd" else 0.0, None)
    single = _trainer("cnn2d", _cnn2d_cfg(batch_size=B_STEP), sd)
    if opt == "sgd":
        single.optimizer = torch.optim.SGD(single.model.parameters(), lr=0.1)
    s_loss, s_count = single.train_step(torch.from_numpy(feats), torch.from_numpy(labels), torch.ones(B_STEP))
    for r in got:
        assert r["count"] == float(count) == float(s_count) == B_STEP
        np.testing.assert_allclose(r["loss_sum"], float(loss_sum), rtol=1e-5)
        np.testing.assert_allclose(r["loss_sum"], float(s_loss), rtol=1e-5)
        if opt == "sgd":
            _assert_state(r["sd"], want)
            _assert_state(r["sd"], single.model.state_dict())
            continue
        before = sd
        for name, g in r["grads"].items():  # Adam's first step: 1e-6 where |g| > 1e-6, within 2 * lr elsewhere
            big = np.abs(g) > 1e-6
            for ref in (want, single.model.state_dict()):
                np.testing.assert_allclose(r["sd"][name][big], ref[name].detach().numpy()[big], atol=1e-6,
                                           err_msg=name)
            assert np.abs(r["sd"][name] - before[name].numpy()).max() <= 2 * LR
        for name in want:
            if "running" in name:
                np.testing.assert_allclose(r["sd"][name], want[name].numpy(), atol=1e-5, err_msg=name)


def test_cae_dp_step_matches_jax(pool):
    import jax
    import jax.numpy as jnp
    import optax

    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu.parallel.mesh import make_mesh
    from dfac_tpu.train.cae_loop import make_cae_dp_train_step
    from dfac_tpu.train.loop import TrainState

    rng = np.random.default_rng(1)
    feats = rng.normal(size=(B_STEP, CF, CT)).astype(np.float32)
    mean, std = (rng.normal(size=CF) * 0.1).astype(np.float32), (rng.random(CF) + 0.5).astype(np.float32)
    model = jbuild("cae", base_channels=BC, axis_name="data")
    variables = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.zeros((1, CT, CF))))
    tx = optax.sgd(0.05)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), key=jax.random.key(7))
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = make_cae_dp_train_step(model, tx, jnp.asarray(mean), jnp.asarray(std), mesh)
    new, loss_sum, count = step(state, jnp.asarray(feats), jnp.ones(B_STEP, jnp.float32))
    want = state_dict_from_jax(jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
                               "cae")
    got = _run(pool, _rank_step, "cae", state_dict_from_jax(variables, "cae"), (feats,), 0.05, (mean, std))
    for r in got:
        assert r["count"] == float(count) == B_STEP
        np.testing.assert_allclose(r["loss_sum"], float(loss_sum), rtol=1e-5)
        for k, w in want.items():
            if "num_batches" not in k:
                np.testing.assert_allclose(r["sd"][k], w.numpy(), atol=2e-6, err_msg=k)


def test_detector_dp_step_with_ema_and_clip_matches_jax(pool):
    import jax
    import jax.numpy as jnp
    import optax

    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu.parallel.mesh import make_mesh
    from dfac_tpu.train import detector_loop as jdet

    rng = np.random.default_rng(2)
    feats = rng.normal(size=(B_STEP, DC, DT)).astype(np.float32)
    lengths = rng.integers(DT // 2, DT + 1, size=B_STEP).astype(np.int32)
    labels = (np.arange(B_STEP) % 2).astype(np.float32)
    pos_weight = 1.7
    cfg = jdet.DetectorConfig(specaug=False, ema=True, dropout=0.0, encoder_dropout=0.0, grad_clip=5.0, hidden=DH)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.sgd(0.05))
    model = jbuild("detector", in_channels=DC, hidden=DH, dropout=0.0, encoder_dropout=0.0, axis_name="data")
    key = jax.random.key(0)
    variables = jax.tree.map(np.asarray, model.init({"params": key, "dropout": key}, jnp.zeros((1, DT, DC))))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jdet.DetectorState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                               ema_params=params, opt_state=tx.init(params), key=jax.random.key(7))
    mesh = make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = jdet.make_detector_dp_train_step(model, tx, cfg, pos_weight, mesh)
    new, loss = step(state, jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(labels),
                     jnp.ones(B_STEP, jnp.float32))
    want = state_dict_from_jax(jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
                               "detector")
    want_ema = params_from_jax(jax.tree.map(np.asarray, new.ema_params), "detector")
    got = _run(pool, _rank_step, "detector", state_dict_from_jax(variables, "detector"), (feats, lengths, labels),
               0.05, pos_weight)
    for r in got:
        np.testing.assert_allclose(r["loss_sum"] / B_STEP, float(loss), rtol=1e-5)
        for k, w in want.items():
            if "num_batches" not in k:
                np.testing.assert_allclose(r["sd"][k], w.numpy(), atol=2e-6, err_msg=k)
        for k, w in want_ema.items():
            np.testing.assert_allclose(r["ema"][k], w.numpy(), atol=2e-6, err_msg=k)


# -- per-rank draws ------------------------------------------------------------------------------------

def test_ranks_draw_apart_and_rank_zero_draws_as_one_device(pool):
    """``tests/test_parallel.py:489``'s point: the ranks' dropout bytes and
    augmentation masks differ (a shared stream would drop the same
    positions on every rank); rank 0's are the single-device trainer's; a
    step with dropout 0.5 is finite."""
    aug = AugmentConfig(spec_augment=True, feature_mask=True, time_mask_ratio=0.3, feature_mask_ratio=0.3)
    feats, labels = _cnn2d_batch()
    got = _run(pool, _rank_draws, _cnn2d_cfg(batch_size=B_STEP, dropout=0.5, augment=aug, data_parallel=WORLD),
               feats, labels)
    single = _rank_draws(_cnn2d_cfg(batch_size=B_STEP, dropout=0.5, augment=aug), feats, labels)
    (bits0, mask0, loss0), (bits1, mask1, loss1) = got
    assert not np.array_equal(bits0, bits1) and not np.array_equal(mask0, mask1)
    np.testing.assert_array_equal(bits0, single[0])
    np.testing.assert_array_equal(mask0, single[1])
    assert (mask0 == 0).any() and np.isfinite([loss0, loss1, single[2]]).all()
    assert dp.rank_seed(5, 0) == 5 and len({dp.rank_seed(5, r) for r in range(8)}) == 8


# -- fits ----------------------------------------------------------------------------------------------

def _corpus(mod, n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, F_, T_)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats[labels == 1, :4] += 0.5
    return mod.ArrayDataset([f"u{seed}_{i}" for i in range(n)], feats, labels)


def _cae_corpus(mod, n, seed):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, CF, CT)).astype(np.float32)
    feats *= (rng.uniform(0.8, 1.2, size=n) + 0.2 * (labels == 0)).astype(np.float32)[:, None, None]
    return mod.ArrayDataset([f"c{seed}_{i}" for i in range(n)], feats, labels)


def _det_corpus(mod, n, seed):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 3 == 0).astype(np.int32)
    feats = rng.normal(size=(n, DC, DT)).astype(np.float32)
    feats[labels == 1, : DC // 2] += 0.4
    lengths = rng.integers(DT // 2, DT + 1, size=n).astype(np.int32)
    for i, ln in enumerate(lengths):
        feats[i, :, ln:] = 0.0
    return mod.ArrayDataset([f"d{seed}_{i}" for i in range(n)], feats, labels, lengths=lengths)


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX trainers' ``data_parallel=2`` fits, once for the module:
    CNN2D host-fed and with the freeze tail, the CAE, the detector."""
    import jax
    import jax.numpy as jnp

    from dfac_tpu.data import pipeline as jpipe
    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu.train import cae_loop as jcae
    from dfac_tpu.train import detector_loop as jdet
    from dfac_tpu.train import loop as jloop

    out = {}
    train, dev = _corpus(jpipe, N_TRAIN, 1), _corpus(jpipe, N_DEV, 2)
    base = dict(model="cnn2d", batch_size=B, epochs=2, lr=LR, dropout=0.0, seed=0, label_smoothing=SMOOTH,
                in_features=F_, lr_scheduler="plateau", data_parallel=WORLD)
    for name, kw in (("host", {}), ("freeze", dict(bn_freeze_after_frac=0.5))):
        trainer = jloop.Trainer(jloop.TrainConfig(**base, **kw), model=_jax_cnn2d("data"))
        trainer.init_state(train.features[:B])
        out["cnn2d_init"] = jax.tree.map(np.asarray, trainer.variables())
        out[name] = trainer.fit(train, dev)["history"]

    ctrain, cdev = _cae_corpus(jpipe, 28, 3), _cae_corpus(jpipe, 16, 4)
    init_key, _ = jax.random.split(jax.random.key(0))
    x0 = jnp.transpose(jnp.asarray(ctrain.filter_label(1).features[:1]), (0, 2, 1))
    out["cae_init"] = jax.tree.map(np.asarray, jbuild("cae", base_channels=BC).init(
        {"params": init_key, "dropout": init_key}, x0))
    cae_cfg = jcae.CAEConfig(batch_size=CB, epochs=3, lr=1e-4, base_channels=BC, seed=0, lr_scheduler_patience=0,
                             early_stop=1, data_parallel=WORLD)
    out["cae"] = jcae.CAETrainer(cae_cfg).fit(ctrain, cdev)["history"]

    dtrain, ddev = _det_corpus(jpipe, 28, 5), _det_corpus(jpipe, 16, 6)
    det_model = jbuild("detector", in_channels=DC, hidden=DH, dropout=0.0, encoder_dropout=0.0)
    out["det_init"] = jax.tree.map(np.asarray, det_model.init({"params": init_key, "dropout": init_key},
                                                                       jnp.zeros((1, DT, DC))))
    det_cfg = jdet.DetectorConfig(epochs=2, batch_size=B, lr=LR, hidden=DH, dropout=0.0, encoder_dropout=0.0,
                                  grad_clip=5.0, ema=True, seed=0, patience=6, data_parallel=WORLD)
    out["detector"] = jdet.DetectorTrainer(det_cfg, in_channels=DC).fit(dtrain, ddev)["history"]
    return out


def _assert_history(got, want):
    assert [m.epoch for m in got] == [m.epoch for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=1e-3)
        np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=1e-3)
        assert (g.dev_eer, g.is_best, g.learning_rate) == (w.dev_eer, w.is_best, w.learning_rate)


@pytest.fixture(scope="module")
def cnn2d_fits(pool, jax_fits, tmp_path_factory):
    """The port's CNN2D ``data_parallel=2`` fits from the JAX init: host-fed
    (with checkpoints), resident, chunked (G=2, f32) and the freeze tail."""
    root = tmp_path_factory.mktemp("dp_fit")
    sd = state_dict_from_jax(jax_fits["cnn2d_init"])
    train, dev = _corpus(tpipe, N_TRAIN, 1), _corpus(tpipe, N_DEV, 2)
    out = {}
    for mode, kw in (("host", {}), ("resident", dict(device_resident=True)),
                     ("chunked", dict(resident_chunk_batches=2)), ("freeze", dict(bn_freeze_after_frac=0.5))):
        ckpt = str(root / mode) if mode == "host" else None
        out[mode] = _run(pool, _rank_fit, "cnn2d", _cnn2d_cfg(data_parallel=WORLD, **kw), sd, train, dev, ckpt)
    out["root"] = root
    return out


@pytest.mark.parametrize("mode", ["host", "chunked", "freeze"])
def test_cnn2d_dp_fits_match_jax(cnn2d_fits, jax_fits, mode):
    want = jax_fits["freeze" if mode == "freeze" else "host"]
    assert len(want) == 2
    for history, _, _ in cnn2d_fits[mode]:  # every rank took the same decisions
        _assert_history(history, want)


def test_cnn2d_dp_resident_fit_is_host_fed(cnn2d_fits):
    for (got, _, _), (host, _, _) in zip(cnn2d_fits["resident"], cnn2d_fits["host"]):
        assert [(m.train_loss, m.dev_loss, m.dev_eer) for m in got] == [(m.train_loss, m.dev_loss, m.dev_eer)
                                                                        for m in host]


def test_cnn2d_dp_checkpoint_is_written_by_rank_zero_and_scores_in_jax(cnn2d_fits):
    from dfac_tpu.train import checkpoint as jckpt
    from dfac_tpu.train.evaluate import evaluate_classifier as j_evaluate
    from dfac_tpu.data import pipeline as jpipe

    (_, saves0, scores), (_, saves1, _) = cnn2d_fits["host"]
    assert saves0 >= 3 and saves1 == 0  # best, last every epoch and at the end: rank 0 alone
    root = cnn2d_fits["root"] / "host"
    assert sorted(p.name for p in root.iterdir()) == ["cnn2d_best.ckpt", "cnn2d_last.ckpt"]
    variables = jckpt.load_model_variables(str(root / "cnn2d_last.ckpt"))
    _, want, _ = j_evaluate(_jax_cnn2d(), variables, _corpus(jpipe, N_DEV, 2), batch_size=B, swap_tf=True,
                            label_smoothing=SMOOTH)
    np.testing.assert_allclose(scores, want, atol=1e-5)


@pytest.mark.parametrize("mode", ["host", "chunked"])
def test_cae_dp_fits_match_jax(pool, jax_fits, mode):
    sd = state_dict_from_jax(jax_fits["cae_init"], "cae")
    cfg = _cae_cfg(data_parallel=WORLD, **(dict(resident_chunk_batches=2) if mode == "chunked" else {}))
    got = _run(pool, _rank_fit, "cae", cfg, sd, _cae_corpus(tpipe, 28, 3), _cae_corpus(tpipe, 16, 4), None)
    for history, _, _ in got:
        assert [m.epoch for m in history] == [m.epoch for m in jax_fits["cae"]]
        for g, w in zip(history, jax_fits["cae"]):
            np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=1e-3)
            np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=1e-3)
            assert (g.is_best, g.learning_rate) == (w.is_best, w.learning_rate)


@pytest.mark.parametrize("mode", ["host", "chunked"])
def test_detector_dp_fits_match_jax(pool, jax_fits, mode):
    sd = state_dict_from_jax(jax_fits["det_init"], "detector")
    cfg = _det_cfg(data_parallel=WORLD, **(dict(resident_chunk_batches=2) if mode == "chunked" else {}))
    got = _run(pool, _rank_fit, "detector", cfg, sd, _det_corpus(tpipe, 28, 5), _det_corpus(tpipe, 16, 6), None)
    for history, _, _ in got:
        assert [h["epoch"] for h in history] == [h["epoch"] for h in jax_fits["detector"]] == [1, 2]
        for g, w in zip(history, jax_fits["detector"]):
            np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=1e-3)
            assert g["dev_eer"] == w["dev_eer"]


# -- refusals, with the JAX package's messages --------------------------------------------------------

def test_batch_size_must_divide_over_the_ranks():
    from dfac_tpu.train import cae_loop as jcae
    from dfac_tpu.train import detector_loop as jdet
    from dfac_tpu.train import loop as jloop

    for tcfg, jcfg in ((tloop.TrainConfig, jloop.TrainConfig), (tcae.CAEConfig, jcae.CAEConfig),
                       (tdet.DetectorConfig, jdet.DetectorConfig)):
        with pytest.raises(ValueError) as want:
            jcfg(batch_size=9, data_parallel=2)
        with pytest.raises(ValueError) as got:
            tcfg(batch_size=9, data_parallel=2)
        assert str(got.value) == str(want.value) == "batch_size must divide evenly over data_parallel shards"


def test_device_count_refusal_is_make_mesh_s():
    from dfac_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError) as want:
        make_mesh(n_data=2, devices=[])
    with pytest.raises(ValueError) as got:
        dp.rank_devices(2, "cuda")  # no card here: 0 devices
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["cnn2d", "cae", "detector"])
def test_indivisible_tails_and_fused_fits_are_refused_with_jax_messages(pool, kind):
    from dfac_tpu.data import pipeline as jpipe
    from dfac_tpu.train import cae_loop as jcae
    from dfac_tpu.train import detector_loop as jdet
    from dfac_tpu.train import loop as jloop
    from dfac_tpu.train.chunked import check_dp_tail as j_check

    # tails of 5 rows: 21 at B=8 (the detector), 13 bonafide rows at B=4 (the CAE)
    make = {"cnn2d": (_corpus, 21, 8), "cae": (_cae_corpus, 26, 4), "detector": (_det_corpus, 21, 8)}[kind]
    train, dev = make[0](tpipe, make[1], 1), make[0](tpipe, 12, 2)
    n = make[1] // 2 if kind == "cae" else make[1]
    name = {"cnn2d": "", "cae": "CAE ", "detector": "detector "}[kind]
    for mode, what in (("host", f"{name}training"), ("chunked", f"chunked {name}training")):
        got = _run(pool, _rank_refusal, kind, mode, train, dev)
        with pytest.raises(ValueError) as want:
            j_check(n, make[2], WORLD, what)
        assert got == [str(want.value)] * WORLD
    jtrain, jdev = make[0](jpipe, make[1], 1), make[0](jpipe, 12, 2)
    if kind == "cnn2d":
        jt = jloop.Trainer(jloop.TrainConfig(batch_size=8, in_features=F_, data_parallel=WORLD),
                           model=_jax_cnn2d("data"))
        jt.init_state(jtrain.features[:1])
        call = lambda: jt.fit_fused(jtrain, jdev)  # noqa: E731
    elif kind == "cae":
        call = lambda: jcae.CAETrainer(jcae.CAEConfig(batch_size=4, base_channels=BC,  # noqa: E731
                                                      data_parallel=WORLD)).fit_fused(jtrain, jdev)
    else:
        call = lambda: jdet.DetectorTrainer(jdet.DetectorConfig(batch_size=8, hidden=DH,  # noqa: E731
                                                                data_parallel=WORLD), in_channels=DC).fit_fused(
            jtrain, jdev)
    with pytest.raises(ValueError) as want:
        call()
    assert _run(pool, _rank_refusal, kind, "fused", train, dev) == [str(want.value)] * WORLD
