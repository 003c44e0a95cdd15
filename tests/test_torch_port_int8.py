"""The w8a8 serving chain: the port (``dfac_tpu_torch.models.fast_infer_int8``,
the int8 block's plain version, ``predict --fast --int8``) against the JAX
package on the CPU.

Sizes are the JAX int8 tests' (``tests/test_fast_infer_int8.py:20-30``): F =
20, T = 33, base 8, B = 16, BatchNorm statistics and affine parameters drawn
from a numpy seed. Tolerances, with their reasons:

* the folded weights' int8 values are equal. The quantizers equal JAX's bit
  for bit on one input. With BatchNorm variances whose ``rsqrt(var + eps)``
  is exact, the per-channel weight scales are equal and the activation
  scales (``inv_s``, from the f32 calibration convs, summed in another
  order) within one f32 ulp, and ``deq = float32(s) * s_w`` within two
  (``s``'s ulp and its own rounding); with random variances the folded
  kernels themselves differ by an ulp (XLA's CPU ``rsqrt`` is not correctly
  rounded), which ``amax / 127`` carries to at most two ulps of a weight
  scale, and the activation scales and ``deq`` to a relative 4 * 2^-23;
* from one int8 input the int32 accumulators are equal (exact integer
  sums); JAX's jitted CPU epilogue contracts ``acc * deq + b`` into an FMA
  (checked below), the port rounds the product and the sum apart (as the
  CUDA kernel does, to equal its plain version), so block 3's f32 output
  differs by at most the product's rounding, and an int8 output may move by
  one step where ``h * inv_s`` sits on a rounding boundary: at most 0.1% of
  positions (in these tests none moved);
* scores against JAX's w8a8 chain within 1e-2; against the port's own f32
  chain within 5e-2 (the JAX test's bound: int8 quantization); the EER of
  ``test_w8a8_preserves_eer``'s split within 0.1% absolute (BASELINE.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import predict as jpredict
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer_int8 as j8
from dfac_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from dfac_tpu_torch.cli import predict as tpredict
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.models import fast_infer_int8 as t8
from dfac_tpu_torch.ops import conv_block_w8a8 as kw8
from dfac_tpu_torch.ops.conv_block import cnn2d_head, cnn2d_head_from_mean
from dfac_tpu_torch.ops.eer import calculate_eer
from dfac_tpu_torch.utils.convert import state_dict_from_jax

F_, T_, B_, BC = 20, 33, 16, 8
DN = ("NHWC", "HWIO", "NHWC")
MAX_MOVED = 1e-3  # int8 outputs that may move by one step (see the module docstring)


def randomize_bn(variables, seed=0):
    rng = np.random.default_rng(seed)
    for name, d in variables["batch_stats"].items():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
        p = variables["params"][name]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.uniform(-0.1, 0.1, p["bias"].shape).astype(np.float32)
    return variables


def exact_rsqrt_vars(shape, rng):
    """Variances ``v`` with ``v + 1e-5`` exactly 0.25, 1 or 4 in f32, so that
    both packages' ``rsqrt(var + eps)`` is exact."""
    v = rng.choice(np.array([0.25, 1.0, 4.0], np.float32), size=shape) - np.float32(1e-5)
    assert np.isin(v + np.float32(1e-5), [0.25, 1.0, 4.0]).all()
    return v.astype(np.float32)


def make_cnn2d(exact_rsqrt=False):
    """(numpy JAX variables, the port's state_dict, stored (B, F, T) features)."""
    model = jbuild("cnn2d", in_features=F_, base_channels=BC)
    variables = model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_)))
    variables = randomize_bn(jax.tree.map(np.asarray, variables), 0)
    if exact_rsqrt:
        rng = np.random.default_rng(5)
        for d in variables["batch_stats"].values():
            d["var"] = exact_rsqrt_vars(d["var"].shape, rng)
    feats = np.random.default_rng(1).normal(size=(B_, F_, T_)).astype(np.float32)
    return variables, state_dict_from_jax(variables, "cnn2d"), feats


@pytest.fixture(scope="module")
def cnn2d():
    return make_cnn2d()


@pytest.fixture(scope="module")
def folds(cnn2d):
    variables, sd, feats = cnn2d
    return j8.fold_cnn2d_w8a8(variables, feats), t8.fold_cnn2d_w8a8(sd, feats)


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(a))).max())


@pytest.mark.parametrize("exact_rsqrt", [True, False])
def test_fold_matches_jax(exact_rsqrt):
    variables, sd, feats = make_cnn2d(exact_rsqrt)
    jf8, tf8 = j8.fold_cnn2d_w8a8(variables, feats), t8.fold_cnn2d_w8a8(sd, feats)
    for k in ("w2q", "w3q"):
        assert tf8[k].dtype == torch.int8
        np.testing.assert_array_equal(tf8[k].numpy(), np.asarray(jf8[k]))
    jfold, tfold = j8.fold_cnn2d(variables), tfast.fold_cnn2d(sd)
    for i in (2, 3):
        _, js = j8._quant_weight_per_channel(jfold[f"w{i}"])
        _, ts = t8._quant_weight_per_channel(tfold[f"w{i}"])
        assert ulps(js, ts.numpy()) <= (0 if exact_rsqrt else 2)
    for k, n_ulps in (("inv_s1", 1), ("inv_s2", 1), ("deq2", 2), ("deq3", 2)):
        if exact_rsqrt:
            assert ulps(jf8[k], tf8[k].numpy()) <= n_ulps
        else:
            np.testing.assert_allclose(tf8[k].numpy(), np.asarray(jf8[k]), rtol=4 * 2.0**-23, atol=0)
    for k in ("w1", "b1", "b2", "b3", "w_cls", "b_cls"):
        np.testing.assert_allclose(tf8[k].numpy(), np.asarray(jf8[k]), rtol=1e-6, atol=1e-7)


def test_quant_weight_and_activation_helpers_match_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero channel: scale 1
    jq, js = j8._quant_weight_per_channel(jnp.asarray(w))
    tq, ts = t8._quant_weight_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1] == 1.0
    h = np.abs(rng.normal(size=(5, 7, 3, 4)) * 40).astype(np.float32)
    h[0, 0, 0, :3] = [0.5, 1.5, 2.5]  # ties round to even
    h[0, 0, 1, 0] = 1e6  # saturates at 127
    inv = np.float32(1.0)
    want = np.asarray(j8._pool2_int8(j8._quant_act(jnp.asarray(h), inv), 1))
    got = kw8.pool2_int8(kw8.quant_act(torch.from_numpy(h), inv), 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 3, 3, 4)  # the odd seventh row dropped
    np.testing.assert_array_equal(kw8.quant_act(torch.from_numpy(h), inv).numpy()[0, 0, 0, :3], [0, 2, 2])


@jax.jit
def _jax_block(x, w, deq, b, inv_s):
    acc = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=DN,
                                       preferred_element_type=jnp.int32)
    h = jnp.maximum(acc.astype(jnp.float32) * deq + b, 0.0)
    return acc, h, j8._pool2_int8(j8._quant_act(h, inv_s), 1)


@pytest.mark.parametrize("block", [2, 3])
def test_int8_blocks_match_jax(folds, block):
    """Each int8 block from one int8 input (post-ReLU codes in [0, 127]) and
    JAX's folded values: equal accumulators, then the epilogues."""
    jf8, _ = folds
    rng = np.random.default_rng(3 + block)
    w = np.asarray(jf8[f"w{block}q"])
    x = rng.integers(0, 128, size=(B_, T_ // (2 * (block - 1)), F_, w.shape[2])).astype(np.int8)
    x[0, 0, 0] = 127  # saturating codes
    deq, b = np.asarray(jf8[f"deq{block}"]), np.asarray(jf8[f"b{block}"])
    inv_s = np.asarray(jf8["inv_s2"])
    acc, h, q = (np.asarray(a) for a in _jax_block(x, w, deq, b, inv_s))
    tx, tw, tdeq, tb = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w, deq, b))
    got_acc = kw8.int8_conv_acc(tx, tw).numpy()
    np.testing.assert_array_equal(got_acc, acc)
    # JAX's jitted epilogue is one FMA: relu(fma(acc, deq, b))
    fma = np.maximum((acc.astype(np.float64) * deq + b).astype(np.float32), 0)
    np.testing.assert_array_equal(h, fma)
    got_h = kw8.conv_block_w8a8(tx, tw, tdeq, tb).numpy()
    np.testing.assert_array_equal(got_h, np.maximum(acc.astype(np.float32) * deq + b, 0))  # two roundings
    prod = np.abs(acc.astype(np.float32) * deq)
    assert (np.abs(got_h - h) <= np.spacing(prod) / 2 + np.spacing(np.abs(h))).all()
    if block == 2:
        got_q = kw8.conv_block_w8a8(tx, tw, tdeq, tb, inv_s).numpy()
        assert got_q.dtype == np.int8 and got_q.shape == q.shape
        moved = got_q != q
        assert moved.mean() <= MAX_MOVED and np.abs(got_q.astype(int) - q).max() <= 1


def test_block1_matches_jax(cnn2d, folds):
    """Block 1 (f32 conv of f32 features, the epilogue, the int8 pool)
    against JAX's on the same folded values and features."""
    _, _, feats = cnn2d
    jf8, _ = folds
    x = np.swapaxes(feats, 1, 2)  # (B, T, F)
    h = jax.lax.conv_general_dilated(jnp.asarray(x)[..., None], jnp.asarray(jf8["w1"]), (1, 1), "SAME",
                                     dimension_numbers=DN, preferred_element_type=jnp.float32)
    want = np.asarray(j8._pool2_int8(j8._quant_act(jnp.maximum(h + jf8["b1"], 0.0), jf8["inv_s1"]), 1))
    tf8 = {k: torch.from_numpy(np.asarray(v)) for k, v in jf8.items()}
    got = t8.block1_w8a8(tf8, torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == want.shape == (B_, T_ // 2, F_, BC)
    moved = got != want
    assert moved.mean() <= MAX_MOVED and np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block1_plain_matches_jax_in_both_dtypes(cnn2d, folds, dtype):
    """Block 1's plain version (the kernels' tap order) in each compute
    dtype against JAX's block 1 in that dtype (an XLA conv with f32
    accumulation): codes within one step at <= 0.1% of positions."""
    _, _, feats = cnn2d
    jf8, _ = folds
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.swapaxes(feats, 1, 2)  # (B, T, F)
    h = jax.lax.conv_general_dilated(jnp.asarray(x).astype(jdt)[..., None], jnp.asarray(jf8["w1"]).astype(jdt),
                                     (1, 1), "SAME", dimension_numbers=DN, preferred_element_type=jnp.float32)
    want = np.asarray(j8._pool2_int8(j8._quant_act(jnp.maximum(h + jf8["b1"], 0.0), jf8["inv_s1"]), 1))
    tf8 = {k: torch.from_numpy(np.asarray(v)) for k, v in jf8.items()}
    got = kw8.block1_w8a8(torch.from_numpy(feats).transpose(1, 2), tf8["w1"], tf8["b1"], tf8["inv_s1"], tdt).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape == (B_, T_ // 2, F_, BC)
    moved = got != want
    assert moved.mean() <= MAX_MOVED and np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block1_conv_sums_taps_in_order(dtype):
    """``block1_conv_f32`` is the f32 block-1 kernel's arithmetic: per conv
    output, the 9 taps in order (dy, dx), each product and each sum rounded
    in f32, the SAME padding zeros included (numpy, written out)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 1, 4)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xr, wr = (torch.from_numpy(a).to(tdt).float().numpy() for a in (x, w))
    xp = np.pad(xr, ((0, 0), (1, 1), (1, 1)))[..., None]
    want = None
    for dy in range(3):
        for dx in range(3):
            term = (xp[:, dy:dy + 7, dx:dx + 5] * wr[dy, dx, 0]).astype(np.float32)
            want = term if want is None else (want + term).astype(np.float32)
    got = kw8.block1_conv_f32(torch.from_numpy(x), torch.from_numpy(w), tdt).numpy()
    np.testing.assert_array_equal(got, want)


def test_mean_mode_plain_matches_jax(folds):
    """Block 3's mean mode (the plain version) from one int8 input and JAX's
    folded values against JAX's block 3 followed by ``jnp.mean(h, axis=1)``:
    within the rounding of T f32 additions, the scale's, and JAX's FMA
    epilogue (the product's rounding, module docstring)."""
    jf8, _ = folds
    rng = np.random.default_rng(9)
    w = np.asarray(jf8["w3q"])
    x = rng.integers(0, 128, size=(B_, T_ // 4, F_, w.shape[2])).astype(np.int8)
    deq, b = np.asarray(jf8["deq3"]), np.asarray(jf8["b3"])
    acc, h, _ = (np.asarray(a) for a in _jax_block(x, w, deq, b, np.asarray(jf8["inv_s2"])))
    want = np.asarray(jnp.mean(jnp.asarray(h), axis=1))
    tx, tw, tdeq, tb = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w, deq, b))
    got = kw8.conv_block_w8a8(tx, tw, tdeq, tb, time_mean=True).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (B_, F_, w.shape[3])
    t = x.shape[1]
    prod = np.abs(acc.astype(np.float32) * deq)
    bound = (t + 3) * 2.0**-24 * want + np.spacing(prod).max(axis=1)
    assert (np.abs(got - want) <= bound).all()
    # the stated order: t = 0, 1, ... summed in f32, times float32(1 / T)
    h_port = kw8.conv_block_w8a8(tx, tw, tdeq, tb).numpy()
    s = np.zeros_like(h_port[:, 0])
    for i in range(t):
        s = (s + h_port[:, i]).astype(np.float32)
    np.testing.assert_array_equal(got, s * np.float32(1.0 / t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_from_mean_equals_head(folds, dtype):
    """``cnn2d_head_from_mean`` of the f32 mean over time is ``cnn2d_head``."""
    _, tf8 = folds
    h = torch.from_numpy(np.random.default_rng(12).random((3, 9, F_, 4 * BC), dtype=np.float32))
    tdt = getattr(torch, dtype)
    for sig in (True, False):
        want = cnn2d_head(h, tf8, sig, tdt)
        assert torch.equal(cnn2d_head_from_mean(h.mean(dim=1, dtype=torch.float32), tf8, sig, tdt), want)


def test_plain_block_equals_int64_conv():
    """``reference_conv_block_w8a8``'s accumulators against an int64 conv
    written out, and its refusal where f32 sums stop being exact."""
    rng = np.random.default_rng(7)
    x = rng.integers(-128, 128, size=(2, 5, 9, 64)).astype(np.int8)
    w = rng.integers(-128, 128, size=(3, 3, 64, 8)).astype(np.int8)
    x[0], w[..., 0] = -128, -128  # the largest products: |acc| = 9 * 64 * 2^14
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(np.einsum("bhwc,co->bhwo", xp[:, dy:dy + 5, dx:dx + 9], w[dy, dx].astype(np.int64))
               for dy in range(3) for dx in range(3))
    got = kw8.int8_conv_acc(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and np.abs(want).max() == 9 * 64 * 2**14
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not be exact"):
        kw8.int8_conv_acc(torch.zeros(1, 3, 3, kw8.MAX_CIN_F32_EXACT + 1, dtype=torch.int8),
                          torch.zeros(3, 3, kw8.MAX_CIN_F32_EXACT + 1, 2, dtype=torch.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["stored", "tf", "q8"])
def test_scores_match_jax(cnn2d, folds, dtype, form):
    _, _, feats = cnn2d
    jf8, tf8 = folds
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if form == "stored":
        want = j8.cnn2d_w8a8_scores(jf8, jnp.asarray(feats), compute_dtype=jdt)
        got = t8.cnn2d_w8a8_scores(tf8, torch.from_numpy(feats), compute_dtype=tdt)
    elif form == "tf":
        x = np.ascontiguousarray(np.swapaxes(feats, 1, 2))
        want = j8.cnn2d_w8a8_scores_tf(jf8, jnp.asarray(x), compute_dtype=jdt)
        got = t8.cnn2d_w8a8_scores_tf(tf8, torch.from_numpy(x), compute_dtype=tdt)
    else:
        from dfac_tpu_torch.io.fastcast import quant_i8

        q, s = quant_i8(feats)
        want = j8.cnn2d_w8a8_scores_q8(jf8, jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), compute_dtype=jdt)
        got = t8.cnn2d_w8a8_scores_q8(tf8, q, s, compute_dtype=tdt)
    assert got.shape == (B_,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


def test_scores_track_the_ports_f32_chain(cnn2d, folds):
    _, sd, feats = cnn2d
    _, tf8 = folds
    ref = tfast.cnn2d_fast_scores(tfast.fold_cnn2d(sd), torch.from_numpy(feats), compute_dtype=torch.float32)
    got = t8.cnn2d_w8a8_scores(tf8, torch.from_numpy(feats), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-2)


def test_w8a8_preserves_eer():
    """``tests/test_fast_infer_int8.py::test_w8a8_preserves_eer``'s split,
    trained by the port's trainer: the w8a8 EER (with and without int8
    ingest) within 0.1% absolute of the f32 eval model's."""
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    n = 64
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, 16, 24)).astype(np.float32)
    feats[labels == 1, :8] += 1.5
    ds = ArrayDataset([f"t{i}" for i in range(n)], feats, labels)
    trainer = Trainer(TrainConfig(model="cnn2d", in_features=16, batch_size=16, epochs=2, lr=2e-3), device="cpu")
    trainer.fit(ds, ds)
    sd = trainer.model.state_dict()
    eer32, _ = calculate_eer(predict_scores(trainer.model.eval(), ds, 16), labels)
    cpu = torch.device("cpu")
    for ingest_int8 in (False, True):
        scores = t8.predict_scores_w8a8(sd, ds, cpu, batch_size=16, ingest_int8=ingest_int8)
        eer8, _ = calculate_eer(scores, labels)
        assert abs(eer8 - eer32) <= 0.001


# -- predict --fast --int8 [--ingest-int8] against the JAX CLI, on one JAX-written checkpoint ------------------

@pytest.fixture(scope="module")
def served(cnn2d, tmp_path_factory):
    variables, _, feats = cnn2d
    root = tmp_path_factory.mktemp("int8cli")
    n = 20  # at --batch-size 8: a padded tail
    rows = np.concatenate([feats, feats[: n - B_] * 0.5])
    uttids = [f"u{i:03d}" for i in range(n)]
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in rows]}).to_pickle(root / "f.pkl")
    jsave_checkpoint(str(root / "cnn2d.ckpt"), variables, config={"model": "cnn2d"})
    return root


def predict_both(root, *flags, model="cnn2d"):
    common = ["--features", str(root / "f.pkl"), "--checkpoint", str(root / f"{model}.ckpt"), "--model", model,
              "--in-features", str(F_), "--batch-size", "8", *flags]
    tpredict.main(common + ["--out", str(root / "t.pkl"), "--device", "cpu"])
    jpredict.main(common + ["--out", str(root / "j.pkl")])
    t, j = pd.read_pickle(root / "t.pkl"), pd.read_pickle(root / "j.pkl")
    assert t["uttid"].tolist() == j["uttid"].tolist() and len(t) == 20
    return t["predictions"].to_numpy(), j["predictions"].to_numpy()


@pytest.mark.parametrize("flags", [["--int8"], ["--int8", "--bf16"], ["--int8", "--ingest-int8"]])
def test_predict_cli_int8_matches_jax(served, flags):
    t, j = predict_both(served, "--fast", *flags)
    np.testing.assert_allclose(t, j, atol=1e-2)


@pytest.mark.parametrize("flags", [
    ["--ingest-int8"],
    ["--int8"],
    ["--fast", "--int8", "--model", "cnn1d"],
    ["--fast", "--int8", "--data-parallel", "2"],
    ["--fast", "--int8", "--multihost"],
])
def test_predict_cli_refusals_keep_jax_messages(served, flags):
    argv = ["--features", str(served / "f.pkl"), "--checkpoint", str(served / "cnn2d.ckpt"), "--model", "cnn2d",
            "--out", str(served / "x.pkl"), *flags]
    with pytest.raises(SystemExit) as t:
        tpredict.main(argv)
    with pytest.raises(SystemExit) as j:
        jpredict.main(argv)
    assert str(t.value) == str(j.value) and "--" in str(t.value)
