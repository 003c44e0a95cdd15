"""Host ingest: ``dfac_tpu_torch.io.fastcast`` and ``--ingest-int8`` against
the JAX package on the CPU.

Every fastcast function equals the JAX package's bit for bit, both its
native kernel and its numpy fallback (``_quant_i8_numpy``), on random
values, specials (the bf16 cast: infinities, NaNs of either sign and with
payloads, signed zeros, subnormals, ties, values that round to infinity),
all-zero and constant groups, memory-mapped sources; out-of-range and
negative gather indices raise the same IndexError. The int8-ingest chains
(CNN2D, CNN1D; both orientations) against JAX's ``*_q8`` chains: f32
within 1e-5 and bf16 within 2e-2 (the port's existing bounds for its f32
and bf16 chains against JAX's); ``predict --fast --ingest-int8`` against
the JAX CLI on one JAX-written checkpoint within the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import predict as jpredict
from dfac_tpu.data.pipeline import ArrayDataset as JArrayDataset
from dfac_tpu.io import fastcast as jcast
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from dfac_tpu_torch.cli import predict as tpredict
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.io import fastcast as tcast
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.utils.convert import state_dict_from_jax

F_, T_, B_, BC = 20, 33, 16, 8
CPU = torch.device("cpu")


def bits16(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def corpus(seed=0, n=B_):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, F_, T_)) * rng.uniform(1e-3, 1e2, (n, F_, 1))).astype(np.float32)
    a[0, 0] = 0.0  # an all-zero group: scale 1
    a[1, 1] = 3.5  # a constant group
    a[1, 2] = -2.0
    a[2, 3, :5] = np.float32(1e-40)  # subnormals
    a[3, 4, 0] = -a[3, 4].max() * 2  # the group's amax negative
    return a


SPECIALS = np.concatenate([
    np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1e-45, -1e-45, 3.3895314e38, 3.4e38, -3.4e38,
              1.00390625, 1.01171875, -1.00390625, 1.0 + 2.0**-8 + 2.0**-9], np.float32),
    np.array([0x7F800001, 0xFFA00000, 0x7FBFFFFF, 0x7FC00001], np.uint32).view(np.float32),  # NaN payloads
])


@pytest.mark.parametrize("src", ["random", "specials", "memmap"])
def test_cast_bf16_bit_for_bit(src, tmp_path):
    a = {"random": corpus(), "specials": SPECIALS}.get(src)
    if src == "memmap":
        np.save(tmp_path / "a.npy", corpus(1))
        a = np.load(tmp_path / "a.npy", mmap_mode="r")
    want = jcast.cast_bf16(a).view(np.uint16)
    got = tcast.cast_bf16(a)
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    np.testing.assert_array_equal(bits16(got), want)
    import ml_dtypes

    with np.errstate(invalid="ignore"):  # NaN through ml_dtypes' cast
        np.testing.assert_array_equal(bits16(got), np.asarray(a).astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("shape", [(B_, F_, T_), (7, T_), (2, 3, 4, 5)])
def test_quant_i8_bit_for_bit(shape):
    a = corpus(2)[: shape[0]].reshape(-1)[: int(np.prod(shape))].reshape(shape).copy()
    a.reshape(-1, shape[-1])[0] = 0.0
    a.reshape(-1, shape[-1])[1] = 1.5
    jq, js = jcast.quant_i8(a)
    nq, ns = jcast._quant_i8_numpy(a)
    tq, ts = tcast.quant_i8(a)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == shape[:-1]
    for q, s in ((jq, js), (nq, ns)):
        np.testing.assert_array_equal(tq.numpy(), q)
        np.testing.assert_array_equal(ts.numpy().view(np.int32), s.view(np.int32))
    assert ts.reshape(-1)[0] == 1.0 and (tq.reshape(-1, shape[-1])[0] == 0).all()
    assert (tq.reshape(-1, shape[-1])[1] == 127).all()


def test_quant_i8_ties_round_to_even():
    """Rows whose amax is 127 (scale exactly 1): q = rint(a)."""
    a = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5]], np.float32)
    tq, ts = tcast.quant_i8(a)
    assert ts.item() == 1.0
    np.testing.assert_array_equal(tq.numpy(), [[127, 0, 2, 2, 0, -2, -126]])
    np.testing.assert_array_equal(tq.numpy(), jcast.quant_i8(a)[0])


def test_gathers_bit_for_bit_from_a_memmap(tmp_path):
    np.save(tmp_path / "c.npy", corpus(3, n=12))
    src = np.load(tmp_path / "c.npy", mmap_mode="r")
    idx = np.array([11, 0, 5, 5, 3])
    np.testing.assert_array_equal(tcast.gather_f32(src, idx).numpy(), jcast.gather_f32(src, idx))
    np.testing.assert_array_equal(bits16(tcast.gather_cast_bf16(src, idx)),
                                  jcast.gather_cast_bf16(src, idx).view(np.uint16))
    (tq, ts), (jq, js) = tcast.gather_quant_i8(src, idx), jcast.gather_quant_i8(src, idx)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert tcast.gather_f32(src, []).shape == (0, F_, T_)


@pytest.mark.parametrize("fn", ["gather_f32", "gather_cast_bf16", "gather_quant_i8"])
@pytest.mark.parametrize("idx", [[0, 12], [-1], [3, -13]])
def test_gathers_refuse_out_of_range_indices_as_jax(fn, idx):
    src = corpus(4, n=12)
    with pytest.raises(IndexError) as t:
        getattr(tcast, fn)(src, idx)
    with pytest.raises(IndexError) as j:
        getattr(jcast, fn)(src, idx)
    assert str(t.value) == str(j.value)
    np.testing.assert_array_equal(tcast._checked_idx([2, 0], 3), jcast._checked_idx([2, 0], 3))


def test_threads_argument_is_scoped():
    before = torch.get_num_threads()
    a = corpus(5)
    np.testing.assert_array_equal(bits16(tcast.cast_bf16(a, threads=2)), bits16(tcast.cast_bf16(a)))
    np.testing.assert_array_equal(tcast.quant_i8(a, threads=1)[0].numpy(), tcast.quant_i8(a)[0].numpy())
    assert torch.get_num_threads() == before


# -- the int8-ingest chains ---------------------------------------------------------------------------------------

def randomize_bn(variables, seed=0):
    rng = np.random.default_rng(seed)
    for name, d in variables["batch_stats"].items():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
        p = variables["params"][name]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.uniform(-0.1, 0.1, p["bias"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def models():
    """{name: (numpy JAX variables, the port's state_dict)} for CNN2D and CNN1D."""
    out = {}
    for name, kw in (("cnn2d", {"in_features": F_}), ("cnn1d", {"in_channels": F_})):
        model = jbuild(name, base_channels=BC, **kw)
        variables = model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_)))
        variables = randomize_bn(jax.tree.map(np.asarray, variables), 1)
        out[name] = (variables, state_dict_from_jax(variables, name))
    return out


TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swap_tf", [True, False])
@pytest.mark.parametrize("name", ["cnn2d", "cnn1d"])
def test_q8_chains_match_jax(models, name, swap_tf, dtype):
    variables, sd = models[name]
    feats = corpus(6)
    if not swap_tf:
        feats = np.ascontiguousarray(np.swapaxes(feats, 1, 2))
    q, s = tcast.quant_i8(feats)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if name == "cnn2d":
        want = jfast.cnn2d_fast_scores_q8(jfast.fold_cnn2d(variables), jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                          swap_tf=swap_tf, compute_dtype=jdt)
        folded = tfast.fold_cnn2d(sd)
        got = tfast.cnn2d_fast_scores_q8(folded, q, s, swap_tf, compute_dtype=tdt)
    else:
        want = jfast.cnn1d_fast_scores_q8(jfast.fold_cnn1d(variables), jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                          swap_tf=swap_tf, compute_dtype=jdt)
        folded = tfast.on_device(tfast.fold_cnn1d(sd), CPU, tdt)
        got = tfast.cnn1d_fast_scores_q8(folded, q, s, swap_tf, compute_dtype=tdt)
    assert got.shape == (B_,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[dtype])


def test_ingest_q8_and_dequant():
    feats = corpus(7)
    q, s = tfast.ingest_q8(feats, CPU)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.device.type == "cpu"
    x = tfast.dequant8(q, s, torch.float32)
    bound = s[..., None] / 2 + torch.from_numpy(np.spacing(np.abs(feats)))  # half a step, and q * s's rounding
    assert (torch.from_numpy(feats) - x).abs().le(bound).all()


@pytest.mark.parametrize("name", ["cnn2d", "cnn1d"])
def test_predict_scores_fast_ingest_int8_matches_jax_on_a_store(models, name, tmp_path):
    from dfac_tpu_torch.io.npy_store import load_npy_dataset, save_npy_dataset

    variables, sd = models[name]
    feats = corpus(8, n=11)  # 11 rows at B=4: a padded tail
    save_npy_dataset(ArrayDataset(uttids=[str(i) for i in range(11)], features=feats), str(tmp_path / "s"))
    ds = load_npy_dataset(str(tmp_path / "s"))
    fast = {"cnn2d": (tfast.predict_scores_fast, jfast.predict_scores_fast),
            "cnn1d": (tfast.predict_scores_fast_cnn1d, jfast.predict_scores_fast_cnn1d)}[name]
    got = fast[0](sd, ds, CPU, batch_size=4, compute_dtype=torch.float32, ingest_int8=True)
    want = fast[1](variables, JArrayDataset(uttids=ds.uttids, features=feats), batch_size=4,
                   compute_dtype=jnp.float32, ingest_int8=True)
    assert got.shape == (11,)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flags", [["--ingest-int8"], ["--ingest-int8", "--bf16"]])
@pytest.mark.parametrize("name", ["cnn2d", "cnn1d"])
def test_predict_cli_ingest_int8_matches_jax(models, name, flags, tmp_path):
    variables, _ = models[name]
    feats = corpus(9, n=20)
    uttids = [f"u{i:03d}" for i in range(20)]
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(tmp_path / "f.pkl")
    jsave_checkpoint(str(tmp_path / "m.ckpt"), variables, config={"model": name})
    common = ["--features", str(tmp_path / "f.pkl"), "--checkpoint", str(tmp_path / "m.ckpt"), "--model", name,
              "--in-features", str(F_), "--batch-size", "8", "--fast", *flags]
    tpredict.main(common + ["--out", str(tmp_path / "t.pkl"), "--device", "cpu"])
    jpredict.main(common + ["--out", str(tmp_path / "j.pkl")])
    t, j = pd.read_pickle(tmp_path / "t.pkl"), pd.read_pickle(tmp_path / "j.pkl")
    assert t["uttid"].tolist() == j["uttid"].tolist() == uttids
    np.testing.assert_allclose(t["predictions"].to_numpy(), j["predictions"].to_numpy(),
                               atol=TOL["bfloat16" if "--bf16" in flags else "float32"])
