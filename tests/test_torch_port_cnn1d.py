"""PyTorch port of CNN1D (model, BN folding, serving chain, training and
its CLIs) against the JAX package, on the CPU.

Weights are made by the JAX package (flax init, then BatchNorm statistics
randomized with numpy as ``tests/test_fast_infer.py:151-156`` does) and
carried over with ``state_dict_from_jax``. Tolerances are the JAX
package's own (``tests/test_fast_infer.py:158-177``): the f32 model and
chain atol 1e-5, the bf16 chain atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import evaluate as jevaluate
from dfac_tpu.cli import predict as jpredict
from dfac_tpu.data.pipeline import ArrayDataset as JArrayDataset
from dfac_tpu.data.pipeline import load_dataset as jload_dataset
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.train.loop import TrainConfig as JTrainConfig
from dfac_tpu.train.loop import Trainer as JTrainer
from dfac_tpu_torch.cli import evaluate as tevaluate
from dfac_tpu_torch.cli import predict as tpredict
from dfac_tpu_torch.cli import train as ttrain
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.data.pipeline import load_dataset as tload_dataset
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

F_, T_, BC = 20, 33, 8
CPU = torch.device("cpu")


def randomize_bn(variables, seed=0):
    """``tests/test_fast_infer.py:151-156``'s statistics, plus affine BN parameters."""
    rng = np.random.default_rng(seed)
    for name, d in variables["batch_stats"].items():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
        p = variables["params"][name]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.uniform(-0.1, 0.1, p["bias"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def jax_cnn1d():
    """(flax module, numpy variables) with randomized BN, once for the module."""
    model = jbuild("cnn1d", in_channels=F_, base_channels=BC)
    variables = model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_)))
    return model, randomize_bn(jax.tree.map(np.asarray, variables), 0)


def torch_cnn1d(variables):
    model = tbuild("cnn1d", in_features=F_, base_channels=BC).eval()
    model.load_state_dict(state_dict_from_jax(variables, "cnn1d"))
    return model


def _feats(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_state_dict_names_and_round_trip(jax_cnn1d):
    _, variables = jax_cnn1d
    sd = state_dict_from_jax(variables, "cnn1d")
    ref = tbuild("cnn1d", in_features=F_, base_channels=BC).state_dict()
    assert list(sd) == list(ref)
    assert {k.rsplit(".", 1)[0] for k in sd} == {
        "conv.0", "conv.1", "conv.4", "conv.5", "conv.8", "conv.9", "classifier"
    }
    back = jax_from_state_dict(sd, "cnn1d")  # jax -> torch -> jax
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


def test_eval_model_matches_jax_apply(jax_cnn1d):
    jmodel, variables = jax_cnn1d
    x = _feats((3, T_, F_))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_cnn1d(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swap_tf", [True, False])
def test_fast_chain_matches_jax_chain_and_model(jax_cnn1d, dtype, swap_tf):
    jmodel, variables = jax_cnn1d
    x_tf = _feats((4, T_, F_), seed=2)
    x = np.ascontiguousarray(np.swapaxes(x_tf, 1, 2)) if swap_tf else x_tf
    want = np.asarray(jfast.cnn1d_fast_scores(jfast.fold_cnn1d(variables), jnp.asarray(x), swap_tf=swap_tf,
                                              compute_dtype=getattr(jnp, dtype)))
    folded = tfast.fold_cnn1d(torch_cnn1d(variables).state_dict())
    got = tfast.cnn1d_fast_scores(folded, torch.from_numpy(x), swap_tf, compute_dtype=getattr(torch, dtype)).numpy()
    ref = np.asarray(jax.nn.sigmoid(jmodel.apply(variables, jnp.asarray(x_tf))[:, 0]))
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, ref, atol=atol)


def test_fold_matches_jax_in_torch_layout(jax_cnn1d):
    _, variables = jax_cnn1d
    want = jfast.fold_cnn1d(variables)
    got = tfast.fold_cnn1d(torch_cnn1d(variables).state_dict())
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        if k in ("w1", "w2", "w3"):
            g = np.transpose(g, (2, 1, 0))  # (O, I, k) -> JAX's (k, I, O)
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_predict_scores_fast_cnn1d_keeps_order_and_drops_padding(jax_cnn1d):
    _, variables = jax_cnn1d
    feats = _feats((11, F_, T_), seed=3)  # 11 rows at B=4: a padded tail
    ds = ArrayDataset(uttids=[str(i) for i in range(11)], features=feats)
    sd = torch_cnn1d(variables).state_dict()
    got = tfast.predict_scores_fast_cnn1d(sd, ds, CPU, batch_size=4, compute_dtype=torch.float32)
    jds = JArrayDataset(uttids=ds.uttids, features=ds.features)
    want = np.asarray(jfast.predict_scores_fast_cnn1d(variables, jds, batch_size=4,
                                                      compute_dtype=jnp.float32))
    assert got.shape == (11,)
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- training and the CLIs, both checkpoint directions -------------------------------------------

def _write_split(root, name, n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, F_, T_)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int64)
    feats[labels == 1, :4] += 1.0
    uttids = [f"{name}_{i:03d}" for i in range(n)]
    d = root / name
    d.mkdir()
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(d / "features.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(d / "labels.pkl")
    return str(d / "features.pkl"), str(d / "labels.pkl")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus1d")
    return {"train": _write_split(root, "train", 24, 0), "dev": _write_split(root, "dev", 20, 1)}


def _predict_both(corpus, ckpt, tmp_path, *extra):
    common = ["--features", corpus["dev"][0], "--checkpoint", str(ckpt), "--model", "cnn1d",
              "--in-features", str(F_), "--batch-size", "8", *extra]  # 20 rows: a padded tail
    tpredict.main(common + ["--out", str(tmp_path / "t.pkl"), "--device", "cpu"])
    jpredict.main(common + ["--out", str(tmp_path / "j.pkl")])
    t, j = pd.read_pickle(tmp_path / "t.pkl"), pd.read_pickle(tmp_path / "j.pkl")
    assert t["uttid"].tolist() == j["uttid"].tolist() and len(t) == 20
    return t["predictions"].to_numpy(), j["predictions"].to_numpy()


def test_port_trained_checkpoint_served_by_jax(corpus, tmp_path, capsys):
    args = ["--train-features", corpus["train"][0], "--train-labels", corpus["train"][1],
            "--dev-features", corpus["dev"][0], "--dev-labels", corpus["dev"][1], "--device", "cpu",
            "--model", "cnn1d", "--in-features", str(F_), "--batch-size", "8", "--epochs", "1",
            "--checkpoint-dir", str(tmp_path / "ck")]
    result = ttrain.main(args)
    ckpt = tmp_path / "ck" / "cnn1d_best.ckpt"
    assert ckpt.exists() and (tmp_path / "ck" / "cnn1d_last.ckpt").exists()
    t, j = _predict_both(corpus, ckpt, tmp_path)
    np.testing.assert_allclose(t, j, atol=1e-5)
    capsys.readouterr()
    common = ["--features", corpus["dev"][0], "--labels", corpus["dev"][1], "--checkpoint", str(ckpt),
              "--model", "cnn1d", "--in-features", str(F_), "--batch-size", "8"]
    tevaluate.main(common + ["--device", "cpu"])
    got = dict(line.split("=", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert float(got["eer"]) == result["best_eer"]
    jevaluate.main(common)
    want = dict(line.split("=", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert got["eer"] == want["eer"]
    np.testing.assert_allclose(float(got["avg_loss"]), float(want["avg_loss"]), rtol=1e-5)


@pytest.fixture(scope="module")
def jax_checkpoint(corpus, tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("jck")
    cfg = JTrainConfig(model="cnn1d", batch_size=8, epochs=1, in_features=F_, seed=0)
    JTrainer(cfg).fit(jload_dataset(*corpus["train"]), jload_dataset(*corpus["dev"]), checkpoint_dir=str(ckdir))
    return ckdir / "cnn1d_best.ckpt"


@pytest.mark.parametrize("fast", [[], ["--fast"], ["--fast", "--bf16"]])
def test_jax_trained_checkpoint_served_by_port(corpus, jax_checkpoint, tmp_path, fast):
    t, j = _predict_both(corpus, jax_checkpoint, tmp_path, *fast)
    np.testing.assert_allclose(t, j, atol=2e-2 if "--bf16" in fast else 1e-5)


def test_two_epochs_match_jax_trainer(corpus):
    """CNN1D through both trainers from the JAX init, dropout 0 and no
    augmentation (their draws come from different generators):
    ``tests/test_torch_port_train.py``'s bounds, losses rtol 1e-3, the dev
    EER equal."""
    kw = dict(model="cnn1d", batch_size=8, epochs=2, dropout=0.0, seed=0, in_features=F_, label_smoothing=0.05)
    jtrainer = JTrainer(JTrainConfig(**kw))
    jtrainer.init_state(jload_dataset(*corpus["train"]).features[:8])
    init = jax.tree.map(np.asarray, jtrainer.variables())
    want = jtrainer.fit(jload_dataset(*corpus["train"]), jload_dataset(*corpus["dev"]))["history"]
    ttrainer = tloop.Trainer(tloop.TrainConfig(**kw), device="cpu")
    ttrainer.init_state(state_dict_from_jax(init, "cnn1d"))
    got = ttrainer.fit(tload_dataset(*corpus["train"]), tload_dataset(*corpus["dev"]))["history"]
    assert [m.epoch for m in got] == [m.epoch for m in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=1e-3)
        np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=1e-3)
        assert g.dev_eer == w.dev_eer
