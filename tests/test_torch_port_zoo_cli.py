"""``train --model <zoo>`` and ``ensemble`` with zoo specs in the PyTorch
port against the JAX CLIs, on the CPU (24 / 16 utterances of 12 features
and 16 frames, B=8, 2 epochs, hidden 8).

Each pair of runs starts from the same weights: the JAX trainer's
``init_state`` is wrapped to record its variables, and the port's to load
them (``state_dict_from_jax``); with ``--dropout 0`` and no augmentation
both packages then compute the same function. Bounds are
``tests/test_torch_port_train.py``'s: the epoch losses within rtol 1e-3
and the dev EER equal. The shared helpers here serve the other CLI test
files of the port.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import ensemble as jensemble
from dfac_tpu.cli import train as jtrain
from dfac_tpu.train import loop as jloop
from dfac_tpu_torch.cli import ensemble as tensemble
from dfac_tpu_torch.cli import train as ttrain
from dfac_tpu_torch.train import loop as tloop
from dfac_tpu_torch.utils.convert import state_dict_from_jax

F_, T_, B = 12, 16, 8
ZOO = ["meanpool_mlp", "statspool_mlp", "cnn1d_spatial", "cnn1d_archive", "cnn2d_spatial", "crnn", "crnn2",
       "cnn2d_robust"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These torch fits are tiny: one intra-op thread a process runs them
    fastest, alone or beside other test processes (module scope, so the
    module's fixtures run pinned too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_split(root, name, n, seed, f=F_, t=T_):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, f, t)).astype(np.float32)
    labels = (np.arange(n) % 2).astype(np.int64)
    feats[labels == 1, : f // 3] += 1.0
    uttids = [f"{name}_{i:03d}" for i in range(n)]
    d = root / name
    d.mkdir()
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(d / "features.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(d / "labels.pkl")
    return str(d / "features.pkl"), str(d / "labels.pkl")


def data_args(corpus):
    return ["--train-features", corpus["train"][0], "--train-labels", corpus["train"][1],
            "--dev-features", corpus["dev"][0], "--dev-labels", corpus["dev"][1]]


def shared_init(monkeypatch):
    """Wrap both trainers' ``init_state``: the JAX one records its
    variables, the port's loads them, run by run in the same order."""
    inits = []
    j_init, t_init = jloop.Trainer.init_state, tloop.Trainer.init_state

    def record(self, example_batch):
        state = j_init(self, example_batch)
        inits.append(jax_variables(self))
        return state

    def load(self, state_dict=None, example_batch=None):
        return t_init(self, state_dict_from_jax(inits.pop(0), self.cfg.model))

    monkeypatch.setattr(jloop.Trainer, "init_state", record)
    monkeypatch.setattr(tloop.Trainer, "init_state", load)
    return inits


def jax_variables(trainer):
    import jax

    return jax.tree.map(np.asarray, trainer.variables())


def assert_same_history(got, want, rtol=1e-3, same_eer=True):
    assert [m.epoch for m in got] == [m.epoch for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.train_loss, w.train_loss, rtol=rtol)
        np.testing.assert_allclose(g.dev_loss, w.dev_loss, rtol=rtol)
        if same_eer:
            assert g.dev_eer == w.dev_eer


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_corpus")
    return {"train": write_split(root, "train", 24, 0), "dev": write_split(root, "dev", 16, 1)}


@pytest.mark.parametrize("model", ZOO)
def test_train_cli_zoo_matches_jax(model, corpus, tmp_path, monkeypatch):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--model", model, "--batch-size", str(B), "--epochs", "2", "--hidden-dim", "8",
            "--dropout", "0", "--in-features", str(F_), "--quiet"]
    want = jtrain.main(args + ["--checkpoint-dir", str(tmp_path / "j")])
    got = ttrain.main(args + ["--checkpoint-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert_same_history(got["history"], want["history"])
    assert got["best_eer"] == want["best_eer"]
    for kind in ("best", "last"):
        assert (tmp_path / "t" / f"{model}_{kind}.ckpt").exists()


def test_ensemble_cli_scores_zoo_checkpoints_as_jax_does(corpus, tmp_path, capsys):
    """Two zoo checkpoints the port trained at the registry's default
    widths (the JAX CLI builds those; the port reads them from the
    weights), one listed twice, scored by both ensemble CLIs."""
    specs = []
    for model in ("statspool_mlp", "crnn"):
        ttrain.main([*data_args(corpus), "--model", model, "--batch-size", str(B), "--epochs", "1", "--quiet",
                     "--checkpoint-dir", str(tmp_path), "--device", "cpu"])
        specs.append(f"{model}:{tmp_path / f'{model}_best.ckpt'}")
    specs.append(specs[0])
    capsys.readouterr()
    common = ["--features", corpus["dev"][0], "--labels", corpus["dev"][1], "--checkpoints", *specs,
              "--batch-size", "8"]
    tensemble.main(common + ["--device", "cpu", "--out", str(tmp_path / "t.pkl")])
    got = capsys.readouterr().out.splitlines()
    jensemble.main(common + ["--in-features", str(F_), "--out", str(tmp_path / "j.pkl")])
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    for g, w in zip(got[:4], want[:4]):
        assert g.split("EER=")[0] == w.split("EER=")[0]
        assert g.split("EER=")[1].split()[0] == w.split("EER=")[1].split()[0]
    t, j = pd.read_pickle(tmp_path / "t.pkl"), pd.read_pickle(tmp_path / "j.pkl")
    np.testing.assert_allclose(t["predictions"], j["predictions"], atol=1e-5)
