"""``--bf16`` in the port's CLIs and the ``--no-swap-tf`` width fault, on
the CPU against the JAX CLIs (24 / 16 utterances of 12 features and 16
frames, B=8).

* ``train --no-swap-tf`` (CNN2D, CNN1D): the model sees (B, F, T), so its
  input width is T. The JAX modules read it from the data; the port builds
  its model for the first batch's width (``Trainer.init_state``) and reads
  a checkpoint's widths from its weights. From the same init (the JAX
  trainer's, carried across), with dropout 0: the epoch losses within rtol
  1e-3 and the dev EER equal (``tests/test_torch_port_train.py``'s
  bounds); ``predict --no-swap-tf`` on the port's checkpoint within 1e-5 of
  the JAX CLI's.
* ``train --bf16`` (CNN2D, CNN1D) from the same init: the epoch losses
  within rtol 2e-2 of the JAX CLI's (two bf16 trainers,
  ``tests/test_torch_port_bf16.py``'s step bound).
* ``predict --bf16`` without ``--fast``: the eval model with bf16 layers,
  within 2e-2 of the JAX CLI's on the same checkpoint, and of ``predict
  --fast --bf16``.
* ``train_detector --bf16`` trains, and the JAX CLI scores its checkpoint
  as the port's plain scoring does; ``reproduce_reference --bf16`` runs.
"""

import numpy as np
import pandas as pd
import pytest
from test_reproduce_reference import reference_shaped_data  # noqa: F401 (a fixture)
from test_torch_port_zoo_cli import assert_same_history, data_args, shared_init, write_split

from dfac_tpu.cli import predict as jpredict
from dfac_tpu.cli import train as jtrain
from dfac_tpu.cli import train_detector as jtrain_detector
from dfac_tpu_torch.cli import predict as tpredict
from dfac_tpu_torch.cli import reproduce_reference as trepro
from dfac_tpu_torch.cli import train as ttrain
from dfac_tpu_torch.cli import train_detector as ttrain_detector
from dfac_tpu_torch.train import checkpoint as tckpt

F_, T_, B = 12, 16, 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_corpus")
    splits = {"train": write_split(root, "train", 24, 0), "dev": write_split(root, "dev", 16, 1),
              "test2": write_split(root, "test2", 12, 2)}
    return {"root": root, **splits}


def _train_both(corpus, tmp_path, monkeypatch, model, *extra):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--model", model, "--batch-size", str(B), "--epochs", "2", "--dropout", "0",
            "--in-features", str(F_), "--quiet", *extra]
    want = jtrain.main(args + ["--checkpoint-dir", str(tmp_path / "j")])
    got = ttrain.main(args + ["--checkpoint-dir", str(tmp_path / "t"), "--device", "cpu"])
    return got, want


def _predict_both(corpus, ckpt, tmp_path, model, *extra):
    common = ["--features", corpus["dev"][0], "--checkpoint", str(ckpt), "--model", model, "--batch-size", "8",
              *extra]
    tpredict.main(common + ["--out", str(tmp_path / "t.pkl"), "--device", "cpu"])
    jpredict.main(common + ["--out", str(tmp_path / "j.pkl")])
    t, j = pd.read_pickle(tmp_path / "t.pkl"), pd.read_pickle(tmp_path / "j.pkl")
    assert t["uttid"].tolist() == j["uttid"].tolist()
    return t["predictions"].to_numpy(), j["predictions"].to_numpy()


@pytest.mark.parametrize("model", ["cnn2d", "cnn1d"])
def test_train_no_swap_tf_takes_the_width_from_the_data_as_jax(model, corpus, tmp_path, monkeypatch):
    # from the port's own init: the model is built for the first batch's width, T (the JAX variables' shape)
    alone = ttrain.main([*data_args(corpus), "--model", model, "--batch-size", str(B), "--epochs", "1",
                         "--no-swap-tf", "--quiet", "--checkpoint-dir", str(tmp_path / "alone"), "--device", "cpu"])
    assert np.isfinite(alone["history"][0].train_loss)
    params = tckpt.load_checkpoint(str(tmp_path / "alone" / f"{model}_last.ckpt"))["model_state"]["params"]
    width = params["classifier"]["dense"]["kernel"].shape[0] // 128 if model == "cnn2d" else \
        params["conv1"]["conv"]["kernel"].shape[1]
    assert width == T_
    got, want = _train_both(corpus, tmp_path, monkeypatch, model, "--no-swap-tf")
    assert_same_history(got["history"], want["history"])
    t, j = _predict_both(corpus, tmp_path / "t" / f"{model}_best.ckpt", tmp_path, model, "--no-swap-tf")
    np.testing.assert_allclose(t, j, atol=1e-5)


@pytest.mark.parametrize("model", ["cnn2d", "cnn1d"])
def test_train_bf16_matches_jax(model, corpus, tmp_path, monkeypatch):
    got, want = _train_both(corpus, tmp_path, monkeypatch, model, "--bf16")
    assert_same_history(got["history"], want["history"], rtol=2e-2, same_eer=False)
    assert all(np.isfinite(m.train_loss) for m in got["history"])
    ckpt = tmp_path / "t" / f"{model}_best.ckpt"
    t, j = _predict_both(corpus, ckpt, tmp_path, model, "--bf16")  # the eval model in bf16, no --fast
    np.testing.assert_allclose(t, j, atol=2e-2)
    t32, _ = _predict_both(corpus, ckpt, tmp_path, model)
    assert not np.array_equal(t, t32)  # bf16 layers, not the f32 model
    tpredict.main(["--features", corpus["dev"][0], "--checkpoint", str(ckpt), "--model", model, "--fast",
                   "--bf16", "--out", str(tmp_path / "fast.pkl"), "--device", "cpu"])
    np.testing.assert_allclose(pd.read_pickle(tmp_path / "fast.pkl")["predictions"], t, atol=2e-2)


def test_train_detector_bf16_trains_and_its_checkpoint_serves_in_jax(corpus, tmp_path, capsys):
    ckpt, pred = tmp_path / "det.ckpt", tmp_path / "p.pkl"
    common = ["--data-dir", str(corpus["root"]), "--hidden", "16", "--batch-size", str(B), "--ckpt-path", str(ckpt)]
    scores = ttrain_detector.main(common + ["--epochs", "2", "--bf16", "--prediction-pkl", str(pred),
                                            "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("Training done. Best dev EER: ") and lines[-1].startswith("EER on split 'test2': ")
    assert ckpt.exists() and np.isfinite(scores).all()
    f32 = ttrain_detector.main(common + ["--epochs", "0", "--prediction-pkl", str(tmp_path / "t.pkl"),
                                         "--device", "cpu"])
    jtrain_detector.main(common + ["--epochs", "0", "--prediction-pkl", str(tmp_path / "j.pkl")])
    np.testing.assert_allclose(pd.read_pickle(tmp_path / "j.pkl")["predictions"], f32, atol=1e-5)
    np.testing.assert_allclose(scores, f32, atol=5e-2)  # the trained bf16 model against the f32 one


def test_reproduce_reference_bf16_runs(reference_shaped_data, tmp_path):  # noqa: F811
    out = tmp_path / "repro_bf16"
    rc = trepro.main(["--data-dir", str(reference_shaped_data), "--out-dir", str(out), "--epochs", "1",
                      "--batch-size", "8", "--bf16", "--no-assert", "--device", "cpu"])
    assert rc == 0 and (out / "report.md").exists() and (out / "checkpoints" / "cnn2d_best.ckpt").exists()
    pred = pd.read_pickle(out / "prediction.pkl")
    assert pred["predictions"].between(0, 1).all()
