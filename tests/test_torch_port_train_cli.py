"""The port's training CLIs on the CPU (``--device cpu``): train ->
evaluate ``--checkpoint`` -> predict with and without ``--fast``, each
against the JAX package's CLI on the same checkpoint, and
``reproduce_reference`` on the fixture of
``tests/test_reproduce_reference.py``. Scores of two f32 chains on the
CPU agree within 1e-5 (BN folded and sums in another order, as
``tests/test_torch_port_slice.py``)."""

import os
import re

import numpy as np
import pandas as pd
import pytest
import torch
from test_reproduce_reference import reference_shaped_data  # noqa: F401 (a fixture)

from dfac_tpu.cli import evaluate as jevaluate
from dfac_tpu.cli import predict as jpredict
from dfac_tpu_torch.cli import evaluate as tevaluate
from dfac_tpu_torch.cli import predict as tpredict
from dfac_tpu_torch.cli import reproduce_reference as trepro
from dfac_tpu_torch.cli import train as ttrain

F_, T_ = 12, 16


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
    root = tmp_path_factory.mktemp("corpus")
    return {"train": _write_split(root, "train", 36, 0), "dev": _write_split(root, "dev", 20, 1)}


RECIPE = ["--spec-augment", "--time-mask-ratio", "0.20", "--feature-mask", "--feature-mask-ratio", "0.10",
          "--time-shift", "--time-shift-ratio", "0.10", "--channel-drop", "--channel-drop-prob", "0.05",
          "--gaussian-jitter", "--gaussian-jitter-std", "0.005", "--label-smoothing", "0.05",
          "--lr-scheduler", "plateau", "--lr-scheduler-metric", "dev_eer"]


def _train_args(corpus, ckdir, *extra):
    return ["--train-features", corpus["train"][0], "--train-labels", corpus["train"][1],
            "--dev-features", corpus["dev"][0], "--dev-labels", corpus["dev"][1], "--device", "cpu",
            "--in-features", str(F_), "--batch-size", "8", "--checkpoint-dir", str(ckdir), *extra]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("ck")
    result = ttrain.main(_train_args(corpus, ckdir, "--epochs", "2", "--run-name", "r", *RECIPE))
    return ckdir / "r", result


def test_train_cli_writes_both_checkpoints_and_prints_each_epoch(corpus, tmp_path, capsys):
    result = ttrain.main(_train_args(corpus, tmp_path, "--epochs", "2", "--debug-augment-stats", "--no-rich",
                                     *RECIPE))
    out = capsys.readouterr().out
    assert "[augment-stats] before:" in out and "[augment-stats] after: " in out
    # --no-rich: the tqdm visualizer's epoch lines, as the JAX CLI prints them
    assert len(re.findall(r"^Epoch \d: train_loss=\S+ dev_loss=\S+ dev_eer=\S+", out, re.M)) == 2
    assert f"best dev EER: {result['best_eer']:.6f}" in out
    assert (tmp_path / "cnn2d_best.ckpt").exists() and (tmp_path / "cnn2d_last.ckpt").exists()
    h = result["history"]
    assert h[1].train_loss < h[0].train_loss


def test_device_resident_cli_trains_the_same_epochs(corpus, trained, tmp_path):
    _, host = trained
    result = ttrain.main(_train_args(corpus, tmp_path, "--epochs", "2", "--run-name", "r", "--quiet",
                                     "--device-resident", *RECIPE))
    # on the CPU the resident gather is the host-fed computation
    for got, want in zip(result["history"], host["history"]):
        assert (got.train_loss, got.dev_loss, got.dev_eer) == (want.train_loss, want.dev_loss, want.dev_eer)


def test_evaluate_checkpoint_mode_prints_the_best_epochs_eer(corpus, trained, capsys):
    ckdir, result = trained
    common = ["--features", corpus["dev"][0], "--labels", corpus["dev"][1], "--checkpoint",
              str(ckdir / "cnn2d_best.ckpt"), "--in-features", str(F_), "--batch-size", "8"]
    tevaluate.main(common + ["--device", "cpu"])
    got = dict(line.split("=", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert list(got) == ["avg_loss", "eer", "threshold"]
    assert float(got["eer"]) == result["best_eer"]
    jevaluate.main(common)  # the JAX package serves the port's checkpoint
    want = dict(line.split("=", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert got["eer"] == want["eer"]
    np.testing.assert_allclose(float(got["avg_loss"]), float(want["avg_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["threshold"]), float(want["threshold"]), atol=1e-5)


def test_predict_with_and_without_fast_agree_with_jax(corpus, trained, tmp_path):
    ckdir, _ = trained
    common = ["--features", corpus["dev"][0], "--checkpoint", str(ckdir / "cnn2d_best.ckpt"), "--model", "cnn2d",
              "--in-features", str(F_), "--batch-size", "8"]  # 20 rows: a padded tail
    tpredict.main(common + ["--out", str(tmp_path / "t.pkl"), "--device", "cpu"])
    tpredict.main(common + ["--out", str(tmp_path / "tf.pkl"), "--device", "cpu", "--fast"])
    jpredict.main(common + ["--out", str(tmp_path / "j.pkl")])
    t, tf, j = (pd.read_pickle(tmp_path / f"{n}.pkl") for n in ("t", "tf", "j"))
    assert t["uttid"].tolist() == tf["uttid"].tolist() == j["uttid"].tolist() and len(t) == 20
    assert t["predictions"].between(0, 1).all()  # sigmoid on by default
    np.testing.assert_allclose(t["predictions"], tf["predictions"], atol=1e-5)
    np.testing.assert_allclose(t["predictions"], j["predictions"], atol=1e-5)


def test_resume_trains_only_the_remaining_epochs(corpus, trained, tmp_path):
    ckdir, _ = trained
    result = ttrain.main(_train_args(corpus, tmp_path, "--epochs", "3", "--quiet", "--resume",
                                     str(ckdir / "cnn2d_last.ckpt"), *RECIPE))
    assert [m.epoch for m in result["history"]] == [3]


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--multihost"],
                                  ["--resident-chunk-batches", "4"], ["--chunk-ingest", "bf16"], ["--fused-fit"],
                                  ["--bn-freeze-after", "0.5"], ["--train-fast"], ["--checkpoint-format", "orbax"]])
def test_train_cli_refuses_what_is_not_ported(flag, tmp_path):
    """Orbax exits "not ported" and ``--multihost`` without
    ``--coordinator-address`` names the three flags, before any data is
    read; the data-parallel, chunked, fused and freeze-tail flags go on to
    read the data, so a missing split stops them."""
    missing = ["--train-features", str(tmp_path / "missing.pkl"), "--train-labels", str(tmp_path / "missing.pkl")]
    if flag[0] in ("--multihost", "--checkpoint-format"):
        msg = "--coordinator-address HOST:PORT" if flag[0] == "--multihost" else "not ported to dfac_tpu_torch"
        with pytest.raises(SystemExit, match=msg):
            ttrain.main(flag + missing)
    else:
        with pytest.raises(FileNotFoundError):
            ttrain.main(flag + missing + ["--device", "cpu"])


def test_reproduce_reference_dry_run(reference_shaped_data, tmp_path):  # noqa: F811
    out = tmp_path / "repro_out"
    rc = trepro.main(["--data-dir", str(reference_shaped_data), "--out-dir", str(out), "--epochs", "2",
                      "--batch-size", "8", "--expect-dev-eer", "0.0", "--device", "cpu"])
    assert rc == 0
    report = open(out / "report.md").read()
    assert "| dev |" in report and "PASS" in report and "prediction.pkl written" in report
    assert os.path.exists(out / "checkpoints" / "cnn2d_best.ckpt")
    pred = pd.read_pickle(out / "prediction.pkl")
    assert list(pred.columns) == ["uttid", "predictions"] and len(pred) == 8
    assert pred["predictions"].between(0, 1).all()


def test_reproduce_reference_contract_can_fail(reference_shaped_data, tmp_path, capsys):  # noqa: F811
    rc = trepro.main(["--data-dir", str(reference_shaped_data), "--out-dir", str(tmp_path / "repro_fail"),
                      "--epochs", "1", "--batch-size", "8", "--expect-dev-eer", "0.40", "--device", "cpu"])
    assert rc == 1 and "CONTRACT FAILED" in capsys.readouterr().out
