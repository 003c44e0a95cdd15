"""PyTorch port of the submission path against the JAX package, on the
CPU: score fusion and the alpha sweep, checkpoint ensembles, the
submission artifact, and the ``predict_hybrid``, ``hybrid_ensemble``,
``ensemble`` and ``generate_submission`` CLIs.

The checkpoints are JAX pickle checkpoints of numpy-drawn weights (CNN2D,
CNN1D and the CAE at F = 20, T = 37). numpy functions must be equal; the
f32 scoring CLIs agree within 1e-5 on each leg (BN folded or not, sums in
another order), the bf16 legs within the JAX package's bf16 bounds
(``tests/test_fast_infer.py``: scores atol 2e-2, CAE MSE rtol 0.1).
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_port_cae import numpy_weights

from dfac_tpu.cli import ensemble as jensemble_cli
from dfac_tpu.cli import generate_submission as jsubmit_cli
from dfac_tpu.cli import hybrid_ensemble as jhybrid_ensemble
from dfac_tpu.cli import predict_hybrid as jpredict_hybrid
from dfac_tpu.data.normalizer import FeatureNormalizer as JNormalizer
from dfac_tpu.data.pipeline import load_dataset as jload_dataset
from dfac_tpu.ensemble import hybrid as jhybrid
from dfac_tpu.ensemble import mean as jmean
from dfac_tpu.io import submission as jsubmission
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.train.checkpoint import load_model_variables as jload_variables
from dfac_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from dfac_tpu_torch.cli import ensemble as tensemble_cli
from dfac_tpu_torch.cli import generate_submission as tsubmit_cli
from dfac_tpu_torch.cli import hybrid_ensemble as thybrid_ensemble
from dfac_tpu_torch.cli import predict_hybrid as tpredict_hybrid
from dfac_tpu_torch.data.normalizer import FeatureNormalizer
from dfac_tpu_torch.data.pipeline import load_dataset
from dfac_tpu_torch.ensemble import hybrid as thybrid
from dfac_tpu_torch.ensemble import mean as tmean
from dfac_tpu_torch.io import submission as tsubmission
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.train.checkpoint import load_model_variables
from dfac_tpu_torch.utils.convert import jax_from_state_dict

F_, T_, N_ = 20, 37, 20  # 20 utterances at B=8: a padded tail
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A labeled split, JAX checkpoints of each family, a normalizer sidecar."""
    root = tmp_path_factory.mktemp("submission")
    rng = np.random.default_rng(0)
    labels = (np.arange(N_) % 2).astype(np.int64)
    feats = rng.normal(size=(N_, F_, T_)).astype(np.float32)
    feats[labels == 1, :6] += 0.8
    uttids = [f"utt{i:03d}" for i in range(N_)]
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(root / "f.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(root / "l.pkl")
    paths = {"features": str(root / "f.pkl"), "labels": str(root / "l.pkl")}
    for i, (name, kw) in enumerate((("cnn2d", {"in_features": F_}),
                                    ("cnn1d", {"in_features": F_}), ("cae", {"base_channels": 8}))):
        sd = numpy_weights(tbuild(name, **kw).state_dict(), seed=10 + i)
        paths[name] = str(root / f"{name}.ckpt")
        jsave_checkpoint(paths[name], jax_from_state_dict(sd, name))
    JNormalizer().fit(np.transpose(feats[labels == 1], (0, 2, 1))).save(str(root / "norm.npz"))
    paths["normalizer"] = str(root / "norm.npz")
    paths["root"] = root
    return paths


# -- numpy functions: equal ------------------------------------------------------------------------

def test_fusion_sweep_and_reports_equal_jax():
    rng = np.random.default_rng(1)
    sup, cae = rng.random(50), rng.random(50) * 3 + 1
    labels = (rng.random(50) > 0.5).astype(np.int32)
    for x in (sup, cae, np.full(5, 0.3)):
        np.testing.assert_array_equal(thybrid.min_max_normalize(x), jhybrid.min_max_normalize(x))
    for alpha in (0.0, 0.8, 1.0):
        np.testing.assert_array_equal(thybrid.fuse_scores(sup, cae, alpha), jhybrid.fuse_scores(sup, cae, alpha))
    assert thybrid.sweep_alpha(sup, cae, labels) == jhybrid.sweep_alpha(sup, cae, labels)
    assert thybrid.sweep_alpha(sup, cae, labels, num=5) == jhybrid.sweep_alpha(sup, cae, labels, num=5)
    assert thybrid.score_distribution_report(sup) == jhybrid.score_distribution_report(sup)
    u = [f"u{i}" for i in range(50)]
    assert (thybrid.compare_with_submission(u, sup, u[::-1], cae[::-1]) ==
            jhybrid.compare_with_submission(u, sup, u[::-1], cae[::-1]))
    assert thybrid.compare_with_submission(u, sup, ["x"], [0.1])["n_common"] == 0


def test_ensemble_scores_equal_jax():
    rng = np.random.default_rng(2)
    per = {"a": rng.random(9), "b": rng.random(9), "c": rng.random(9)}
    np.testing.assert_array_equal(tmean.ensemble_scores(per), jmean.ensemble_scores(per))
    np.testing.assert_array_equal(tmean.ensemble_scores(list(per.values())), jmean.ensemble_scores(per))
    with pytest.raises(ValueError, match="no scores"):
        tmean.ensemble_scores([])


def test_score_checkpoints_keeps_duplicates_and_matches_jax(world):
    specs = [("cnn2d", world["cnn2d"]), ("cnn1d", world["cnn1d"]), ("cnn2d", world["cnn2d"])]
    got = tmean.score_checkpoints(specs, load_dataset(world["features"]), batch_size=8,
                                  device="cpu")
    want = jmean.score_checkpoints(specs, jload_dataset(world["features"]), batch_size=8, in_features=F_)
    assert list(got) == list(want) == [f"cnn2d:{world['cnn2d']}", f"cnn1d:{world['cnn1d']}",
                                       f"cnn2d:{world['cnn2d']}#2"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


def test_submission_artifact_equals_jax(world, tmp_path):
    rng = np.random.default_rng(3)
    uttids = pd.read_pickle(world["features"])["uttid"].tolist()
    pred = tmp_path / "prediction.pkl"
    pd.DataFrame({"uttid": uttids[::-1], "predictions": rng.random(N_)}).to_pickle(pred)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    args = (world["features"], str(pred), "B00000000", "Ada", "Lovelace", "nick")
    got = tsubmission.generate_submission(*args, output_dir=str(tmp_path / "t"))
    want = jsubmission.generate_submission(*args, output_dir=str(tmp_path / "j"))
    assert got.endswith("B00000000-Ada-Lovelace-nick.pkl")
    with open(got, "rb") as f, open(want, "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert {k: v for k, v in a.items() if k != "predictions"} == {k: v for k, v in b.items() if k != "predictions"}
    pd.testing.assert_frame_equal(a["predictions"], b["predictions"])
    assert tsubmission.submission_class_counts(got) == jsubmission.submission_class_counts(want)
    assert tsubmission.submission_class_counts(got, 0.2) == jsubmission.submission_class_counts(want, 0.2)


def test_prediction_frame_checks_equal_jax():
    ok = pd.DataFrame({"uttid": ["a", "b"], "predictions": [1, 0]})  # ints: coerced to float64
    got = tsubmission.validate_prediction_frame(ok, ["b", "a"])
    pd.testing.assert_frame_equal(got, jsubmission.validate_prediction_frame(ok, ["b", "a"]))
    assert got["predictions"].dtype == np.float64 and ok["predictions"].dtype != np.float64
    for bad, uttids, msg in ((ok.assign(x=1), ["a", "b"], "exactly 2 columns"),
                             (ok.rename(columns={"uttid": "id"}), ["a", "b"], "'uttid' and 'predictions'"),
                             (ok, ["a", "c"], "uttid mismatch")):
        with pytest.raises(ValueError, match=msg):
            tsubmission.validate_prediction_frame(bad, uttids)
        with pytest.raises(ValueError, match=msg):
            jsubmission.validate_prediction_frame(bad, uttids)


# -- the CLIs --------------------------------------------------------------------------------------

def _hybrid_args(world, cnn, out, *extra):
    return ["--features", world["features"], "--cnn-checkpoint", world[cnn], "--cnn-model", cnn,
            "--cae-checkpoint", world["cae"], "--normalizer", world["normalizer"], "--batch-size", "8",
            "--in-features", str(F_), "--base-channels", "8", "--out", str(out), *extra]


def _legs(world, cnn):
    """The two legs of the f32 path, in each package: the eval models."""
    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu.train.cae_loop import cae_mse_scores as jcae_mse_scores
    from dfac_tpu.train.evaluate import predict_scores as jpredict_scores
    from dfac_tpu_torch.train.cae_loop import cae_mse_scores
    from dfac_tpu_torch.train.evaluate import predict_scores

    ds, jds = load_dataset(world["features"]), jload_dataset(world["features"])
    model = tbuild(cnn, in_features=F_)
    model.load_state_dict(load_model_variables(world[cnn], cnn))
    cae = tbuild("cae", base_channels=8)
    cae.load_state_dict(load_model_variables(world["cae"], "cae"))
    port = (predict_scores(model, ds, 8, apply_sigmoid=True),
            cae_mse_scores(cae, ds, FeatureNormalizer.load(world["normalizer"]), 8))
    jax = (jpredict_scores(jbuild(cnn, in_features=F_), jload_variables(world[cnn], cnn), jds, 8, apply_sigmoid=True),
           jcae_mse_scores(jbuild("cae", base_channels=8), jload_variables(world["cae"], "cae"), jds,
                           JNormalizer.load(world["normalizer"]), 8))
    return port, jax


@pytest.mark.parametrize("cnn", ["cnn2d", "cnn1d"])
def test_predict_hybrid_cli_f32_matches_jax(world, cnn, tmp_path, capsys):
    tpredict_hybrid.main(_hybrid_args(world, cnn, tmp_path / "t.pkl", "--device", "cpu"))
    got_lines = capsys.readouterr().out.splitlines()
    jpredict_hybrid.main(_hybrid_args(world, cnn, tmp_path / "j.pkl"))
    want_lines = capsys.readouterr().out.splitlines()
    got, want = pd.read_pickle(tmp_path / "t.pkl"), pd.read_pickle(tmp_path / "j.pkl")
    assert got["uttid"].tolist() == want["uttid"].tolist() and len(got) == N_
    (sup, cae), (jsup, jcae) = _legs(world, cnn)
    np.testing.assert_allclose(sup, jsup, atol=1e-5)
    np.testing.assert_allclose(cae, jcae, rtol=1e-4)
    np.testing.assert_array_equal(got["predictions"], thybrid.fuse_scores(sup, cae, 0.80))
    # min-max normalization divides each leg's difference by that leg's range
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=1e-4)
    assert got_lines[0] == want_lines[0].replace("j.pkl", "t.pkl")
    assert got_lines[1].split(":")[0] == want_lines[1].split(":")[0] == "distribution"
    # --compare-with: the JAX CLI's file against the port's
    tpredict_hybrid.main(_hybrid_args(world, cnn, tmp_path / "t.pkl", "--device", "cpu", "--compare-with",
                                      str(tmp_path / "j.pkl")))
    line = capsys.readouterr().out.splitlines()[-1]
    assert f"vs {tmp_path / 'j.pkl'}: common={N_}" in line and "agreement=1.0000 flipped=0" in line


@pytest.mark.parametrize("cnn", ["cnn2d", "cnn1d"])
def test_predict_hybrid_cli_fast_runs_both_legs_in_bf16(world, cnn, tmp_path):
    """``--fast``: both legs through the folded chains at their bf16
    defaults, as in JAX; each leg within the JAX package's bf16 bound of
    the JAX leg, and the CLI's file the fusion of the port's legs."""
    tpredict_hybrid.main(_hybrid_args(world, cnn, tmp_path / "t.pkl", "--device", "cpu", "--fast"))
    ds, jds = load_dataset(world["features"]), jload_dataset(world["features"])
    sd, jvars = load_model_variables(world[cnn], cnn), jload_variables(world[cnn], cnn)
    if cnn == "cnn2d":
        sup = tfast.predict_scores_fast(sd, ds, CPU, 8)
        jsup = jfast.predict_scores_fast(jvars, jds, 8)
    else:
        sup = tfast.predict_scores_fast_cnn1d(sd, ds, CPU, 8)
        jsup = jfast.predict_scores_fast_cnn1d(jvars, jds, 8)
    norm = FeatureNormalizer.load(world["normalizer"])
    cae = tfast.cae_mse_scores_fast(load_model_variables(world["cae"], "cae"), ds, norm, CPU, 8)
    jcae = jfast.cae_mse_scores_fast(jload_variables(world["cae"], "cae"), jds, JNormalizer.load(world["normalizer"]), 8)
    np.testing.assert_allclose(sup, jsup, atol=2e-2)
    np.testing.assert_allclose(cae, jcae, rtol=0.1)
    got = pd.read_pickle(tmp_path / "t.pkl")["predictions"].to_numpy()
    np.testing.assert_array_equal(got, thybrid.fuse_scores(sup, cae, 0.80))


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--multihost"]])
def test_predict_hybrid_cli_refuses_what_is_not_ported(world, flag, tmp_path):
    """``--data-parallel`` and ``--multihost`` are ported
    (``tests/test_torch_port_multihost.py``); without ``--fast`` each is
    refused with the JAX CLI's message, and nothing is written."""
    msg = ("--data-parallel hybrid serving requires --fast" if flag[0] == "--data-parallel"
           else "--multihost hybrid serving runs the folded fast chains — add --fast")
    with pytest.raises(SystemExit, match=msg):
        tpredict_hybrid.main(_hybrid_args(world, "cnn2d", tmp_path / "t.pkl", "--device", "cpu", *flag))
    assert not (tmp_path / "t.pkl").exists()


def test_hybrid_ensemble_cli_prints_the_jax_sweep(world, capsys):
    args = ["--features", world["features"], "--labels", world["labels"], "--cnn-checkpoint", world["cnn1d"],
            "--cnn-model", "cnn1d", "--cae-checkpoint", world["cae"], "--normalizer", world["normalizer"],
            "--batch-size", "8", "--in-features", str(F_), "--base-channels", "8", "--num-alphas", "11"]
    got = thybrid_ensemble.main(args + ["--device", "cpu"])
    got_lines = capsys.readouterr().out.splitlines()
    want = jhybrid_ensemble.main(args)
    assert got_lines == capsys.readouterr().out.splitlines() and len(got_lines) == 14
    assert got["best_alpha"] == want["best_alpha"] and got["best_eer"] == want["best_eer"]


def test_ensemble_cli_prints_the_jax_report(world, tmp_path, capsys):
    specs = [f"cnn2d:{world['cnn2d']}", f"cnn1d:{world['cnn1d']}"]
    args = ["--features", world["features"], "--labels", world["labels"], "--checkpoints", *specs,
            "--batch-size", "8", "--in-features", str(F_)]
    tensemble_cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "t.pkl")])
    got = capsys.readouterr().out.splitlines()
    jensemble_cli.main(args + ["--out", str(tmp_path / "j.pkl")])
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        g_name, g_eer, g_thr = g.replace("threshold=", "").replace("EER=", "").rsplit(" ", 2)
        w_name, w_eer, w_thr = w.replace("threshold=", "").replace("EER=", "").rsplit(" ", 2)
        assert (g_name, g_eer) == (w_name, w_eer)
        assert abs(float(g_thr) - float(w_thr)) <= 1e-5
    np.testing.assert_allclose(pd.read_pickle(tmp_path / "t.pkl")["predictions"],
                               pd.read_pickle(tmp_path / "j.pkl")["predictions"], atol=1e-5)
    # every registry architecture is scored (the zoo's in test_torch_port_zoo_cli.py); an unknown
    # one is refused by name, as by the JAX CLI
    for cli in (tensemble_cli, jensemble_cli):
        with pytest.raises(ValueError, match="unknown model 'cnn3d'"):
            cli.main(["--features", world["features"], "--labels", world["labels"], "--checkpoints",
                      "cnn3d:x.ckpt", "--device", "cpu"])
    with pytest.raises(SystemExit, match="want arch:path"):
        tensemble_cli.main(["--features", "f", "--labels", "l", "--checkpoints", "cnn2d"])


def test_generate_submission_cli_writes_the_jax_artifact(world, tmp_path, capsys, monkeypatch):
    uttids = pd.read_pickle(world["features"])["uttid"].tolist()
    pd.DataFrame({"uttid": uttids, "predictions": np.linspace(0, 1, N_)}).to_pickle(tmp_path / "p.pkl")
    argv = [world["features"], str(tmp_path / "p.pkl"), "S1", "Ada", "Lovelace", "nick"]
    for name, cli in (("t", tsubmit_cli), ("j", jsubmit_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        cli.main(argv)
        assert capsys.readouterr().out.strip() == "Submission file saved to: ./S1-Ada-Lovelace-nick.pkl"
    with open(tmp_path / "t" / "S1-Ada-Lovelace-nick.pkl", "rb") as f, \
            open(tmp_path / "j" / "S1-Ada-Lovelace-nick.pkl", "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    pd.testing.assert_frame_equal(a.pop("predictions"), b.pop("predictions"))
    assert a == b
    with pytest.raises(ValueError, match="Usage"):
        tsubmit_cli.main(argv[:5])
