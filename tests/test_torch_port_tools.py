"""The data tools, embedding anomaly scoring and profiling: the port against
the JAX package on the CPU.

* ``ensemble/anomaly.py``: embeddings against JAX's within 1e-5 (f32 convs
  summed in another order); the OC-SVM and GMM scores on identical
  embeddings equal JAX's bit for bit (the same scikit-learn calls); the
  full report's EERs within one utterance's step (the embeddings differ in
  their last bits, which may move one utterance across a threshold).
* ``cli/data_tools.py``: every subcommand's output lines equal the JAX
  CLI's; the store ``convert-to-npy --filter-label 1`` writes reads back in
  both packages.
* ``obs/profiling.py``: ``trace`` writes a Chrome trace holding the
  program spans of its session, or nothing; ``--profile-dir`` in
  ``train``, ``train_cae`` and ``train_detector`` writes a non-empty Chrome
  trace, and ``train``'s checkpoint with the flag equals the one without
  it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import data_tools as jtools
from dfac_tpu.data.pipeline import ArrayDataset as JArrayDataset
from dfac_tpu.ensemble import anomaly as janomaly
from dfac_tpu.io.npy_store import load_npy_dataset as jload_store
from dfac_tpu.models import build_model as jbuild
from dfac_tpu_torch.cli import data_tools as ttools
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.ensemble import anomaly as tanomaly
from dfac_tpu_torch.io.npy_store import load_npy_dataset as tload_store
from dfac_tpu_torch.io.submission import generate_submission
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.obs import profiling as tprof
from dfac_tpu_torch.utils.convert import state_dict_from_jax

F_, T_, N_ = 12, 20, 24


def _split(n=N_, seed=0, f=F_):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, f, T_)).astype(np.float32)
    feats[labels == 0] += 1.5  # spoof shifted: separable in embedding space
    return [f"u{i:03d}" for i in range(n)], feats, labels


@pytest.fixture(scope="module")
def anomaly_models():
    """(flax module, numpy variables with random BatchNorm, the port's eval model)."""
    model = jbuild("cnn2d", in_features=F_, base_channels=4)
    variables = jax.tree.map(np.asarray, model.init({"params": jax.random.key(0)}, jnp.zeros((1, T_, F_))))
    rng = np.random.default_rng(3)
    for d in variables["batch_stats"].values():
        d["mean"] = (rng.normal(size=d["mean"].shape) * 0.3).astype(np.float32)
        d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
    tmodel = tbuild("cnn2d", in_features=F_, base_channels=4)
    tmodel.load_state_dict(state_dict_from_jax(variables, "cnn2d"))
    return model, variables, tmodel


def test_embeddings_match_jax(anomaly_models):
    model, variables, tmodel = anomaly_models
    uttids, feats, labels = _split()
    tmodel.train()  # extract_embeddings evaluates in eval mode whatever the caller left, and restores it
    got = tanomaly.extract_embeddings(tmodel, ArrayDataset(uttids, feats, labels), batch_size=7)
    assert tmodel.training
    tmodel.eval()
    want = janomaly.extract_embeddings(model, variables, JArrayDataset(uttids, feats, labels), batch_size=7)
    assert got.shape == want.shape == (N_, 4 * 4 * F_) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    logits, emb = tmodel(torch.from_numpy(feats[:3]).transpose(1, 2), return_embedding=True)
    assert logits.shape == (3, 1)
    np.testing.assert_allclose(emb.detach().numpy(), got[:3], atol=1e-6)


def test_classical_scores_equal_jax_on_identical_embeddings():
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(4)
    tr = rng.normal(size=(30, 16)).astype(np.float32)
    ev = rng.normal(size=(20, 16)).astype(np.float32) * 1.3
    np.testing.assert_array_equal(tanomaly.ocsvm_anomaly_scores(tr, ev), janomaly.ocsvm_anomaly_scores(tr, ev))
    kw = dict(n_components=2, pca_dims=4, reg_covar=1e-2)
    np.testing.assert_array_equal(tanomaly.gmm_anomaly_scores(tr, ev, **kw), janomaly.gmm_anomaly_scores(tr, ev, **kw))


def test_report_matches_jax_within_one_utterance(anomaly_models):
    pytest.importorskip("sklearn")
    model, variables, tmodel = anomaly_models
    uttids, feats, labels = _split()
    kw = dict(batch_size=8, pca_dims=4, gmm_components=1, reg_covar=1e-2)
    got = tanomaly.embedding_anomaly_report(tmodel, ArrayDataset(uttids, feats, labels),
                                            ArrayDataset(uttids, feats, labels), **kw)
    want = janomaly.embedding_anomaly_report(model, variables, JArrayDataset(uttids, feats, labels),
                                             JArrayDataset(uttids, feats, labels), **kw)
    step = 1.0 / min(np.sum(labels == 0), np.sum(labels == 1))
    for name in ("ocsvm", "gmm"):
        assert abs(got[name]["eer"] - want[name]["eer"]) <= step + 1e-12
        assert got[name]["scores"].shape == (N_,)
    assert got["embedding_dim"] == want["embedding_dim"] == 4 * 4 * F_
    assert got["n_bonafide_train"] == want["n_bonafide_train"] == N_ // 2
    with pytest.raises(ValueError, match="LABELED eval dataset"):
        tanomaly.embedding_anomaly_report(tmodel, ArrayDataset(uttids, feats, labels), ArrayDataset(uttids, feats))
    with pytest.raises(ValueError, match="no bonafide"):
        tanomaly.embedding_anomaly_report(tmodel, ArrayDataset(uttids, feats, labels * 0),
                                          ArrayDataset(uttids, feats, labels))


# -- data_tools --------------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    uttids, feats, labels = _split(10, seed=5)
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(root / "f.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels.astype(np.int64)}).to_pickle(root / "l.pkl")
    scores = np.random.default_rng(6).random(10)
    pd.DataFrame({"uttid": uttids, "predictions": scores}).to_pickle(root / "p.pkl")
    sub = generate_submission(str(root / "f.pkl"), str(root / "p.pkl"), "S0", "A", "B", "n", output_dir=str(root))
    return {"root": root, "f": str(root / "f.pkl"), "l": str(root / "l.pkl"), "p": str(root / "p.pkl"), "s": sub,
            "feats": feats, "labels": labels, "uttids": uttids}


@pytest.mark.parametrize("cmd", ["analyze-pickles", "check-shape", "score-distributions", "submission-stats"])
def test_data_tools_print_the_jax_lines(files, cmd, capsys):
    argv = {"analyze-pickles": [cmd, files["f"], files["l"], files["p"]], "check-shape": [cmd, files["f"]],
            "score-distributions": [cmd, files["p"], files["p"]], "submission-stats": [cmd, files["s"]]}[cmd]
    ttools.main(argv)
    got = capsys.readouterr().out
    jtools.main(argv)
    want = capsys.readouterr().out
    assert got == want and got.strip()
    if cmd == "check-shape":
        assert f"Shape: ({F_}, {T_})" in got and "Dtype: float32" in got


def test_analyze_pickle_bytecode_matches_jax(files):
    for path in (files["f"], files["l"], files["s"]):
        assert ttools.analyze_pickle_bytecode(path) == jtools.analyze_pickle_bytecode(path)
    missing = files["root"] / "nope.pkl"
    assert "error" in ttools.analyze_pickle_bytecode(str(missing))


def test_convert_to_npy_store_reads_back_in_both_packages(files, capsys):
    root = files["root"]
    ttools.main(["convert-to-npy", files["f"], str(root / "t_store"), "--labels", files["l"], "--filter-label", "1"])
    got = capsys.readouterr().out.replace(str(root / "t_store"), "OUT")
    jtools.main(["convert-to-npy", files["f"], str(root / "j_store"), "--labels", files["l"], "--filter-label", "1"])
    want = capsys.readouterr().out.replace(str(root / "j_store"), "OUT")
    assert got == want == "label filter 1: kept 5/10 rows\nwrote 5 utterances (labeled) -> OUT\n"
    keep = files["labels"] == 1
    for load in (tload_store, jload_store):
        ds = load(str(root / "t_store"))
        np.testing.assert_array_equal(np.asarray(ds.features), files["feats"][keep])
        assert list(ds.uttids) == [u for u, k in zip(files["uttids"], keep) if k]
        np.testing.assert_array_equal(ds.labels, np.ones(5))
    for name in os.listdir(root / "j_store"):
        np.testing.assert_array_equal(np.load(root / "t_store" / name), np.load(root / "j_store" / name))
    with pytest.raises(SystemExit):
        ttools.main(["convert-to-npy", files["f"], str(root / "x"), "--filter-label", "1"])


# -- profiling ---------------------------------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_or_nothing(tmp_path):
    with tprof.trace(None):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    with tprof.trace(str(tmp_path / "tr")):
        sp = tprof.open_span("score", root=True)
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        tprof.close_span(sp, rows=3)
    (path,) = (tmp_path / "tr").iterdir()
    doc = json.loads(path.read_text())
    assert path.suffix == ".json" and doc["traceEvents"]
    # the span on its own track, on the profiler's timeline: it encloses the matmul it wraps
    (span,) = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert span["pid"] == tprof.SPANS_PID and span["name"] == "score" and span["args"]["rows"] == 3
    (mm,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"]
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]


PROF_F = 16  # the CAE's smallest width


def _write_split(root, name, n, seed):
    uttids, feats, labels = _split(n, seed, PROF_F)
    d = root / name
    d.mkdir(parents=True)
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(d / "features.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels.astype(np.int64)}).to_pickle(d / "labels.pkl")
    return str(d / "features.pkl"), str(d / "labels.pkl")


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return root, {name: _write_split(root, name, n, i) for i, (name, n) in
                  enumerate((("train", 16), ("dev", 8), ("test2", 8)))}


def _run_train(splits, ckdir, *extra):
    from dfac_tpu_torch.cli import train

    _, s = splits
    train.main(["--train-features", s["train"][0], "--train-labels", s["train"][1], "--dev-features", s["dev"][0],
                "--dev-labels", s["dev"][1], "--device", "cpu", "--in-features", str(PROF_F), "--batch-size", "8",
                "--epochs", "1", "--quiet", "--checkpoint-dir", str(ckdir), *extra])
    return ckdir / "cnn2d_best.ckpt"


def test_train_profile_dir_writes_a_trace_and_the_same_checkpoint(splits, tmp_path):
    from dfac_tpu_torch.train.checkpoint import load_checkpoint

    plain = load_checkpoint(str(_run_train(splits, tmp_path / "a")))
    traced = load_checkpoint(str(_run_train(splits, tmp_path / "b", "--profile-dir", str(tmp_path / "prof"))))
    (trace_file,) = (tmp_path / "prof").iterdir()
    assert trace_file.stat().st_size > 0 and json.loads(trace_file.read_text())["traceEvents"]
    flat = jax.tree.leaves_with_path(plain["model_state"])
    assert flat
    for (path, a), (_, b) in zip(flat, jax.tree.leaves_with_path(traced["model_state"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("cli", ["train_cae", "train_detector"])
def test_alt_trainers_profile_dir_writes_a_trace(splits, cli, tmp_path):
    from dfac_tpu_torch.cli import train_cae, train_detector

    root, s = splits
    prof = tmp_path / "prof"
    if cli == "train_cae":
        train_cae.main(["--train-features", s["train"][0], "--train-labels", s["train"][1],
                        "--dev-features", s["dev"][0], "--dev-labels", s["dev"][1], "--device", "cpu",
                        "--epochs", "1", "--batch-size", "4", "--base-channels", "4", "--quiet",
                        "--checkpoint-dir", str(tmp_path / "ck"), "--profile-dir", str(prof)])
    else:
        train_detector.main(["--data-dir", str(root), "--epochs", "1", "--batch-size", "8", "--hidden", "16",
                             "--device", "cpu", "--ckpt-path", str(tmp_path / "d.ckpt"),
                             "--prediction-pkl", str(tmp_path / "p.pkl"), "--profile-dir", str(prof)])
    (trace_file,) = prof.iterdir()
    assert json.loads(trace_file.read_text())["traceEvents"]
