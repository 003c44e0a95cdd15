"""The model-sweep CLIs (``benchmark``, ``compare_kernels``,
``compare_normalization``) and the training displays of the PyTorch port
against the JAX package, on the CPU (24 / 16 / 12 utterances of 12
features and 16 frames, B=8, 2 epochs).

Each sweep runs in both packages from the same inits (the JAX trainer's
``init_state`` records, the port's loads: ``test_torch_port_zoo_cli``)
and the same dropout function: both packages' dropout draws are replaced
by bytes of 255, so every element is kept and scaled by 1 / keep in both.
They then write the same files with the same rows and columns, and equal
EERs; ``+specaug`` runs draw their masks from each package's own
generator, so their EERs are only checked to exist. The visualizer
factory falls back rich -> tqdm -> noop as the JAX one does.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_port_zoo_cli import data_args, shared_init, write_split

from dfac_tpu.cli import benchmark as jbenchmark
from dfac_tpu.cli import compare_kernels as jkernels
from dfac_tpu.cli import compare_normalization as jnorm
from dfac_tpu.cli import train as jtrain
from dfac_tpu.obs import factory as jfactory
from dfac_tpu.train import checkpoint as jckpt
from dfac_tpu.train.benchmark_harness import detect_overfit as jdetect_overfit
from dfac_tpu.train.benchmark_harness import parse_model_specs as jparse
from dfac_tpu_torch.cli import benchmark as tbenchmark
from dfac_tpu_torch.cli import compare_kernels as tkernels
from dfac_tpu_torch.cli import compare_normalization as tnorm
from dfac_tpu_torch.cli import train as ttrain
from dfac_tpu_torch.models import common as tcommon
from dfac_tpu_torch.obs import factory as tfactory
from dfac_tpu_torch.obs.base import EpochMetrics
from dfac_tpu_torch.train import checkpoint as tckpt
from dfac_tpu_torch.train.benchmark_harness import detect_overfit, parse_model_specs

F_, B = 12, 8
SWEEP = ["--batch-size", str(B), "--epochs", "2", "--in-features", str(F_)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_corpus")
    return {"train": write_split(root, "train", 24, 0), "dev": write_split(root, "dev", 16, 1),
            "test": write_split(root, "test", 12, 2)}


@pytest.fixture
def same_dropout(monkeypatch):
    monkeypatch.setattr(jax.random, "bits", lambda key, shape=(), dtype=jnp.uint8: jnp.full(shape, 255, dtype))
    monkeypatch.setattr(tcommon, "random_bytes", lambda shape, device, generator: torch.full(
        shape, 255, dtype=torch.uint8, device=device))


def test_specs_and_overfit_rule_are_jax_s():
    for spec in ("cnn2d,cnn2d+specaug, crnn", "meanpool_mlp+specaug,,cnn1d_variant"):
        assert [(s.name, s.spec_augment, s.label) for s in parse_model_specs(spec)] == [
            (s.name, s.spec_augment, s.label) for s in jparse(spec)]
    with pytest.raises(ValueError, match=r"unknown model suffix '\+bogus'"):
        parse_model_specs("cnn2d+bogus")

    def hist(pairs):
        return [EpochMetrics(epoch=i, train_loss=t, dev_loss=d, dev_eer=0.1) for i, (t, d) in enumerate(pairs, 1)]

    for pairs in ([(1.0, 0.8), (0.8, 0.9), (0.6, 1.0)], [(1.0, 1.0), (0.8, 0.9), (0.6, 0.8)],
                  [(1.0, 0.8), (0.8, 0.9), (0.9, 1.0), (0.7, 1.1), (0.5, 1.2)], [(1.0, None), (0.8, 0.9)]):
        assert detect_overfit(hist(pairs)) == jdetect_overfit(hist(pairs))


def test_benchmark_cli_writes_jax_s_files_rows_and_eers(corpus, tmp_path, monkeypatch, capsys):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--models", "cnn1d,meanpool_mlp+specaug", "--seeds", "0,1", "--dropout", "0",
            *SWEEP]
    jbenchmark.main(args + ["--output-dir", str(tmp_path / "j")])
    tbenchmark.main(args + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"benchmark outputs written to {tmp_path / 't'}"
    j_files = sorted(p.relative_to(tmp_path / "j").as_posix() for p in (tmp_path / "j").rglob("*"))
    t_files = sorted(p.relative_to(tmp_path / "t").as_posix() for p in (tmp_path / "t").rglob("*"))
    assert t_files == j_files and "plots/meanpool_mlp+specaug_curves.png" in t_files
    for name in ("model_runs.csv", "model_epochs.csv", "model_ranking.csv"):
        t, j = pd.read_csv(tmp_path / "t" / name), pd.read_csv(tmp_path / "j" / name)
        assert list(t.columns) == list(j.columns) and len(t) == len(j), name
    runs_t, runs_j = (pd.read_csv(tmp_path / d / "model_runs.csv") for d in ("t", "j"))
    assert runs_t[["model", "seed", "epochs_run"]].equals(runs_j[["model", "seed", "epochs_run"]])
    assert runs_t["best_dev_eer"].notna().all()
    plain_t, plain_j = runs_t[runs_t["model"] == "cnn1d"], runs_j[runs_j["model"] == "cnn1d"]
    assert plain_t[["best_dev_eer", "best_epoch"]].equals(plain_j[["best_dev_eer", "best_epoch"]])
    np.testing.assert_allclose(plain_t["final_train_loss"], plain_j["final_train_loss"], rtol=1e-3)
    report = (tmp_path / "t" / "benchmark_report.md").read_text()
    assert "## Ranking" in report and "## Runs" in report and "plots/cnn1d_curves.png" in report


def test_compare_kernels_cli_matches_jax(corpus, tmp_path, monkeypatch, capsys, same_dropout):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--experiments", "3,3,3:raw;5,3,3:cvmn", *SWEEP]
    want = jkernels.main(args + ["--checkpoint-dir", str(tmp_path / "j")])
    j_out = capsys.readouterr().out
    got = tkernels.main(args + ["--checkpoint-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert capsys.readouterr().out == j_out
    assert got == want and [r["experiment"] for r in got] == ["k3-3-3_raw", "k5-3-3_cvmn"]
    for label in ("k3-3-3_raw", "k5-3-3_cvmn"):
        t, j = (ck.load_checkpoint(str(tmp_path / d / f"{label}.ckpt")) for ck, d in ((tckpt, "t"), (jckpt, "j")))
        assert t["config"] == j["config"] and t["epoch"] == j["epoch"]
    assert t["config"]["kernel_sizes"] == [5, 3, 3] and t["config"]["normalization"] == "cvmn"
    # the JAX package serves the port's checkpoint, its kernel sizes read from the weights
    variables = jckpt.load_model_variables(str(tmp_path / "t" / "k5-3-3_cvmn.ckpt"), model_name="cnn1d")
    assert variables["params"]["conv1"]["conv"]["kernel"].shape[0] == 5


def test_compare_normalization_cli_matches_jax(corpus, tmp_path, monkeypatch, capsys, same_dropout):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--test-features", corpus["test"][0], "--test-labels", corpus["test"][1],
            "--schemes", "raw,cmn,cvmn", "--model", "cnn1d", *SWEEP]
    want = jnorm.main(args)
    j_out = capsys.readouterr().out
    got = tnorm.main(args + ["--device", "cpu"])
    assert capsys.readouterr().out == j_out
    assert got == want and [r["scheme"] for r in got] == ["raw", "cmn", "cvmn"] and "test_eer" in got[0]


@pytest.mark.parametrize("missing,want", [(("rich",), "TqdmVisualizer"), (("rich", "tqdm"), "NoOpVisualizer")])
def test_visualizer_factory_falls_back_as_jax(missing, want, monkeypatch):
    for mod in missing:  # an import of the package or of any of its modules raises ImportError
        for name in [m for m in sys.modules if m == mod or m.startswith(mod + ".")] + [mod]:
            monkeypatch.setitem(sys.modules, name, None)
    assert type(tfactory.create_visualizer("rich")).__name__ == type(jfactory.create_visualizer("rich")).__name__
    assert type(tfactory.create_visualizer("rich")).__name__ == want
    assert type(tfactory.create_visualizer("noop")).__name__ == "NoOpVisualizer"
    with pytest.raises(ValueError, match="unknown visualizer"):
        tfactory.create_visualizer("plain")


@pytest.mark.parametrize("display", ["--no-rich", "--quiet", None])
def test_train_display_prints_the_jax_cli_s_lines(display, corpus, tmp_path, monkeypatch, capsys):
    shared_init(monkeypatch)
    args = [*data_args(corpus), "--model", "meanpool_mlp", "--batch-size", str(B), "--epochs", "2", "--dropout", "0",
            *([display] if display else [])]
    jtrain.main(args + ["--checkpoint-dir", str(tmp_path / "j")])
    want = capsys.readouterr().out.splitlines()
    ttrain.main(args + ["--checkpoint-dir", str(tmp_path / "t"), "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    if display == "--quiet":
        assert got == want and len(got) == 1 and got[0].startswith("best dev EER: ")
    elif display == "--no-rich":  # the tqdm lines, but for the device's name and the run's utt/s
        assert got[0] == re.sub(r" on \S+ \|", " on cpu |", want[0])
        strip = [line.split("  ")[0] for line in got[1:3]]
        assert strip == [line.split("  ")[0] for line in want[1:3]]
        assert got[-2:] == want[-2:]
    else:  # the rich dashboard: its panel, one line an epoch and the summary table
        assert "training summary" in "\n".join(got) and got[-1] == want[-1]
        assert sum(line.lstrip().startswith("epoch ") for line in got) == 2
