"""The ported serving slice end to end against the JAX package: waveform ->
scores, host EER, checkpoint loading without jax, and the predict CLI."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.features.lfcc import LFCCConfig as JConfig
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.ops import eer as jeer
from dfac_tpu.ops.pallas.gemm_frontend import gemm_lfcc_features_tf as j_features_tf
from dfac_tpu.train.checkpoint import save_checkpoint
from dfac_tpu_torch.features.lfcc import LFCCConfig as TConfig
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.ops import eer as teer
from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_features_tf as t_features_tf
from dfac_tpu_torch.train.checkpoint import load_model_variables
from dfac_tpu_torch.utils.convert import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _variables(in_features, base_channels, frames, seed=0):
    model = jbuild("cnn2d", in_features=in_features, base_channels=base_channels)
    variables = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, frames, in_features)))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    for i in (1, 2, 3):
        stats = variables["batch_stats"][f"bn{i}"]
        stats["mean"] = rng.uniform(-0.2, 0.2, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return variables


def test_slice_waveform_to_scores_matches_jax():
    """Full LFCCConfig, 33 frames, CNN2D at in_features 180, base 8, f32."""
    frames = 33
    variables = _variables(180, 8, frames)
    waves = np.random.default_rng(4).normal(size=(3, TConfig().num_samples(frames))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        feats_j = j_features_tf(jnp.asarray(waves), JConfig())
    want = np.asarray(jfast.cnn2d_fast_scores_tf(jfast.fold_cnn2d(variables), feats_j, compute_dtype=jnp.float32))
    folded = tfast.fold_cnn2d(state_dict_from_jax(variables))
    feats_t = t_features_tf(torch.from_numpy(waves), TConfig())
    got = tfast.cnn2d_fast_scores_tf(folded, feats_t, compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (3,)
    # f32 end to end; features agree to ~1e-4 (test_torch_port_frontend),
    # the CNN adds only summation-order differences
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "ties", "one_class"])
def test_host_eer_byte_equal(kind):
    rng = np.random.default_rng(5)
    n = 257
    labels = (rng.random(n) > 0.4).astype(np.int64)
    if kind == "random":
        scores = rng.normal(size=n)
    elif kind == "ties":
        scores = rng.integers(0, 7, size=n).astype(np.float64) / 7.0  # heavy ties
    else:
        labels = np.ones(n, np.int64)
        scores = rng.normal(size=n)
    got, want = teer.calculate_eer(scores, labels), jeer.calculate_eer(scores, labels)
    assert got == want  # same floats, bit for bit
    assert teer.confusion_at_threshold(scores, labels, got[1]) == jeer.confusion_at_threshold(scores, labels, want[1])


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_checkpoint_with_optax_state_loads_without_jax(tmp_path):
    variables = _variables(20, 8, 33)
    opt_state = optax.adam(1e-3).init(jax.tree.map(jnp.asarray, variables["params"]))
    path = str(tmp_path / "cnn2d_best.ckpt")
    save_checkpoint(path, variables, opt_state=opt_state, epoch=3, config={"model": "cnn2d"})

    code = (
        "import json, sys\n"
        "from dfac_tpu_torch.train.checkpoint import load_model_variables\n"
        "sd = load_model_variables(sys.argv[1], 'cnn2d')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dfac_tpu'))\n"
        "print(json.dumps({'bad': bad, 'keys': sorted(sd)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, path], check=True, capture_output=True, text=True, env=_env(), cwd=str(ROOT)
    ).stdout
    report = json.loads(out.strip().splitlines()[-1])
    assert report["bad"] == []
    want = state_dict_from_jax(variables)
    assert report["keys"] == sorted(want)
    got = load_model_variables(path, "cnn2d")  # in-process: same tensors
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_predict_cli_matches_jax_fast(tmp_path):
    from dfac_tpu.cli import predict as jpredict
    from dfac_tpu_torch.cli import predict as tpredict

    f_dim, t_dim, n = 20, 33, 10  # 10 rows at batch 4: a padded tail
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(n, f_dim, t_dim)).astype(np.float32)
    uttids = [f"u{i:03d}" for i in range(n)]
    fpath = tmp_path / "features.pkl"
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(fpath)
    ckpt = str(tmp_path / "cnn2d_best.ckpt")
    save_checkpoint(ckpt, _variables(f_dim, 32, t_dim))  # the CLIs build base_channels 32

    common = ["--features", str(fpath), "--checkpoint", ckpt, "--model", "cnn2d", "--fast",
              "--in-features", str(f_dim), "--batch-size", "4"]
    jpredict.main(common + ["--out", str(tmp_path / "jax.pkl")])
    tpredict.main(common + ["--out", str(tmp_path / "torch.pkl"), "--device", "cpu"])
    want, got = pd.read_pickle(tmp_path / "jax.pkl"), pd.read_pickle(tmp_path / "torch.pkl")
    assert list(got.columns) == ["uttid", "predictions"] and got["uttid"].tolist() == uttids
    # both f32 folded chains on the CPU
    np.testing.assert_allclose(got["predictions"], want["predictions"], atol=1e-5)


def test_load_features_refuses_a_pickle_with_no_rows(tmp_path):
    """Both packages refuse a features.pkl with no rows: the reference on
    ``mats[0]`` (IndexError), the port with a ValueError naming the file."""
    from dfac_tpu.io.pickle_io import load_features as j_load
    from dfac_tpu_torch.io.pickle_io import load_features as t_load

    fpath = tmp_path / "features.pkl"
    pd.DataFrame({"uttid": [], "features": []}).to_pickle(fpath)
    with pytest.raises(IndexError):
        j_load(str(fpath))
    with pytest.raises(ValueError, match=re.escape(f"{fpath}: features.pkl has no rows")):
        t_load(str(fpath))


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--multihost"]])
def test_predict_cli_refuses_what_is_not_ported(flag, tmp_path):
    """``--data-parallel`` and ``--multihost`` are ported
    (``tests/test_torch_port_multihost.py``); the JAX CLI's refusals of them
    stay, with its messages, before anything is read: ``--int8`` over more
    than one device, ``--multihost`` without ``--fast``."""
    from dfac_tpu_torch.cli import predict as tpredict

    base = ["--features", "f.pkl", "--checkpoint", "c.ckpt", "--model", "cnn2d", "--out", "p.pkl"]
    if flag[0] == "--data-parallel":
        argv, msg = base + ["--fast", "--int8"] + flag, "without --multihost/--data-parallel"
    else:
        argv, msg = base + flag, "--multihost serving runs the folded fast chain — add --fast"
    with pytest.raises(SystemExit, match=re.escape(msg)):
        tpredict.main(argv)


def test_evaluate_cli_matches_jax(tmp_path, capsys):
    from dfac_tpu.cli import evaluate as jevaluate
    from dfac_tpu_torch.cli import evaluate as tevaluate

    rng = np.random.default_rng(7)
    uttids = [f"u{i:03d}" for i in range(40)]
    pd.DataFrame({"uttid": uttids, "predictions": rng.random(40)}).to_pickle(tmp_path / "p.pkl")
    pd.DataFrame({"uttid": uttids[::-1], "label": (np.arange(40) % 2)}).to_pickle(tmp_path / "l.pkl")
    jevaluate.main([str(tmp_path / "p.pkl"), str(tmp_path / "l.pkl")])
    want = capsys.readouterr().out
    tevaluate.main([str(tmp_path / "p.pkl"), str(tmp_path / "l.pkl")])
    assert capsys.readouterr().out == want
