"""PyTorch port of the CAE scorer (model, BN folding, fast MSE chain,
scoring, evaluation and its CLI) and of the normalizer, against the JAX
package on the CPU.

T = 37 is odd, so the decoder's ``output_padding`` trace and the
emit-then-pad rule both run. Weights are made by the JAX package with
BatchNorm statistics randomized with numpy (``tests/test_fast_infer.py:
151-156``). Tolerances are the JAX package's own
(``tests/test_fast_infer.py:180-207``): reconstruction and f32 fast MSE
rtol 1e-4, bf16 fast MSE rtol 0.1; the normalizer's statistics rtol 1e-6,
the utterance norms atol 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu.cli import evaluate_cae as jevaluate_cae
from dfac_tpu.data import normalizer as jnorm
from dfac_tpu.data.pipeline import ArrayDataset as JArrayDataset
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import cae as jcae
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.ops.eer import eer_device as jeer_device
from dfac_tpu.train import cae_loop as jcae_loop
from dfac_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from dfac_tpu.utils.torch_export import flax_to_torch
from dfac_tpu_torch.cli import evaluate_cae as tevaluate_cae
from dfac_tpu_torch.data import normalizer as tnorm
from dfac_tpu_torch.data.pipeline import ArrayDataset
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import cae as tcae
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.ops.eer import calculate_eer
from dfac_tpu_torch.train import cae_loop as tcae_loop
from dfac_tpu_torch.utils.convert import jax_from_state_dict, state_dict_from_jax

T_, F_, BC = 37, 20, 8
CPU = torch.device("cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def numpy_weights(state_dict, seed=0):
    """Every parameter of a state_dict drawn with numpy from ``seed``: kernels
    U(-1/sqrt(fan_in), +), BatchNorm as ``tests/test_fast_infer.py:151-156``
    (mean N(0, 0.3^2), var U(0.5, 1.5)) with scale U(0.5, 1.5), shift U(-0.1, 0.1)."""
    rng = _rng(seed)
    out = {}
    for k, v in state_dict.items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        if k.endswith("running_mean"):
            a = rng.normal(size=shape) * 0.3
        elif k.endswith("running_var"):
            a = rng.random(shape) + 0.5
        elif v.dim() == 1 and k.replace(".bias", ".running_mean") in state_dict:  # BN affine
            a = rng.uniform(0.5, 1.5, shape) if k.endswith("weight") else rng.uniform(-0.1, 0.1, shape)
        else:
            w = state_dict[k.replace(".bias", ".weight")]
            bound = 1 / np.sqrt(w[0].numel())
            a = rng.uniform(-bound, bound, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def jax_cae():
    """(flax module, numpy variables) of numpy-drawn weights."""
    sd = numpy_weights(tbuild("cae", base_channels=BC).state_dict())
    return jbuild("cae", base_channels=BC), jax_from_state_dict(sd, "cae")


@pytest.fixture(scope="module")
def torch_cae(jax_cae):
    model = tbuild("cae", base_channels=BC).eval()
    model.load_state_dict(state_dict_from_jax(jax_cae[1], "cae"))
    return model


@pytest.fixture(scope="module")
def norm_stats():
    rng = _rng(5)
    return (rng.normal(size=F_).astype(np.float32) * 0.2, (rng.random(F_) + 0.5).astype(np.float32))


def test_state_dict_names_match_the_reference_and_the_jax_exporter(jax_cae):
    sd = state_dict_from_jax(jax_cae[1], "cae")
    assert list(sd) == list(tbuild("cae", base_channels=BC).state_dict())
    assert {k.rsplit(".", 1)[0] for k in sd} == {
        *(f"encoder.{i}" for i in (0, 1, 4, 5, 8, 9, 12, 13)), *(f"decoder.{i}" for i in (0, 1, 3, 4, 6, 7, 9))
    }
    # the JAX package's own exporter: the transposed convs' spatial flip included
    ref = flax_to_torch("cae", jax_cae[1])
    assert set(ref) == set(sd)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert not np.array_equal(sd["decoder.0.weight"].numpy(), sd["decoder.0.weight"].numpy()[:, :, ::-1, ::-1])


def test_state_dict_round_trip_jax_torch_jax(jax_cae):
    variables = jax_cae[1]
    back = jax_from_state_dict(state_dict_from_jax(variables, "cae"), "cae")
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


@pytest.mark.parametrize("t, f", [(37, 20), (321, 180), (30, 16), (16, 33)])
def test_decoder_output_paddings_match_jax(t, f):
    t_sizes, f_sizes = [t], [f]
    for _ in range(3):
        t_sizes.append(t_sizes[-1] // 2)
        f_sizes.append(f_sizes[-1] // 2)
    assert tcae.decoder_output_paddings(t_sizes, f_sizes) == jcae.decoder_output_paddings(t_sizes, f_sizes)


def test_reconstruction_and_latent_match_jax(jax_cae, torch_cae):
    x = _rng(1).normal(size=(3, T_, F_)).astype(np.float32)
    recon_j, latent_j = jax_cae[0].apply(jax_cae[1], jnp.asarray(x))
    with torch.no_grad():
        recon_t, latent_t = torch_cae(torch.from_numpy(x))
    assert tuple(recon_t.shape) == (3, T_, F_) and tuple(latent_t.shape) == (3, 8 * BC, 2, 1)
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(latent_t.permute(0, 2, 3, 1).numpy(), np.asarray(latent_j), rtol=1e-4, atol=1e-6)
    assert np.all(recon_t.numpy()[:, -1] == 0)  # T's output stage emits 36 frames; the 37th is padding
    mse = tcae.reconstruction_mse(recon_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mse, np.asarray(jcae.reconstruction_mse(recon_j, jnp.asarray(x))), rtol=1e-4)


def test_short_input_is_refused_with_the_jax_message(torch_cae):
    with pytest.raises(ValueError, match=re.escape("ConvAutoencoder needs T >= 16 and F >= 16")):
        torch_cae(torch.zeros(1, 15, F_))
    with pytest.raises(ValueError, match=re.escape("cae_fast_mse needs T >= 16 and F >= 16")):
        tfast.cae_fast_mse({}, torch.zeros(1, F_, 15), torch.zeros(F_), torch.ones(F_))


def test_fold_matches_jax_in_torch_layout(jax_cae, torch_cae):
    want = jfast.fold_cae(jax_cae[1])
    got = tfast.fold_cae(torch_cae.state_dict())
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        if k.startswith("enc_w"):
            g = np.transpose(g, (2, 3, 1, 0))  # OIHW -> HWIO
        elif k.startswith("dec_w"):
            g = np.transpose(g[:, :, ::-1, ::-1], (2, 3, 0, 1))  # (I, O, kh, kw) -> JAX's, flipped
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_fast_mse_matches_jax_chain_and_model(jax_cae, torch_cae, norm_stats, dtype, rtol):
    mean, std = norm_stats
    feats = _rng(2).normal(size=(4, F_, T_)).astype(np.float32)
    x = (np.transpose(feats, (0, 2, 1)) - mean) / std
    recon, _ = jax_cae[0].apply(jax_cae[1], jnp.asarray(x))
    ref = np.asarray(jcae.reconstruction_mse(recon, jnp.asarray(x)))
    want = np.asarray(jfast.cae_fast_mse(jfast.fold_cae(jax_cae[1]), jnp.asarray(feats), jnp.asarray(mean),
                                         jnp.asarray(std), compute_dtype=getattr(jnp, dtype)))
    got = tfast.cae_fast_mse(tfast.fold_cae(torch_cae.state_dict()), torch.from_numpy(feats),
                             torch.from_numpy(mean), torch.from_numpy(std), compute_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


def test_corpus_scorers_match_jax(jax_cae, torch_cae, norm_stats):
    feats = _rng(3).normal(size=(11, F_, T_)).astype(np.float32)  # 11 rows at B=4: a padded tail
    uttids = [f"u{i}" for i in range(11)]
    ds, jds = ArrayDataset(uttids, feats), JArrayDataset(uttids, feats)
    tn, jn = tnorm.FeatureNormalizer(*norm_stats), jnorm.FeatureNormalizer(*norm_stats)
    want = jcae_loop.cae_mse_scores(jax_cae[0], jax_cae[1], jds, jn, batch_size=4)
    got = tcae_loop.cae_mse_scores(torch_cae, ds, tn, batch_size=4)
    assert got.shape == (11,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    want_fast = jfast.cae_mse_scores_fast(jax_cae[1], jds, jn, batch_size=4, compute_dtype=jnp.float32)
    got_fast = tfast.cae_mse_scores_fast(torch_cae.state_dict(), ds, tn, CPU, batch_size=4,
                                         compute_dtype=torch.float32)
    np.testing.assert_allclose(got_fast, want_fast, rtol=1e-4)
    np.testing.assert_allclose(got_fast, got, rtol=1e-4)


def test_evaluate_cae_matches_jax_on_continuous_mse(jax_cae, torch_cae, norm_stats):
    rng = _rng(4)
    labels = (np.arange(16) % 2).astype(np.int32)
    feats = rng.normal(size=(16, F_, T_)).astype(np.float32) * (1.0 + 0.5 * labels[:, None, None])
    uttids = [f"u{i}" for i in range(16)]
    tn, jn = tnorm.FeatureNormalizer(*norm_stats), jnorm.FeatureNormalizer(*norm_stats)
    want = jcae_loop.evaluate_cae(jax_cae[0], jax_cae[1], JArrayDataset(uttids, feats, labels), jn, batch_size=8)
    got = tcae_loop.evaluate_cae(torch_cae, ArrayDataset(uttids, feats, labels), tn, batch_size=8)
    assert len(np.unique(got["scores"])) == 16  # no ties: both EER searches agree there
    assert got["convention"] == want["convention"]
    for key in ("eer", "eer_pos_mse", "eer_neg_mse"):
        assert got[key] == want[key], key
    for key in ("threshold", "bonafide_mean_mse", "spoof_mean_mse", "spoof_bonafide_ratio"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_evaluate_cae_takes_calculate_eers_pick_on_tied_minima(monkeypatch, torch_cae):
    """ROADMAP.md §3.4's input: the port's EER equals ``calculate_eer``; the
    JAX package's ``eer_device`` (which JAX's ``evaluate_cae`` uses) does not."""
    scores = np.array([0, 2, 5, 1, 3, 2, 2, 0, 1], np.float32)
    labels = np.array([0, 1, 0, 0, 0, 0, 1, 0, 1], np.int32)
    monkeypatch.setattr(tcae_loop, "cae_mse_scores", lambda *a, **k: scores)
    ds = ArrayDataset([str(i) for i in range(9)], np.zeros((9, F_, T_), np.float32), labels)
    rep = tcae_loop.evaluate_cae(torch_cae, ds, tnorm.FeatureNormalizer(np.zeros(F_), np.ones(F_)))
    assert rep["eer_pos_mse"] == calculate_eer(scores, labels)[0] == 0.5833333333333333
    assert jeer_device(scores, labels)[0] == 0.41666666666666663  # the JAX package's first integer minimum


def test_evaluate_cae_cli_prints_the_jax_lines(jax_cae, norm_stats, tmp_path, capsys):
    rng = _rng(6)
    labels = (np.arange(12) % 2).astype(np.int64)
    feats = rng.normal(size=(12, F_, T_)).astype(np.float32) * (1.0 + 0.5 * labels[:, None, None])
    uttids = [f"u{i:02d}" for i in range(12)]
    pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(tmp_path / "f.pkl")
    pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(tmp_path / "l.pkl")
    jsave_checkpoint(str(tmp_path / "cae.ckpt"), jax_cae[1])
    jnorm.FeatureNormalizer(*norm_stats).save(str(tmp_path / "norm.npz"))
    common = ["--features", str(tmp_path / "f.pkl"), "--labels", str(tmp_path / "l.pkl"), "--checkpoint",
              str(tmp_path / "cae.ckpt"), "--normalizer", str(tmp_path / "norm.npz"), "--base-channels", str(BC),
              "--batch-size", "8"]
    tevaluate_cae.main(common + ["--device", "cpu", "--out", str(tmp_path / "t.pkl")])
    got = capsys.readouterr().out.splitlines()
    jevaluate_cae.main(common + ["--out", str(tmp_path / "j.pkl")])
    want = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in got[:6]] == [line.split(":")[0] for line in want[:6]]
    assert got[6] == want[6].replace("j.pkl", "t.pkl") and len(got) == 7
    assert got[:3] == want[:3]  # the EERs, the convention and its threshold (6 decimals)
    np.testing.assert_allclose(pd.read_pickle(tmp_path / "t.pkl")["predictions"],
                               pd.read_pickle(tmp_path / "j.pkl")["predictions"], rtol=1e-4)


# -- the normalizer -------------------------------------------------------------------------------

@pytest.mark.parametrize("with_lengths", [False, True])
def test_normalizer_fit_matches_jax(with_lengths):
    rng = _rng(7)
    feats = (rng.normal(size=(9, 30, 6)) * 3 + 1).astype(np.float32)
    lengths = rng.integers(5, 31, size=9) if with_lengths else None
    got = tnorm.FeatureNormalizer().fit(feats, lengths=lengths)
    want = jnorm.FeatureNormalizer().fit(feats, lengths=lengths)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-6)
    assert got.mean.dtype == got.std.dtype == np.float32
    frames = np.concatenate([f[:n] for f, n in zip(feats, lengths)]) if with_lengths else feats.reshape(-1, 6)
    np.testing.assert_allclose(got.std, frames.astype(np.float64).std(axis=0, ddof=1), rtol=1e-6)
    listed = tnorm.FeatureNormalizer().fit([f[:n] for f, n in zip(feats, lengths)] if with_lengths else list(feats))
    np.testing.assert_allclose(listed.mean, got.mean, rtol=1e-6)


def test_build_normalizer_fits_bonafide_rows_and_persists(tmp_path):
    rng = _rng(8)
    feats = rng.normal(size=(10, 6, 12)).astype(np.float32)
    labels = (np.arange(10) % 2).astype(np.int32)
    feats[labels == 0] += 100.0  # spoof rows must not reach the statistics
    got = tnorm.build_normalizer(feats, labels)
    want = jnorm.build_normalizer(feats, labels)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-6)
    assert np.abs(got.mean).max() < 5
    np.testing.assert_allclose(tnorm.build_normalizer(feats, None).mean, jnorm.build_normalizer(feats, None).mean,
                               rtol=1e-6)
    got.save(str(tmp_path / "n"))
    for loaded in (tnorm.FeatureNormalizer.load(str(tmp_path / "n.npz")),
                   jnorm.FeatureNormalizer.load(str(tmp_path / "n.npz"))):
        np.testing.assert_array_equal(loaded.mean, got.mean)
        np.testing.assert_array_equal(loaded.std, got.std)
    torch.save({"mean": torch.from_numpy(got.mean), "std": torch.from_numpy(got.std)}, tmp_path / "normalizer.pt")
    pt = tnorm.FeatureNormalizer.load(str(tmp_path / "normalizer.pt"))
    np.testing.assert_array_equal(pt.mean, got.mean)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.inverse_transform(pt.transform(x)), x, atol=1e-5)
    with pytest.raises(ValueError, match="zero frames"):
        tnorm.FeatureNormalizer().fit(np.zeros((0, 12, 6), np.float32))


@pytest.mark.parametrize("scheme", ["raw", "cmn", "cvmn"])
def test_apply_utterance_norm_matches_jax(scheme):
    feats = (_rng(9).normal(size=(4, 6, 25)) * 2 + 3).astype(np.float32)
    feats[0, 0] = 1.5  # a constant row: the std clamp
    np.testing.assert_allclose(tnorm.apply_utterance_norm(feats, scheme), jnorm.apply_utterance_norm(feats, scheme),
                               atol=1e-6)
