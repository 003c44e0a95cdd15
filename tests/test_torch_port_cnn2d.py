"""PyTorch port of CNN2D, BN folding and the serving chains against JAX.

Weights are made by the JAX package (flax init, then BatchNorm statistics
and affine parameters drawn with numpy from a seed so the folding does real
work) and carried over with ``state_dict_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu import models as jmodels
from dfac_tpu.models import build_model as jbuild
from dfac_tpu.models import fast_infer as jfast
from dfac_tpu.ops.pallas import conv_block as jcb
from dfac_tpu_torch import models as tmodels
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.ops import conv_block as tcb
from dfac_tpu_torch.utils.convert import state_dict_from_jax

F_, T_, BC = 20, 33, 8


def jax_cnn2d(in_features=F_, base_channels=BC, frames=T_, seed=0):
    """(flax module, numpy variables) with non-trivial BN statistics."""
    model = jbuild("cnn2d", in_features=in_features, base_channels=base_channels)
    variables = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, frames, in_features)))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    for i in (1, 2, 3):
        c = variables["params"][f"bn{i}"]["scale"].shape[0]
        variables["params"][f"bn{i}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        variables["params"][f"bn{i}"]["bias"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
        variables["batch_stats"][f"bn{i}"]["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        variables["batch_stats"][f"bn{i}"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return model, variables


def torch_cnn2d(variables, in_features=F_, base_channels=BC):
    model = tbuild("cnn2d", in_features=in_features, base_channels=base_channels).eval()
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def _feats(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_state_dict_matches_reference_names():
    _, variables = jax_cnn2d()
    sd = state_dict_from_jax(variables)
    ref = tbuild("cnn2d", in_features=F_, base_channels=BC).state_dict()
    assert list(sd) == list(ref)  # strict load_state_dict also checks shapes
    assert {k.rsplit(".", 1)[0] for k in sd} == {
        "conv.0", "conv.1", "conv.5", "conv.6", "conv.10", "conv.11", "classifier"
    }


def test_cnn2d_eval_matches_jax_apply():
    jmodel, variables = jax_cnn2d()
    tmodel = torch_cnn2d(variables)
    x = _feats((3, T_, F_))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1)
    # f32 on both sides (flax at Precision.HIGHEST); summation order only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fold_matches_jax():
    _, variables = jax_cnn2d()
    want = jfast.fold_cnn2d(variables)
    got = tfast.fold_cnn2d(torch_cnn2d(variables).state_dict())
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        # rsqrt in f32 on both sides may differ in the last bit
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stored", [False, True])
def test_fast_scores_match_jax_f32(stored):
    jmodel, variables = jax_cnn2d()
    folded_j = jfast.fold_cnn2d(variables)
    folded_t = tfast.fold_cnn2d(torch_cnn2d(variables).state_dict())
    x_tf = _feats((4, T_, F_), seed=2)
    if stored:
        x = np.ascontiguousarray(np.swapaxes(x_tf, 1, 2))
        want = jfast.cnn2d_fast_scores(folded_j, jnp.asarray(x), compute_dtype=jnp.float32)
        got = tfast.cnn2d_fast_scores(folded_t, torch.from_numpy(x), compute_dtype=torch.float32)
    else:
        want = jfast.cnn2d_fast_scores_tf(folded_j, jnp.asarray(x_tf), compute_dtype=jnp.float32)
        got = tfast.cnn2d_fast_scores_tf(folded_t, torch.from_numpy(x_tf), compute_dtype=torch.float32)
    ref = np.asarray(jax.nn.sigmoid(jmodel.apply(variables, jnp.asarray(x_tf))[:, 0]))
    # f32 chains: folding and summation order only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_fused_scores_match_jax_pallas_bf16():
    _, variables = jax_cnn2d()
    folded_j = jfast.fold_cnn2d(variables)
    folded_t = tfast.fold_cnn2d(torch_cnn2d(variables).state_dict())
    x = _feats((2, 64, F_), seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jcb.cnn2d_fused_scores(folded_j, jnp.asarray(x)))
    got = tcb.cnn2d_fused_scores(folded_t, torch.from_numpy(x)).numpy()
    # bf16 activations on both sides (tests/test_conv_block.py:45)
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_build_model_names_what_is_not_ported():
    """An unknown name raises the JAX registry's ValueError; every JAX name builds."""
    with pytest.raises(ValueError, match="unknown model 'cnn3d'; choose from"):
        tbuild("cnn3d")
    with pytest.raises(ValueError, match="unknown model 'cnn3d'"):
        jbuild("cnn3d")
    assert sorted(tmodels.MODEL_REGISTRY) == sorted(jmodels.MODEL_REGISTRY)
    assert isinstance(tbuild("statspool_mlp", in_features=F_, hidden_dim=8), torch.nn.Module)
    model = tbuild("cnn2d", in_features=F_, base_channels=BC, hidden_dim=7)  # unknown override ignored
    assert model.classifier.in_features == 4 * BC * F_
