"""Reference ``.pt`` checkpoints whose metadata holds numpy values or an
``argparse.Namespace``: the port loads them to the same ``state_dict`` as
the JAX package, and still refuses a pickle that names any other global."""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

from dfac_tpu.train.checkpoint import load_model_variables as j_load
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.train.checkpoint import load_model_variables as t_load
from dfac_tpu_torch.utils.convert import state_dict_from_jax


class _Forbidden:
    """Pickles as a call of ``os.system``, a global no checkpoint needs."""

    def __reduce__(self):
        return os.system, ("true",)


CASES = {
    "np_float64_config": {"config": np.float64(0.1)},
    "namespace_config": {"config": argparse.Namespace(lr=0.1, model="cnn2d", dropout=np.float32(0.2))},
    "np_int64_epoch": {"epoch": np.int64(7), "config": {"lr": 1e-3}},
    "0d_ndarray_config": {"config": {"lr": np.array(0.5), "shape": np.array([180, 321])}},
    "forbidden_global": {"config": _Forbidden()},
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_pt_metadata_loads_like_jax(tmp_path, case):
    torch.manual_seed(0)
    model = build_model("cnn2d", in_features=20, base_channels=8).eval()
    with torch.no_grad():  # non-trivial BN statistics
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2)
                mod.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "cnn2d_best.pt")
    meta = {"epoch": 3, **CASES[case]}
    torch.save({"model_state": model.state_dict(), "optimizer_state": {}, **meta}, path)
    if case == "forbidden_global":
        with pytest.raises(pickle.UnpicklingError, match="os.system|posix.system"):
            t_load(path, "cnn2d")
        return
    got = t_load(path, "cnn2d")
    want = state_dict_from_jax(j_load(path, model_name="cnn2d"), "cnn2d")
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)  # the same stored floats
