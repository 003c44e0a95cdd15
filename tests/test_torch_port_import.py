"""The port imports no JAX, and a CPU call launches no kernel."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

EXPECTED = {
    "dfac_tpu_torch.cli.evaluate", "dfac_tpu_torch.cli.predict", "dfac_tpu_torch.data.pipeline",
    "dfac_tpu_torch.device", "dfac_tpu_torch.features.lfcc", "dfac_tpu_torch.io.pickle_io",
    "dfac_tpu_torch.io.prefetch", "dfac_tpu_torch.models.cnn2d", "dfac_tpu_torch.models.common",
    "dfac_tpu_torch.models.fast_infer", "dfac_tpu_torch.ops._build", "dfac_tpu_torch.ops.conv_block",
    "dfac_tpu_torch.ops.eer", "dfac_tpu_torch.ops.gemm_frontend", "dfac_tpu_torch.train.checkpoint",
    "dfac_tpu_torch.train.evaluate", "dfac_tpu_torch.utils.convert",
}

_PROBE = """
import importlib, json, pkgutil, sys
import torch
import dfac_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(dfac_tpu_torch.__path__, "dfac_tpu_torch."))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dfac_tpu"))
from dfac_tpu_torch.features.lfcc import LFCCConfig
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores, fused_conv_block
from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_cepstra, gemm_lfcc_features_tf
cfg = LFCCConfig()
feats = gemm_lfcc_features_tf(torch.zeros(2, cfg.num_samples(9)), cfg, torch.bfloat16)
fused_conv_block(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 2), torch.zeros(2))
folded = {f"w{i}": torch.zeros(3, 3, c, 2 * c if i > 1 else 4) for i, c in ((1, 1), (2, 4), (3, 8))}
folded.update({f"b{i}": torch.zeros(c) for i, c in ((1, 4), (2, 8), (3, 16))}, w_cls=torch.zeros(16 * 180, 1), b_cls=torch.zeros(1))
scores = cnn2d_fused_scores(folded, feats)
print(json.dumps({"mods": mods, "bad": bad, "launches": _build.launch_counts(), "scores": list(scores.shape)}))
"""


def test_port_imports_no_jax_and_cpu_launches_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], check=True, capture_output=True, text=True, env=env, cwd=str(ROOT)
    ).stdout
    report = json.loads(out.strip().splitlines()[-1])
    assert EXPECTED <= set(report["mods"])
    assert report["bad"] == []
    assert report["launches"] == {"gemm_frontend": 0, "conv_block": 0}  # CPU tensors: plain versions only
    assert report["scores"] == [2]


def test_resolve_device_refuses_missing_cuda():
    from dfac_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
