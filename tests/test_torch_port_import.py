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
    "dfac_tpu_torch.cli.evaluate", "dfac_tpu_torch.cli.extract_features", "dfac_tpu_torch.cli.predict",
    "dfac_tpu_torch.data.pipeline", "dfac_tpu_torch.device", "dfac_tpu_torch.features.lfcc",
    "dfac_tpu_torch.io.npy_store", "dfac_tpu_torch.io.pickle_io", "dfac_tpu_torch.io.prefetch",
    "dfac_tpu_torch.models.cnn2d", "dfac_tpu_torch.models.common", "dfac_tpu_torch.models.fast_infer",
    "dfac_tpu_torch.ops._build", "dfac_tpu_torch.ops.conv_block", "dfac_tpu_torch.ops.conv_probe",
    "dfac_tpu_torch.ops.eer", "dfac_tpu_torch.ops.gemm_frontend", "dfac_tpu_torch.ops.lfcc_kernel",
    "dfac_tpu_torch.ops.pool", "dfac_tpu_torch.profiling", "dfac_tpu_torch.scripts.pallas_err_probe",
    "dfac_tpu_torch.scripts.pool_kernel_probe", "dfac_tpu_torch.scripts.train_opt_probe",
    "dfac_tpu_torch.train.checkpoint",
    "dfac_tpu_torch.train.evaluate", "dfac_tpu_torch.utils.convert",
    "dfac_tpu_torch.models.cnn1d", "dfac_tpu_torch.models.cae", "dfac_tpu_torch.data.normalizer",
    "dfac_tpu_torch.train.cae_loop", "dfac_tpu_torch.ensemble.hybrid", "dfac_tpu_torch.ensemble.mean",
    "dfac_tpu_torch.io.submission", "dfac_tpu_torch.cli.evaluate_cae", "dfac_tpu_torch.cli.predict_hybrid",
    "dfac_tpu_torch.cli.hybrid_ensemble", "dfac_tpu_torch.cli.ensemble", "dfac_tpu_torch.cli.generate_submission",
    "dfac_tpu_torch.models.detector", "dfac_tpu_torch.train.detector_loop", "dfac_tpu_torch.cli.train_detector",
    "dfac_tpu_torch.obs.cae_dashboard", "dfac_tpu_torch.cli.train_cae",
    "dfac_tpu_torch.models.zoo", "dfac_tpu_torch.obs.factory", "dfac_tpu_torch.obs.rich_visualizer",
    "dfac_tpu_torch.obs.tqdm_visualizer", "dfac_tpu_torch.train.benchmark_harness", "dfac_tpu_torch.cli.benchmark",
    "dfac_tpu_torch.cli.compare_kernels", "dfac_tpu_torch.cli.compare_normalization",
    "dfac_tpu_torch.io.fastcast", "dfac_tpu_torch.models.fast_infer_int8", "dfac_tpu_torch.ops.conv_block_w8a8",
    "dfac_tpu_torch.ensemble.anomaly", "dfac_tpu_torch.cli.data_tools", "dfac_tpu_torch.obs.profiling",
}

_PROBE = """
import importlib, json, pkgutil, sys
import torch
import dfac_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(dfac_tpu_torch.__path__, "dfac_tpu_torch."))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dfac_tpu"))
from dfac_tpu_torch.features.lfcc import LFCCConfig, lfcc_features_batch
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores, fused_conv_block
from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_cepstra, gemm_lfcc_features_tf
cfg = LFCCConfig()
feats = gemm_lfcc_features_tf(torch.zeros(2, cfg.num_samples(9)), cfg, torch.bfloat16)
fused_conv_block(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 2), torch.zeros(2))
folded = {f"w{i}": torch.zeros(3, 3, c, 2 * c if i > 1 else 4) for i, c in ((1, 1), (2, 4), (3, 8))}
folded.update({f"b{i}": torch.zeros(c) for i, c in ((1, 4), (2, 8), (3, 16))}, w_cls=torch.zeros(16 * 180, 1), b_cls=torch.zeros(1))
scores = cnn2d_fused_scores(folded, feats)
for method in ("gemm", "fft-pallas", "fft"):
    lfcc_features_batch(torch.zeros(3, cfg.num_samples(9)).numpy(), cfg, 2, method, device="cpu")
from dfac_tpu_torch.ops.conv_probe import conv1_taps_checksum, conv2_checksum, patches_checksum
from dfac_tpu_torch.ops.pool import time_pool
time_pool(torch.zeros(1, 5, 2, 2, dtype=torch.bfloat16), tt=2)
conv1_taps_checksum(torch.zeros(1, 322, 130, dtype=torch.bfloat16), torch.zeros(9, 2, dtype=torch.bfloat16), "slice")
patches_checksum(torch.zeros(1, 2, 3, 9, dtype=torch.bfloat16), torch.zeros(9, 2, dtype=torch.bfloat16))
conv2_checksum(torch.zeros(1, 162, 8, 4, dtype=torch.bfloat16), torch.zeros(9, 4, 2, dtype=torch.bfloat16), "roll")
from dfac_tpu_torch.ops import conv_probe
x, w = torch.zeros(8, 5, 6, dtype=torch.bfloat16), torch.zeros(3, 3, 8, dtype=torch.bfloat16)
for case in conv_probe.STAGE11_CASES.values():
    case.kernel(x, w)
conv_probe.conv1_valid_checksum(x, w.reshape(9, 8), "fma")
conv_probe.FLAT_WIDTH = 8
conv_probe.flat_shift_checksum(torch.zeros(1, 1, 56, dtype=torch.bfloat16), w.reshape(9, 8))
conv_probe.conv2_dx_checksum(torch.zeros(1, 5, 6, 4, dtype=torch.bfloat16), torch.zeros(3, 12, 2, dtype=torch.bfloat16))
for const, value in (("CONV1_ROWS", 3), ("H2_WINDOW", 3), ("CONV2_ROWS", 3), ("CONV2_SLICE_COLS", 4),
                     ("CONV3_ROWS", 3), ("CONV3_COLS", 4), ("CHUNK_LEN", 20), ("CHUNKS", 2)):
    setattr(conv_probe, const, value)
h, zeros = torch.zeros(1, 5, 6, 4, dtype=torch.bfloat16), torch.zeros(9, 4, 2, dtype=torch.bfloat16)
arrs = {"x": x, "w9": w.reshape(9, 8), "p9": torch.zeros(1, 9, 5, 6, dtype=torch.bfloat16), "h1": h, "w2": zeros,
        "w2i": torch.zeros(3, 12, 2, dtype=torch.bfloat16), "h2arr": h, "w3": zeros,
        "xf": torch.zeros(1, 2, 40, dtype=torch.bfloat16), "wt": torch.zeros(8, 16, dtype=torch.bfloat16)}
for case in {**conv_probe.STAGE14_CASES, **conv_probe.STAGE15_CASES}.values():
    case.kernel(arrs[case.inp], arrs[case.weights])
from dfac_tpu_torch.ops.conv_block_w8a8 import block1_w8a8, conv_block_w8a8
for inv_s, time_mean in ((1.0, False), (None, False), (None, True)):
    conv_block_w8a8(torch.zeros(1, 4, 4, 32, dtype=torch.int8), torch.zeros(3, 3, 32, 64, dtype=torch.int8),
                    torch.ones(64), torch.zeros(64), inv_s, time_mean)
for dt in (torch.float32, torch.bfloat16):
    block1_w8a8(torch.zeros(1, 4, 5), torch.zeros(3, 3, 1, 32), torch.zeros(32), 1.0, dt)
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
    # CPU tensors: plain versions only
    assert report["launches"] == {"gemm_frontend": 0, "conv_block": 0, "fb_log_dct": 0, "time_pool": 0,
                                  "conv_probe": 0, "conv1_pass": 0, "conv_forms": 0, "conv_chunked": 0,
                                  "conv_trailing": 0, "conv_block_w8a8": 0, "block1_w8a8": 0}
    assert report["scores"] == [2]


def test_resolve_device_refuses_missing_cuda():
    from dfac_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
