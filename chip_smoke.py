#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (``dfac_tpu_torch``) end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; each prints its lines, and any failure ends the run with a
non-zero exit code and no result line:

1. device   torch / CUDA / nvcc versions, the card's name and power limit
2. build    both kernels from ``dfac_tpu_torch/csrc`` (nvcc, sm_90a), with
            ptxas' registers and spills and the dynamic shared memory of
            each kernel
3. K1       the GEMM front-end kernel against its plain version, B=128
            waveforms of 51,520 samples, bf16 and f32
4. K2       the fused conv-block kernel against its plain version at the
            three serving block shapes, bf16
5. slice    waveforms -> front-end -> three fused blocks -> scores at full
            CNN2D width (weights from a seed), against the all-plain chain
            and the f32 model; the launch counters must show 1 front-end and
            3 conv-block launches per batch
6. CLI      ``python -m dfac_tpu_torch.cli.predict --fast --bf16`` on a
            synthetic 512-utterance features.pkl, then the evaluate CLI
7. timing   slice utt/s over 8,192 on-device utterances at B=128 (median of
            7, host clock ending in a synchronize) and each kernel against its
            plain version with CUDA events, in turns

The last two lines are a JSON object with one entry per kernel (for
``conv_block``, ``ms`` and ``plain_ms`` are the sums over the three block
shapes of one batch) and ``{"ok": true, "device": {...}}``. The script
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
N_FRAMES = 321
CORPUS = 8192
CLI_UTTS = 512

# tolerances, with their reasons
K1_ATOL, K1_RTOL = 1e-3, 1e-3  # same operands; only the f32 summation order of
# the K=320 DFT and the 120-term DCT differs, and log() amplifies relative error
# of the smallest energies
K2_RTOL, K2_ATOL = 2.0**-7, 1e-4  # one bf16 last bit: kernel and plain round
# f32 sums taken in different orders, which can straddle a rounding boundary
SCORE_ATOL = 2e-2  # sigmoid scores of two bf16 chains, as tests/test_conv_block.py:45


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def require(ok, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def max_errors(got, want):
    d = (got.float() - want.float()).abs()
    rel = d / want.float().abs().clamp_min(1e-6)
    return d.max().item(), rel.max().item()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int = 10):
    """plain, kernel, kernel, plain after a warm-up of each; returns the mean
    ms of the kernel and of the plain version."""
    plain(), kernel()
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dfac_tpu_torch.features.lfcc import LFCCConfig
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import fold_cnn2d
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores, cnn2d_head, fused_conv_block, reference_conv_block
    from dfac_tpu_torch.ops.gemm_frontend import append_deltas, cepstra_plain, gemm_lfcc_cepstra, gemm_lfcc_features_tf

    # -- 1. device --------------------------------------------------------
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True, capture_output=True, text=True).stdout
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc.strip().splitlines()[-1]}")
    phase("device", f"card: {card}; devices: {torch.cuda.device_count()}")
    # the plain versions are the f32 reference: no TF32 in matmul or cuDNN conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    phase("build", f"{os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f}s")
    smem = {
        "frontend_kernel bf16": lib.dfac_gemm_frontend_smem(1),
        "frontend_kernel f32": lib.dfac_gemm_frontend_smem(0),
        "conv_block_cin1 1->32": lib.dfac_conv_block_smem(1, 32, 1),
        "conv_block_mma 32->64": lib.dfac_conv_block_smem(32, 64, 1),
        "conv_block_mma 64->128": lib.dfac_conv_block_smem(64, 128, 1),
    }
    phase("build", "dynamic shared memory per block: " + ", ".join(f"{k} {v:,} B" for k, v in smem.items()))
    name = None
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"entry function '\S*?(frontend_kernel|conv_block_mma|conv_block_direct)I(\w*?)EEv", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"  # template arguments, mangled
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            phase("build", f"ptxas {name}: {m.group(1)} registers")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and m.group(1) != "0":
            phase("build", f"ptxas {name}: {m.group(1)} bytes spill stores")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = LFCCConfig()
    n_samples = cfg.num_samples(N_FRAMES)

    # -- 3. K1 vs plain ---------------------------------------------------
    wave = torch.randn(BATCH, n_samples, device=dev, generator=gen)
    k1_err = {}
    for dt in (torch.bfloat16, torch.float32):
        got = gemm_lfcc_cepstra(wave, cfg, dt)
        want = cepstra_plain(wave, cfg, dt)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (BATCH, N_FRAMES, cfg.n_ceps), got.shape)
        require(torch.isfinite(got).all(), "K1 output is not finite")
        abs_err, rel_err = max_errors(got, want)
        ok = bool(((got - want).abs() <= K1_ATOL + K1_RTOL * want.abs()).all())
        phase("K1", f"{str(dt)[6:]} {tuple(got.shape)}: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
                    f"(tolerance atol {K1_ATOL} + rtol {K1_RTOL})")
        if not ok:
            raise AssertionError(f"K1 {dt} disagrees with its plain version")
        k1_err[dt] = abs_err

    # -- 4. K2 vs plain ---------------------------------------------------
    shapes = [((BATCH, 321, 180, 1), 32, True), ((BATCH, 160, 180, 32), 64, True), ((BATCH, 80, 180, 64), 128, False)]
    k2_inputs, k2_err = [], 0.0
    for xs, c_out, pool in shapes:
        x = torch.randn(*xs, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.randn(3, 3, xs[-1], c_out, device=dev, generator=gen) * (2.0 / (9 * xs[-1])) ** 0.5
        b = torch.randn(c_out, device=dev, generator=gen) * 0.1
        got = fused_conv_block(x, w, b, pool)
        want = reference_conv_block(x, w, b, pool)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bfloat16, (got.shape, want.shape))
        gf, wf = got.float(), want.float()
        ok = bool(((gf - wf).abs() <= K2_ATOL + K2_RTOL * torch.maximum(gf.abs(), wf.abs())).all())
        abs_err, rel_err = max_errors(got, want)
        phase("K2", f"bf16 x{xs} -> {tuple(got.shape)} pool={pool}: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
                    f"(tolerance one bf16 last bit: rtol 2^-7 + atol {K2_ATOL})")
        if not ok:
            raise AssertionError(f"K2 {xs} disagrees with its plain version")
        k2_err = max(k2_err, abs_err)
        k2_inputs.append((x, w, b, pool))

    # -- 5. end-to-end slice ----------------------------------------------
    torch.manual_seed(SEED)
    model = build_model("cnn2d", in_features=cfg.feature_dim, base_channels=32).to(dev).eval()
    with torch.no_grad():  # non-trivial BN statistics, so the folding is exercised
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.2, 0.2, generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.uniform_(-0.1, 0.1, generator=gen)
    folded = fold_cnn2d(model.state_dict())
    n_batches = 2
    waves = torch.randn(n_batches, BATCH, n_samples, device=dev, generator=gen)

    _build.reset_launch_counts()
    with torch.inference_mode():
        scores = [cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv, cfg, torch.bfloat16)) for wv in waves]
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    phase("slice", f"launches over {n_batches} batches: {launches}")
    if launches != {"gemm_frontend": n_batches, "conv_block": 3 * n_batches}:
        raise AssertionError(f"the slice did not run through the kernels as expected: {launches}")

    with torch.inference_mode():
        for wv, got in zip(waves, scores):
            feats_plain = append_deltas(cepstra_plain(wv, cfg, torch.bfloat16), cfg)
            h = feats_plain.to(torch.bfloat16)[..., None]
            for i, pool in ((1, True), (2, True), (3, False)):
                h = reference_conv_block(h, folded[f"w{i}"], folded[f"b{i}"], pool)
            plain = cnn2d_head(h, folded)
            f32_model = torch.sigmoid(model(feats_plain)[:, 0])
            require(got.shape == (BATCH,) and torch.isfinite(got).all(), "slice scores")
            d_plain = (got - plain).abs().max().item()
            d_model = (got - f32_model).abs().max().item()
            phase("slice", f"scores {tuple(got.shape)} in [{got.min().item():.4f}, {got.max().item():.4f}]: "
                           f"max |kernels - all-plain| {d_plain:.3e}, max |kernels - f32 model| {d_model:.3e} "
                           f"(tolerance {SCORE_ATOL})")
            if d_plain > SCORE_ATOL or d_model > SCORE_ATOL:
                raise AssertionError("slice scores disagree with the plain chain")

    # -- 6. CLI -----------------------------------------------------------
    import pandas as pd

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_") as tmp:
        labels = (np.arange(CLI_UTTS) % 2).astype(np.int64)
        feats = rng.normal(size=(CLI_UTTS, cfg.feature_dim, N_FRAMES)).astype(np.float32)
        feats[labels == 1, :60, :] += 1.5  # separable on the LFCC block
        uttids = [f"utt{i:05d}" for i in range(CLI_UTTS)]
        fpath, lpath = os.path.join(tmp, "features.pkl"), os.path.join(tmp, "labels.pkl")
        ckpt, pred = os.path.join(tmp, "cnn2d_best.pt"), os.path.join(tmp, "prediction.pkl")
        pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(fpath)
        pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(lpath)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run(
            [sys.executable, "-m", "dfac_tpu_torch.cli.predict", "--features", fpath, "--checkpoint", ckpt,
             "--model", "cnn2d", "--out", pred, "--fast", "--bf16", "--device", "cuda"],
            check=True, capture_output=True, text=True, cwd=ROOT, env=env,
        ).stdout
        for line in out.strip().splitlines():
            phase("cli", f"predict: {line}")
        df = pd.read_pickle(pred)
        require(list(df.columns) == ["uttid", "predictions"] and len(df) == CLI_UTTS, df.shape)
        require(np.isfinite(df["predictions"].to_numpy()).all(), "predictions are not finite")
        out = subprocess.run(
            [sys.executable, "-m", "dfac_tpu_torch.cli.evaluate", pred, lpath],
            check=True, capture_output=True, text=True, cwd=ROOT, env=env,
        ).stdout
        eer = float(re.search(r"EER: (\S+)", out).group(1))
        phase("cli", f"evaluate: {' | '.join(out.strip().splitlines())}")
        if not np.isfinite(eer):
            raise AssertionError(f"EER is not finite: {eer}")

    # -- 7. timing --------------------------------------------------------
    corpus = torch.randn(CORPUS // BATCH, BATCH, n_samples, device=dev, generator=gen)

    def score_corpus():
        with torch.inference_mode():
            out = [cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv, cfg, torch.bfloat16)) for wv in corpus]
        torch.cuda.synchronize()
        return out

    score_corpus()  # warm-up
    rates = []
    for _ in range(7):
        t0 = time.perf_counter()
        score_corpus()
        rates.append(CORPUS / (time.perf_counter() - t0))
    utt_s = statistics.median(rates)
    phase("timing", f"slice {utt_s:.1f} utt/s (median of 7; min {min(rates):.1f}, max {max(rates):.1f}), "
                    f"{CORPUS} utterances of {n_samples} samples at B={BATCH}, bf16, on {card}")

    k1_ms, k1_plain = in_turns(lambda: cepstra_plain(wave, cfg, torch.bfloat16),
                               lambda: gemm_lfcc_cepstra(wave, cfg, torch.bfloat16))
    phase("timing", f"K1 gemm_frontend bf16 B={BATCH}: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, on {card}")
    k2_ms = k2_plain = 0.0
    for x, w, b, pool in k2_inputs:
        ms, plain_ms = in_turns(lambda: reference_conv_block(x, w, b, pool), lambda: fused_conv_block(x, w, b, pool))
        k2_ms, k2_plain = k2_ms + ms, k2_plain + plain_ms
        phase("timing", f"K2 conv_block bf16 x{tuple(x.shape)} pool={pool}: kernel {ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms, on {card}")

    kernels = [
        {"name": "gemm_frontend", "route": "cuda", "source": "dfac_tpu_torch/csrc/gemm_frontend.cu",
         "replaces": "dfac_tpu/ops/pallas/gemm_frontend.py:71", "launches": launches["gemm_frontend"],
         "max_abs_err": k1_err[torch.bfloat16], "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "conv_block", "route": "cuda", "source": "dfac_tpu_torch/csrc/conv_block.cu",
         "replaces": "dfac_tpu/ops/pallas/conv_block.py:142", "launches": launches["conv_block"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
