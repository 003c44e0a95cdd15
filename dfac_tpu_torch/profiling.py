"""Where the device time goes: ``torch.profiler`` over the port's paths.

    python -m dfac_tpu_torch.profiling [--device cuda]

For each path it prints the wall time per batch (host clock ending in a
synchronize, without the profiler, whose own host work would widen the
gaps), the device time per batch and its share of that wall (the busy
share), the device ops (kernels and copies) per batch, and the items that
take the most device time. The paths, at the corpus geometry (16 kHz,
321 frames of 180 features), 16 batches each, with inputs from a seed:

* ``slice``: waveform -> K1 bf16 -> delta/delta-delta -> three K2 blocks
  -> scores, CNN2D at full width with random weights, B=128;
* ``predict f32``: on-device features -> three K2 blocks in f32 -> scores,
  the chain ``predict --fast`` runs by default, same weights, B=128;
* ``extract <method>``: batches of on-device waveforms through
  :func:`~dfac_tpu_torch.features.lfcc.batch_features`, B=64;
* ``extract <method>, host round trip``: the CLI's driver
  :func:`~dfac_tpu_torch.features.lfcc.lfcc_features_batch` on host numpy,
  so the uploads and the device-to-host copies show;
* ``pool probe <pool>``: the chain of
  :mod:`dfac_tpu_torch.scripts.pool_kernel_probe` with each of its three
  pools on on-device bf16 features, B=512.

On the CPU the profiler records no device time; every path still runs.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

TOP = 8  # items listed per path
BATCHES = 16  # per timed and per profiled run
FRAMES = 321
SLICE_BATCH = 128  # the slice's throughput geometry (chip_smoke.py)
EXTRACT_BATCH = 64  # the extraction CLI's default
POOL_BATCH = 512  # the pool probe's default
POOL_FRAMES = 321
SEED = 0


def device_us(evt) -> float:
    """A profiler row's device time in us (``cuda_time_total`` in older torch)."""
    return evt.device_time_total if hasattr(evt, "device_time_total") else evt.cuda_time_total


def _wall_ms(fn, n_batches: int, sync) -> float:
    fn()  # warm-up: builds, caches and cuFFT plans
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / n_batches


def kernel_device_ms(fn, kernel: str, reps: int = 10) -> tuple[float, int] | None:
    """(device ms per launch, launches) of the kernels whose name holds
    ``kernel``, from ``torch.profiler``'s kernel records over ``reps`` calls
    of ``fn`` after one call to warm up; None where no such kernel ran on
    a device (on the CPU, none does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        for _ in range(reps):
            fn()
        sync()
    found = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in found)
    return (sum(device_us(e) for e in found) / 1e3 / launches, launches) if launches else None


def profile_path(label: str, fn, n_batches: int, device: torch.device) -> dict:
    """Time ``fn`` (which runs ``n_batches`` batches), then profile one more
    run; print the summary and return it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wall = _wall_ms(fn, n_batches, sync)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        sync()
    rows = sorted(
        ((e.key, e.count, device_us(e)) for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[2],
    )
    dev_ms = sum(r[2] for r in rows) / 1e3 / n_batches
    ops = sum(r[1] for r in rows) / n_batches
    summary = {"label": label, "wall_ms": wall, "device_ms": dev_ms, "ops": ops,
               "busy": dev_ms / wall if rows else None}
    if not rows:
        print(f"[profile] {label}: wall {wall:.4f} ms per batch; device time not traced on {device}")
        return summary
    print(f"[profile] {label}: wall {wall:.4f} ms per batch, device {dev_ms:.4f} ms "
          f"(busy {100 * dev_ms / wall:.1f}%), {ops:.1f} device ops per batch")
    for name, count, us in rows[:TOP]:
        print(f"[profile]   {us / 1e3 / n_batches:8.4f} ms {100 * us / 1e3 / n_batches / dev_ms:5.1f}% "
              f"{count / n_batches:5.1f}x  {name[:90]}")
    return summary


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description="Profile the port's serving slice, f32 predict chain, extraction and "
                                            "pool-probe paths.")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    args = p.parse_args(argv)
    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.features.lfcc import METHODS, LFCCConfig, batch_features, lfcc_features_batch
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import fold_cnn2d
    from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores
    from dfac_tpu_torch.ops.gemm_frontend import gemm_lfcc_features_tf
    from dfac_tpu_torch.scripts import pool_kernel_probe

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
        print(f"[profile] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg = LFCCConfig()
    n_samples = cfg.num_samples(FRAMES)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.manual_seed(SEED)
    model = build_model("cnn2d", in_features=cfg.feature_dim, base_channels=32)
    folded = {k: v.to(dev) for k, v in fold_cnn2d(model.state_dict()).items()}
    waves = torch.randn(BATCHES, SLICE_BATCH, n_samples, device=dev, generator=gen)

    def run_slice():
        with torch.inference_mode():
            for wv in waves:
                cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv, cfg, torch.bfloat16))

    out = [profile_path(f"slice B={SLICE_BATCH}", run_slice, BATCHES, dev)]
    del waves
    feats = torch.randn(BATCHES, SLICE_BATCH, FRAMES, cfg.feature_dim, device=dev, generator=gen)

    def run_f32():
        with torch.inference_mode():
            for f in feats:
                cnn2d_fused_scores(folded, f, compute_dtype=torch.float32)

    out.append(profile_path(f"predict f32 B={SLICE_BATCH}", run_f32, BATCHES, dev))
    del feats
    ext = 0.1 * torch.randn(BATCHES, EXTRACT_BATCH, n_samples, device=dev, generator=gen)
    ext_host = ext.reshape(-1, n_samples).cpu().numpy()
    for method in METHODS:

        def on_device(method=method):
            with torch.inference_mode():
                for wv in ext:
                    batch_features(wv, cfg, method)

        def round_trip(method=method):
            lfcc_features_batch(ext_host, cfg, EXTRACT_BATCH, method, dev)

        out.append(profile_path(f"extract {method} B={EXTRACT_BATCH}", on_device, BATCHES, dev))
        out.append(profile_path(f"extract {method} B={EXTRACT_BATCH}, host round trip", round_trip,
                                BATCHES, dev))
    folded = {k: v.to(dev) for k, v in fold_cnn2d(pool_kernel_probe.random_cnn2d(SEED).state_dict()).items()}
    feats = torch.randn(BATCHES, POOL_BATCH, POOL_FRAMES, cfg.feature_dim, device=dev, generator=gen)
    feats = feats.to(torch.bfloat16)
    for name, pool in pool_kernel_probe.POOLS.items():
        chain = pool_kernel_probe.make_chain(folded, pool)

        def run_chain(chain=chain):
            with torch.inference_mode():
                for x in feats:
                    chain(x)

        out.append(profile_path(f"pool probe {name} B={POOL_BATCH}", run_chain, BATCHES, dev))
    return out


if __name__ == "__main__":
    main()
