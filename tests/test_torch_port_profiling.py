"""The profiler of the port's paths runs every path (on the CPU, where the
profiler traces no device time) at a small size."""

from dfac_tpu_torch import profiling


def test_profiler_runs_every_path(capsys, monkeypatch):
    for name, value in (("BATCHES", 2), ("FRAMES", 9), ("SLICE_BATCH", 2), ("EXTRACT_BATCH", 2), ("POOL_BATCH", 2),
                        ("POOL_FRAMES", 64)):
        monkeypatch.setattr(profiling, name, value)
    out = profiling.main(["--device", "cpu"])
    labels = [r["label"] for r in out]
    assert labels == ["slice B=2", "predict f32 B=2"] + [
        f"extract {m} B=2{tail}" for m in ("gemm", "fft-pallas", "fft") for tail in ("", ", host round trip")
    ] + [f"pool probe {p} B=2" for p in ("reduce_window", "depthwise", "pallas")]
    assert all(r["wall_ms"] > 0 and r["device_ms"] == 0 and r["busy"] is None for r in out)
    printed = capsys.readouterr().out
    assert printed.count("device time not traced on cpu") == len(out)


def test_chain_rates_warm_up_then_time_each_run():
    from dfac_tpu_torch import chain_rates

    calls = []
    r = chain_rates.rates(lambda: calls.append(1), 100, reps=3)
    assert len(calls) == 4 and len(r) == 3 and all(x > 0 for x in r)
    line = chain_rates.summary("chain", [1.0, 3.0, 2.0])
    assert line == "chain 2.0 utt/s (median of 3; min 1.0, max 3.0)"


def test_kernel_device_ms_finds_no_device_kernel_on_the_cpu():
    calls = []
    assert profiling.kernel_device_ms(lambda: calls.append(1), "fb_log_dct_kernel", reps=3) is None
    assert len(calls) == 4  # one to warm up, then the profiled calls
