"""The port's feature-extraction path against the JAX package: the post-FFT
kernel's plain version, the rFFT front-end with and without it, the batch
driver for every method, the extraction CLI, the ``.npy`` store and the
predict CLI on a store.

Inputs are numpy from a seed; both packages run on the CPU, the Pallas
kernels in interpret mode. Without interpret mode the JAX driver's 'gemm'
and 'fft-pallas' quietly fall back to 'fft' on the CPU, so every JAX call
here runs under it and the tests assert that the fallback never fired.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.features import lfcc as jlfcc
from dfac_tpu.ops.pallas import lfcc_kernel as jkernel
from dfac_tpu_torch.features import lfcc as tlfcc
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops import lfcc_kernel as tkernel

CFG_J = jlfcc.LFCCConfig()
CFG_T = tlfcc.LFCCConfig()
FRAMES = 17
# f32 products and FFTs of the same constants in different summation orders
# (numpy/PocketFFT against XLA); the log amplifies the error of the smallest
# energies (the bound of tests/test_torch_port_frontend.py's GEMM parity)
ATOL, RTOL = 5e-4, 1e-4


def _waves(n, frames=FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    samples = CFG_T.num_samples(frames)
    t = np.arange(samples) / CFG_T.sample_rate
    tone = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 3333 * t)
    return (tone + 0.05 * rng.normal(size=(n, samples))).astype(np.float32)


def _no_jax_fallback(caplog):
    warned = [r.getMessage() for r in caplog.records if r.name == jlfcc.__name__ and r.levelno >= logging.WARNING]
    assert warned == [], warned


def _spy(monkeypatch, module, name):
    """Wrap ``module.name`` so its calls are recorded: a list of (args, result)."""
    real, calls = getattr(module, name), []

    def spy(*args):
        calls.append((args, real(*args)))
        return calls[-1][1]

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("lead", [(300,), (2, 3, 50)])
def test_fb_log_dct_plain_matches_jax_kernel(lead, monkeypatch):
    """300 rows: not a multiple of the Pallas kernel's 256-row tile; the
    first rows are all zero, so every filter hits the log floor."""
    rng = np.random.default_rng(1)
    power = (rng.random((*lead, 257)) ** 4 * 100).astype(np.float32)
    power.reshape(-1, 257)[:7] = 0.0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkernel.fused_fb_log_dct(jnp.asarray(power), CFG_J))
    plain = tkernel.fb_log_dct_plain(torch.from_numpy(power), CFG_T).numpy()
    assert plain.shape == want.shape == (*lead, 60)
    # same f32 math, other summation order (the JAX package's own bound,
    # tests/test_lfcc.py:112)
    np.testing.assert_allclose(plain, want, atol=1e-4, rtol=1e-4)
    floor_row = np.log(np.float32(CFG_T.log_floor)) * tlfcc.dct_matrix(120, 60).sum(0)
    np.testing.assert_allclose(plain.reshape(-1, 60)[0], floor_row, atol=1e-4, rtol=1e-5)
    # a CPU tensor takes the plain version and launches nothing (checked by
    # identity: two CPU BLAS calls need not sum in the same order)
    calls = _spy(monkeypatch, tkernel, "fb_log_dct_plain")
    launches = _build.launch_counts()
    t = torch.from_numpy(power)
    wrapped = tkernel.fused_fb_log_dct(t, CFG_T)
    assert len(calls) == 1 and calls[0][0][0] is t and wrapped is calls[0][1]
    assert _build.launch_counts() == launches
    np.testing.assert_allclose(wrapped.numpy(), want, atol=1e-4, rtol=1e-4)


def test_kernels_share_banded_constants():
    """K1 and K4 read one cache of the f32 filterbank, its bands and the DCT:
    K1's host constants bit for bit, the same tensors on every call."""
    from dfac_tpu_torch.ops import gemm_frontend as tgemm

    cpu = torch.device("cpu")
    fb, fb_lo, fb_hi, dct = tlfcc.banded_constants(CFG_T, cpu)
    _, _, fb_h, dct_h = tgemm.host_constants(CFG_T)
    *_, lo_h, hi_h = tgemm.kernel_constants(CFG_T)
    assert fb.dtype == dct.dtype == torch.float32 and fb_lo.dtype == fb_hi.dtype == torch.int32
    for got, want in ((fb, fb_h), (dct, dct_h), (fb_lo, lo_h), (fb_hi, hi_h)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert all(a is b for a, b in zip(tlfcc.banded_constants(CFG_T, cpu), (fb, fb_lo, fb_hi, dct)))
    # every nonzero weight lies inside its filter's band
    rows = np.arange(fb_h.shape[0])[:, None]
    assert not (fb_h[(rows < lo_h) | (rows > hi_h)] != 0).any()


def test_fixed_width_bands_reproduce_the_filterbank():
    """K4's kernel pads each filter to 5 bins from its first bin s = min(lo,
    257 - 5) (csrc/lfcc_kernel.cu, BAND) and fills its band table from fb,
    fb_lo and fb_hi: that table, put back on the bins, is the filterbank bit
    for bit, and every padded weight is an exact zero."""
    band = 5
    fb, fb_lo, fb_hi, _ = (t.numpy() for t in tlfcc.banded_constants(CFG_T, torch.device("cpu")))
    start = np.minimum(fb_lo, fb.shape[0] - band)
    bins = start[None, :] + np.arange(band)[:, None]  # (5, 120)
    inside = (bins >= fb_lo) & (bins <= fb_hi)
    table = np.where(inside, fb[bins, np.arange(fb.shape[1])], np.float32(0))
    assert (bins < fb.shape[0]).all() and (fb_hi - start < band).all()  # every band fits its window
    dense = np.zeros_like(fb)
    dense[bins, np.arange(fb.shape[1])] = table
    np.testing.assert_array_equal(dense, fb)
    assert (table[~inside] == 0).all() and not np.signbit(table[~inside]).any()


def test_check_kernel_cfg_names_the_other_fields():
    import dataclasses

    fields = ("n_fft", "n_filters", "n_ceps")
    tlfcc.check_kernel_cfg(CFG_T, fields, "post-FFT kernel")
    tlfcc.check_kernel_cfg(dataclasses.replace(CFG_T, hop_length=80), fields, "post-FFT kernel")
    with pytest.raises(ValueError, match=r"post-FFT kernel .*\['n_filters', 'n_ceps'\]"):
        tlfcc.check_kernel_cfg(dataclasses.replace(CFG_T, n_filters=64, n_ceps=20), fields, "post-FFT kernel")


@pytest.mark.parametrize("frames", [17, 33])
def test_lfcc_features_use_kernel_matches_jax_pallas(frames, monkeypatch):
    w = _waves(2, frames, seed=frames)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jlfcc.lfcc_features(jnp.asarray(w), CFG_J, use_pallas=True))
    calls = _spy(monkeypatch, tkernel, "fused_fb_log_dct")
    got = tlfcc.lfcc_features(torch.from_numpy(w), CFG_T, use_kernel=True).numpy()
    assert got.shape == want.shape == (2, 180, frames)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the switch routes the power spectrum through the wrapper, once; without
    # it the plain products run, to the same numbers
    assert len(calls) == 1 and tuple(calls[0][0][0].shape) == (2, frames, 257)
    plain = tlfcc.lfcc_features(torch.from_numpy(w), CFG_T).numpy()
    assert len(calls) == 1
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("method", ["gemm", "fft-pallas", "fft"])
def test_batch_driver_matches_jax(method, caplog):
    w = _waves(3, seed=2)  # batches of 2: a ragged last batch
    with pltpu.force_tpu_interpret_mode():
        want = jlfcc.lfcc_features_batch(w, CFG_J, batch_size=2, method=method)
    _no_jax_fallback(caplog)
    got = tlfcc.lfcc_features_batch(w, CFG_T, batch_size=2, method=method, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (3, 180, FRAMES)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("method,target", [
    ("fft-pallas", "dfac_tpu_torch.ops.lfcc_kernel.fused_fb_log_dct"),
    ("gemm", "dfac_tpu_torch.ops.gemm_frontend.gemm_lfcc_features"),
])
def test_batch_driver_does_not_fall_back(method, target, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(target, broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        tlfcc.lfcc_features_batch(_waves(3), CFG_T, batch_size=2, method=method, device="cpu")


def test_no_implicit_device_or_method(tmp_path):
    from dfac_tpu_torch.cli import extract_features as tcli

    with pytest.raises(ValueError, match="method"):
        tlfcc.lfcc_features_batch(_waves(1), CFG_T, method="dft", device="cpu")
    if torch.cuda.is_available():
        return
    np.savez(tmp_path / "a.npz", u0=_waves(1)[0])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlfcc.lfcc_features_batch(_waves(1), CFG_T)  # the default device is CUDA
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--audio", str(tmp_path / "a.npz"), "--out", str(tmp_path / "f.pkl")])


def _write_audio(kind, root, rng):
    """Three utterances, created out of uttid order, shorter than, equal to
    and longer than --frames needs; returns the audio argument."""
    lengths = {"c_utt": 2000, "a_utt": CFG_T.num_samples(FRAMES), "b_utt": 4100}
    waves = {u: (0.3 * rng.normal(size=n)).astype(np.float32) for u, n in lengths.items()}
    if kind == "npz":
        np.savez(root / "audio.npz", **waves)
        return str(root / "audio.npz")
    d = root / "audio"
    d.mkdir()
    (d / "notes.txt").write_text("not audio")
    for u, w in waves.items():
        if kind == "npy":
            np.save(d / f"{u}.npy", w)
        else:
            from scipy.io import wavfile

            wavfile.write(d / f"{u}.wav", CFG_T.sample_rate, (np.clip(w, -1, 1) * 32767).astype(np.int16))
    return str(d)


CLI_CASES = [
    ("npz", "gemm", "pkl", "torch"),
    ("npz", "gemm", "npy", "auto"),
    ("npy", "fft-pallas", "pkl", "numpy"),
    ("npy", "fft-pallas", "npy", "auto"),
    ("wav", "fft", "pkl", "auto"),
    ("wav", "--no-pallas", "npy", "auto"),
]


@pytest.mark.parametrize("kind,method,fmt,tensor_format", CLI_CASES)
def test_extract_cli_matches_jax(kind, method, fmt, tensor_format, tmp_path, capsys, caplog):
    from dfac_tpu.cli import extract_features as jcli
    from dfac_tpu_torch.cli import extract_features as tcli
    from dfac_tpu_torch.io.npy_store import load_npy_dataset

    audio = _write_audio(kind, tmp_path, np.random.default_rng(3))
    common = ["--audio", audio, "--frames", str(FRAMES), "--batch-size", "2", "--format", fmt,
              "--tensor-format", tensor_format]
    common += ["--no-pallas"] if method == "--no-pallas" else ["--method", method]
    suffix = "" if fmt == "npy" else ".pkl"
    j_out, t_out = str(tmp_path / f"jax{suffix}"), str(tmp_path / f"torch{suffix}")
    with pltpu.force_tpu_interpret_mode():
        jcli.main(common + ["--out", j_out])
    _no_jax_fallback(caplog)
    want_line = capsys.readouterr().out.splitlines()[0]
    tcli.main(common + ["--out", t_out, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == want_line.replace(j_out, t_out)
    assert lines[1].startswith("throughput: ") and " on cpu " in lines[1]

    def read(name):
        if fmt == "npy":
            ds = load_npy_dataset(str(tmp_path / name))
            return ds.uttids, np.asarray(ds.features), np.ndarray
        df = pd.read_pickle(tmp_path / f"{name}.pkl")
        kinds = {type(c) for c in df["features"]}
        assert len(kinds) == 1
        return df["uttid"].tolist(), np.stack([np.asarray(c) for c in df["features"]]), kinds.pop()

    (u_j, f_j, cell_j), (u_t, f_t, cell_t) = read("jax"), read("torch")
    assert u_t == u_j == ["a_utt", "b_utt", "c_utt"]
    assert cell_t is cell_j and cell_t is (np.ndarray if tensor_format == "numpy" or fmt == "npy" else torch.Tensor)
    assert f_t.dtype == np.float32 and f_t.shape == f_j.shape == (3, 180, FRAMES)
    np.testing.assert_allclose(f_t, f_j, atol=ATOL, rtol=RTOL)


def test_npy_store_opens_in_both_packages(tmp_path):
    from dfac_tpu.data.pipeline import ArrayDataset as JDataset
    from dfac_tpu.io import npy_store as jstore
    from dfac_tpu_torch.data.pipeline import ArrayDataset as TDataset
    from dfac_tpu_torch.io import npy_store as tstore

    rng = np.random.default_rng(4)
    n = 5
    feats = rng.normal(size=(n, 6, 7)).astype(np.float32)
    uttids = [f"u{i}" for i in range(n)]
    labels = (np.arange(n) % 2).astype(np.int32)
    lengths = np.array([7, 5, 7, 3, 6], np.int32)
    tstore.save_npy_dataset(TDataset(uttids, feats, labels, lengths), str(tmp_path / "t"))
    jstore.save_npy_dataset(JDataset(uttids, feats, labels, lengths), str(tmp_path / "j"))
    for name in (tstore.FEATURES, tstore.UTTIDS, tstore.LABELS, tstore.LENGTHS):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for writer in ("t", "j"):
        assert tstore.is_npy_store(str(tmp_path / writer)) and jstore.is_npy_store(str(tmp_path / writer))
        a = tstore.load_npy_dataset(str(tmp_path / writer))
        b = jstore.load_npy_dataset(str(tmp_path / writer))
        assert a.uttids == b.uttids == uttids
        assert isinstance(a.features, np.memmap) and not a.features.flags.writeable
        for x, y in ((a.features, b.features), (a.labels, b.labels), (a.lengths, b.lengths)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)

    # labels from a labels.pkl or from another store, inner-merged on uttid
    order = [3, 0, 4, 1, 2]
    pd.DataFrame({"uttid": [uttids[i] for i in order], "label": 1 - labels[order]}).to_pickle(tmp_path / "l.pkl")
    tstore.save_npy_dataset(TDataset([uttids[i] for i in order], feats[order], 1 - labels[order]), str(tmp_path / "l"))
    for lp in (tmp_path / "l.pkl", tmp_path / "l"):
        a = tstore.load_npy_dataset(str(tmp_path / "t"), labels_path=str(lp))
        b = jstore.load_npy_dataset(str(tmp_path / "t"), labels_path=str(lp))
        np.testing.assert_array_equal(a.labels, 1 - labels)
        np.testing.assert_array_equal(a.labels, b.labels)
    pd.DataFrame({"uttid": uttids[:3], "label": labels[:3]}).to_pickle(tmp_path / "short.pkl")
    with pytest.raises(ValueError, match="mismatch"):
        tstore.load_npy_dataset(str(tmp_path / "t"), labels_path=str(tmp_path / "short.pkl"))


def test_predict_reads_store_as_pickle(tmp_path):
    from dfac_tpu_torch.cli import predict as tpredict
    from dfac_tpu_torch.data.pipeline import ArrayDataset, load_dataset
    from dfac_tpu_torch.io.npy_store import save_npy_dataset
    from dfac_tpu_torch.io.pickle_io import write_features
    from dfac_tpu_torch.models import build_model

    f_dim, t_dim, n = 20, 33, 10  # 10 rows at batch 4: a padded tail
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(n, f_dim, t_dim)).astype(np.float32)
    uttids = [f"u{i:03d}" for i in range(n)]
    write_features(str(tmp_path / "features.pkl"), uttids, feats)
    save_npy_dataset(ArrayDataset(uttids=uttids, features=feats), str(tmp_path / "store"))
    from_store, from_pkl = load_dataset(str(tmp_path / "store")), load_dataset(str(tmp_path / "features.pkl"))
    assert isinstance(from_store.features, np.memmap)
    assert from_store.uttids == from_pkl.uttids == uttids
    np.testing.assert_array_equal(from_store.features, from_pkl.features)  # the scorer's inputs: exact
    torch.manual_seed(0)
    ckpt = str(tmp_path / "cnn2d.pt")
    torch.save(build_model("cnn2d", in_features=f_dim).state_dict(), ckpt)
    common = ["--checkpoint", ckpt, "--model", "cnn2d", "--fast", "--in-features", str(f_dim),
              "--batch-size", "4", "--device", "cpu"]
    tpredict.main(common + ["--features", str(tmp_path / "features.pkl"), "--out", str(tmp_path / "p_pkl.pkl")])
    tpredict.main(common + ["--features", str(tmp_path / "store"), "--out", str(tmp_path / "p_store.pkl")])
    want, got = pd.read_pickle(tmp_path / "p_pkl.pkl"), pd.read_pickle(tmp_path / "p_store.pkl")
    assert got["uttid"].tolist() == want["uttid"].tolist() == uttids
    # the same f32 chain on the same inputs; two CPU BLAS runs need not sum in
    # the same order, which moves a sigmoid score by f32 ulps (~6e-8 each)
    np.testing.assert_allclose(got["predictions"].to_numpy(), want["predictions"].to_numpy(), atol=1e-5, rtol=0)


def test_ingest_reads_a_store_batch_without_warning(tmp_path):
    """A store batch is a read-only view; ``ingest`` reads it without
    torch's not-writable warning. A fresh process, with every warning an
    error: pytest resets the filters a module installs at import."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import numpy as np, torch\n"
        "from dfac_tpu_torch.models.fast_infer import ingest\n"
        f"feats = np.load({str(tmp_path / 'f.npy')!r}, mmap_mode='r')\n"
        "assert not feats.flags.writeable\n"
        "t = ingest(feats[:2], torch.float32, torch.device('cpu'))\n"
        "assert torch.equal(t, torch.from_numpy(np.array(feats[:2])))\n"
    )
    np.save(tmp_path / "f.npy", np.arange(24, dtype=np.float32).reshape(3, 2, 4))
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-W", "error::UserWarning", "-c", code], check=True, env=env, cwd=root)
