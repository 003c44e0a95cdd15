"""Chunked streaming training in the PyTorch port (``dfac_tpu_torch.train.chunked``).

Mirrors ``tests/test_chunked.py`` at one device. On the CPU the chunk
feed hands each trainer the host loop's batches in the host loop's order
and its step draws from the same generator, so a chunked f32 epoch is the
host-fed epoch bit for bit (``torch.equal`` on every parameter and running
statistic), in all three trainers; bf16 ingest is the host-fed loop on
bf16-rounded features and int8 ingest the host-fed loop on the dequantized
features (``q.astype(f32) * scales[..., None]``, the JAX package's bits),
bit for bit. Against the JAX package: the host stage's chunks and the int8
dequantization bit for bit, the configurations' errors word for word. The
chunked fits of the three trainers from the JAX init run beside the JAX
fits of ``tests/test_torch_port_train.py``, ``..._cae_train.py`` and
``..._detector.py`` (losses rtol 1e-3, the dev EER equal; the JAX
package's chunked fits equal its host-fed ones up to XLA reassociation,
``tests/test_chunked.py``). The int8 and bf16 gates are
``tests/test_chunked.py``'s (dev EER within 0.001 of f32 chunked).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfac_tpu.io import fastcast as jfast
from dfac_tpu.train import cae_loop as jcae
from dfac_tpu.train import chunked as jchunked
from dfac_tpu.train import detector_loop as jdet
from dfac_tpu.train import loop as jloop
from dfac_tpu_torch.data import pipeline as tpipe
from dfac_tpu_torch.data.augment import AugmentConfig
from dfac_tpu_torch.train import cae_loop as tcae
from dfac_tpu_torch.train import chunked as tchunked
from dfac_tpu_torch.train import detector_loop as tdet
from dfac_tpu_torch.train import loop as tloop

F_, T_ = 16, 20
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These fits are tiny (16 x 20 features): one thread a process runs
    them fastest, alone or beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ds(mod, seed, n=26, f=F_, t=T_, shift=2.0, lengths=False):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % 2).astype(np.int32)
    feats = rng.normal(size=(n, f, t)).astype(np.float32)
    feats[labels == 1, : f // 2] += shift
    lens = None
    if lengths:
        lens = rng.integers(t // 2, t + 1, size=n).astype(np.int32)
        for i, ln in enumerate(lens):
            feats[i, :, ln:] = 0.0
    return mod.ArrayDataset([f"u{seed}_{i}" for i in range(n)], feats, labels, lengths=lens)


def _with_features(ds, feats):
    return dataclasses.replace(ds, features=np.ascontiguousarray(feats, np.float32))


def _assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _classifier(model="cnn2d", **kw):
    base = dict(model=model, batch_size=8, epochs=2, in_features=F_, dropout=0.3, lr=1e-3, seed=1,
                augment=AugmentConfig(spec_augment=True, gaussian_jitter=True))
    trainer = tloop.Trainer(tloop.TrainConfig(**{**base, **kw}), device="cpu")
    trainer.init_state(example_batch=np.zeros((1, F_, T_), np.float32))
    return trainer


def _cae(**kw):
    base = dict(batch_size=4, epochs=2, base_channels=4, lr=1e-3, seed=0, lr_scheduler_patience=0, early_stop=5)
    return tcae.CAETrainer(tcae.CAEConfig(**{**base, **kw}), device="cpu")


def _detector(**kw):
    base = dict(batch_size=8, epochs=2, hidden=8, dropout=0.3, encoder_dropout=0.2, ema=True, ema_decay=0.9,
                specaug=True, time_mask_max=4, freq_mask_max=4, seed=3, lr=1e-3)
    return tdet.DetectorTrainer(tdet.DetectorConfig(**{**base, **kw}), in_channels=F_, device="cpu")


# -- the host stage -------------------------------------------------------------------


def _as_np(a):
    """An array to compare bit for bit (bf16 as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind not in "iu" else a


@pytest.mark.parametrize("ingest", ["f32", "bf16", "int8"])
def test_host_chunks_equal_jax_bit_for_bit(ingest):
    """n = 26, B = 8, G = 2: a chunk of two batches, then one batch and the
    true-size tail of 2 (f32 in every mode), rows gathered alike."""
    ds = _ds(tpipe, 0)
    labels = ds.labels.astype(np.float32)
    order = tloop.epoch_order(len(ds), 7)
    got = list(tchunked.host_chunks(ds.features, (labels,), order, 8, 2, ingest=ingest))
    want = list(jchunked.host_chunks(ds.features, (labels,), order, 8, 2, ingest=ingest))
    assert [ci for ci, *_ in got] == [ci for ci, *_ in want] == [0, 1]
    assert got[0][2] is None and want[0][2] is None and got[1][2][0].shape == (2, F_, T_)
    for (_, gf, gt), (_, wf, wt) in zip(got, want):
        for g, w in zip((*gf, *gt) if gt else gf, (*wf, *wt) if wt else wf):
            g, w = _as_np(g), _as_np(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[0][1][0].shape[:2] == (2, 8) and got[1][1][0].shape[:2] == (1, 8)


@pytest.mark.parametrize("ingest", ["f32", "bf16", "int8"])
def test_staged_chunks_equal_host_chunks(ingest):
    """The card's host stage (rows gathered in parallel blocks straight into
    the ring's buffers, reused across chunks) writes host_chunks' arrays bit
    for bit; pageable buffers stand in for pinned ones on the CPU."""
    ds = _ds(tpipe, 3, n=600)  # 600 rows: chunks of 2 x 128 = 256 rows, parallel_gather's 256-row blocks
    rows = (ds.labels.astype(np.float32), np.arange(600, dtype=np.int32))
    order = tloop.epoch_order(600, 5)
    ring = tchunked.PinnedRing(slots=2, pin=False)
    want = list(tchunked.host_chunks(ds.features, rows, order, 128, 2, ingest=ingest))
    got = []
    for ci, k, views, n_full in tchunked.staged_chunks(ds.features, rows, order, 128, 2, ring, ingest=ingest):
        got.append((ci, [_as_np(v).copy() for v in views], n_full))
        ring.release_all()  # the upload's release
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1, 2]
    for (_, views, n_full), (_, full, tail) in zip(got, want):
        expect = [*(full or ()), *(tail or ())]
        assert n_full == len(full or ()) and len(views) == len(expect)
        for v, w in zip(views, expect):
            np.testing.assert_array_equal(v, _as_np(w))


def test_int8_dequantized_batches_are_the_jax_bits():
    ds = _ds(tpipe, 1, n=16)
    order = tloop.epoch_order(16, 3)
    chunks = tchunked.stream_chunks(ds.features, (), order, 8, 2, CPU, ingest="int8")
    got = [b[0].numpy() for b in tchunked.chunk_batches(chunks, "int8")]
    q, scales = jfast.quant_i8(ds.features[order])
    want = q.astype(np.float32) * scales[..., None]
    want_xla = np.asarray(jnp.asarray(q).astype(jnp.float32) * jnp.asarray(scales)[..., None])
    np.testing.assert_array_equal(np.concatenate(got), want)
    np.testing.assert_array_equal(want, want_xla)


# -- chunked == host-fed, bit for bit -----------------------------------------------------


@pytest.mark.parametrize("model,g", [("cnn2d", 2), ("cnn1d", 1), ("cnn2d", 5)])
def test_chunked_f32_epochs_equal_host_fed(model, g):
    """Dropout 0.3, SpecAugment and jitter: the generator's draws line up
    step for step. G = 5 holds the whole epoch (3 batches and the tail)."""
    ds = _ds(tpipe, 2)
    host, chunk = _classifier(model), _classifier(model, resident_chunk_batches=g)
    chunk.model.load_state_dict(host.model.state_dict())
    assert [host.train_epoch(ds, e) for e in (1, 2)] == [chunk.train_epoch(ds, e) for e in (1, 2)]
    _assert_same_state(host.model.state_dict(), chunk.model.state_dict())
    assert chunk.chunk_feed.stats.items == -(-4 // g)


def test_cae_chunked_fit_equals_host_fed():
    train, dev = _ds(tpipe, 6, n=30), _ds(tpipe, 7, n=16)
    host, chunk = _cae(), _cae(resident_chunk_batches=2)
    r_host, r_chunk = host.fit(train, dev), chunk.fit(train, dev)
    assert [(m.train_loss, m.dev_loss) for m in r_host["history"]] == [
        (m.train_loss, m.dev_loss) for m in r_chunk["history"]]
    _assert_same_state(host.model.state_dict(), chunk.model.state_dict())


def test_detector_chunked_fit_equals_host_fed():
    train, dev = _ds(tpipe, 8, lengths=True), _ds(tpipe, 9, n=16, lengths=True)
    host, chunk = _detector(), _detector(resident_chunk_batches=2)
    assert host.fit(train, dev) == chunk.fit(train, dev)
    _assert_same_state(host.eval_variables(), chunk.eval_variables())
    _assert_same_state(host.model.state_dict(), chunk.model.state_dict())


def _compressed(feats, ingest):
    if ingest == "bf16":
        return torch.from_numpy(feats).to(torch.bfloat16).float().numpy()
    q, scales = jfast.quant_i8(feats)  # per row: a corpus-wide quantization is each chunk's
    return q.astype(np.float32) * scales[..., None]


@pytest.mark.parametrize("ingest", ["bf16", "int8"])
@pytest.mark.parametrize("trainer", ["cnn2d", "cae", "detector"])
def test_compressed_ingest_equals_host_fed_on_its_features(ingest, trainer):
    """n = 32 at B = 8 (16 bonafide rows for the CAE): no tail batch (the
    tail goes up in f32)."""
    ds = _ds(tpipe, 10, n=32, lengths=trainer == "detector")
    fed = _with_features(ds, _compressed(ds.features, ingest))
    if trainer == "cnn2d":
        host, chunk = _classifier(), _classifier(resident_chunk_batches=2, chunk_ingest=ingest)
        chunk.model.load_state_dict(host.model.state_dict())
        assert [host.train_epoch(fed, e) for e in (1, 2)] == [chunk.train_epoch(ds, e) for e in (1, 2)]
    elif trainer == "cae":
        host, chunk = _cae(batch_size=8), _cae(batch_size=8, resident_chunk_batches=2, chunk_ingest=ingest)
        norm = tcae.build_normalizer(ds.features, ds.labels)
        r_host = host.fit(fed, ds, normalizer=norm)
        r_chunk = chunk.fit(ds, ds, normalizer=norm)
        assert [m.train_loss for m in r_host["history"]] == [m.train_loss for m in r_chunk["history"]]
    else:
        host, chunk = _detector(), _detector(resident_chunk_batches=2, chunk_ingest=ingest)
        r_host, r_chunk = host.fit(fed, ds), chunk.fit(ds, ds)
        assert [h["train_loss"] for h in r_host["history"]] == [h["train_loss"] for h in r_chunk["history"]]
    _assert_same_state(host.model.state_dict(), chunk.model.state_dict())


def test_chunked_streams_from_npy_store(tmp_path):
    from dfac_tpu_torch.io.npy_store import save_npy_dataset

    full = _ds(tpipe, 4, n=40)
    save_npy_dataset(full, str(tmp_path / "store"))
    ds = tpipe.load_dataset(str(tmp_path / "store"))
    assert isinstance(ds.features, np.memmap)  # the features stay on disk
    labeled = dataclasses.replace(ds, labels=full.labels)
    from_store, in_memory = _classifier("cnn1d", resident_chunk_batches=2), _classifier("cnn1d", resident_chunk_batches=2)
    assert from_store.train_epoch(labeled, 1) == in_memory.train_epoch(full, 1)
    assert np.isfinite(from_store.train_epoch(labeled, 2))
    _ = in_memory.train_epoch(full, 2)
    _assert_same_state(from_store.model.state_dict(), in_memory.model.state_dict())


def test_chunked_with_augmentation_counts_every_row():
    ds = _ds(tpipe, 2)
    trainer = _classifier("cnn1d", resident_chunk_batches=3)
    seen = []
    step = trainer.train_step
    trainer.train_step = lambda f, l, w, frozen=False: (seen.append(len(f)), step(f, l, w, frozen))[1]
    assert np.isfinite(trainer.train_epoch(ds, 1))
    assert seen == [8, 8, 8, 2] and trainer.chunk_feed.stats.items == 2


def test_cae_chunked_second_fit_uses_the_new_normalizer():
    """The chunked epoch reads the trainer's current normalizer: a second
    fit on another corpus trains with that corpus's statistics."""
    ds_a, dev = _ds(tpipe, 20, n=24), _ds(tpipe, 21, n=16)
    ds_b = _ds(tpipe, 22, n=24)
    ds_b = _with_features(ds_b, ds_b.features * 5.0 + 3.0)
    reused = _cae(epochs=1, batch_size=8, resident_chunk_batches=2)
    reused.fit(ds_a, dev)
    mean_a = reused.normalizer.mean.copy()
    reused.fit(ds_b, dev)
    fresh = _cae(epochs=1, batch_size=8, resident_chunk_batches=2)
    fresh.fit(ds_b, dev)
    np.testing.assert_array_equal(reused.normalizer.mean, fresh.normalizer.mean)
    np.testing.assert_array_equal(reused.normalizer.std, fresh.normalizer.std)
    assert not np.allclose(mean_a, reused.normalizer.mean)
    # the second fit from fresh weights is the fresh fit, bit for bit
    again = _cae(epochs=1, batch_size=8, resident_chunk_batches=2)
    again.fit(ds_a, dev)
    again.init_state()
    r = again.fit(ds_b, dev)
    assert r["history"][-1].train_loss == fresh.history[-1].train_loss  # history holds both fits' epochs


def test_host_bound_epoch_warns_once(monkeypatch, caplog):
    """A gather slowed to 0.2 s a chunk: the device waits on the host, and
    the JAX package's warning is logged once per trainer."""
    import time

    from dfac_tpu_torch.io import fastcast

    real = fastcast.gather_f32
    monkeypatch.setattr(fastcast, "gather_f32", lambda src, idx, threads=None: (time.sleep(0.2), real(src, idx))[1])
    trainer = _classifier("cnn1d", resident_chunk_batches=1, dropout=0.0, augment=AugmentConfig())
    trainer.train_step = lambda f, l, w, frozen=False: (torch.zeros(()), w.sum())  # a step that waits on nothing
    with caplog.at_level(logging.WARNING):
        trainer.train_epoch(_ds(tpipe, 3), 1)
        trainer.train_epoch(_ds(tpipe, 3), 2)
    warned = [r for r in caplog.records if "chunked training is ingest-bound" in r.message]
    assert len(warned) == 1 and trainer.chunk_feed.stats.host_bound()


# -- quality gates ---------------------------------------------------------------------


def test_int8_ingest_preserves_eer():
    """tests/test_chunked.py's gate: the int8-ingest fit's dev EER within
    0.1% absolute of the f32 chunked fit's."""
    train, dev = _ds(tpipe, 4, n=48), _ds(tpipe, 5, n=32)
    cfg = dict(dropout=0.0, lr=2e-3, augment=AugmentConfig(), resident_chunk_batches=2)
    f32, q8 = _classifier(**cfg), _classifier(**cfg, chunk_ingest="int8")
    q8.model.load_state_dict(f32.model.state_dict())
    r_f32, r_q8 = f32.fit(train, dev), q8.fit(train, dev)
    assert np.isfinite(r_q8["history"][0].train_loss)
    assert abs(r_q8["best_eer"] - r_f32["best_eer"]) <= 0.001


def test_bf16_ingest_tracks_f32():
    train, dev = _ds(tpipe, 0), _ds(tpipe, 1, n=16)
    cfg = dict(dropout=0.0, lr=1e-4, augment=AugmentConfig(), resident_chunk_batches=2)
    f32, bf16 = _classifier("cnn1d", **cfg), _classifier("cnn1d", **cfg, chunk_ingest="bf16")
    bf16.model.load_state_dict(f32.model.state_dict())
    r_f32, r_bf16 = f32.fit(train, dev), bf16.fit(train, dev)
    for a, b in zip(r_f32["history"], r_bf16["history"]):
        assert b.train_loss == pytest.approx(a.train_loss, rel=5e-3)
    assert abs(r_bf16["best_eer"] - r_f32["best_eer"]) <= 0.001


# -- configuration -----------------------------------------------------------------------

INVALID = [
    dict(resident_chunk_batches=2, device_resident=True),
    dict(resident_chunk_batches=-1),
    dict(chunk_ingest="fp8", resident_chunk_batches=2),
    dict(chunk_ingest="int8"),
    dict(bn_freeze_after_frac=1.5),
]
CONFIGS = {"train": (jloop.TrainConfig, tloop.TrainConfig), "cae": (jcae.CAEConfig, tcae.CAEConfig),
           "detector": (jdet.DetectorConfig, tdet.DetectorConfig)}


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("which", list(CONFIGS))
def test_config_validation_raises_the_jax_message(which, kw):
    jcfg, tcfg = CONFIGS[which]
    with pytest.raises(ValueError) as want:
        jcfg(**kw)
    with pytest.raises(ValueError) as got:
        tcfg(**kw)
    assert str(got.value) == str(want.value)
