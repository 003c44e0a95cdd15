"""Multi-host execution and sharded serving in the PyTorch port, on the CPU.

* **helpers** (:mod:`dfac_tpu_torch.parallel.multihost`): the row ranges
  and the backend rule in process; the rendezvous, ``gather_rows`` and
  ``broadcast_pyobj`` on two processes;
* **sharded scorers** (:mod:`dfac_tpu_torch.parallel.serving`): each runs
  on one module-scoped two-rank gloo
  :class:`~dfac_tpu_torch.parallel.data_parallel.RankPool` (the ``_rank_*``
  functions below import torch and the port only; the ranks import this
  module by name) and is held to its JAX counterpart ``shard_map``ped over
  the 8 virtual CPU devices of ``tests/conftest.py``, and to the port's
  single-device chain on the whole batch (within an ulp or two: a row's
  score depends on that row alone, but the CPU's convolutions block their
  work by batch size);
* **serving CLIs**: ``predict --data-parallel 2`` (``--fast`` and not) and
  ``predict_hybrid --fast --data-parallel 2`` against the JAX CLIs run in
  this process; two ``--multihost`` processes of each against the
  single-process files (within :data:`SINGLE_ATOL`) (``predict``'s with two ranks a process, so four in
  all, as a host with two cards runs them), only process 0 writing;
* **training CLIs**: two ``train --multihost`` processes, host-fed, chunked,
  ``--fused-fit`` (resident) and resumed from the coordinator's file,
  against the port's ``--data-parallel 2`` fit on the same data (the same
  ranks, rows and draws; ``tests/test_torch_port_dp.py`` holds that fit to
  JAX's), only process 0 writing.

The CLI processes of a fixture start together, with one intra-op thread
each, at a free port, under a ``communicate`` timeout that kills them all.

Tolerances: ``tests/test_parallel.py``'s where the two packages compute
alike, f32 scores atol 1e-5 (waveforms through two rFFT compositions:
``tests/test_torch_port_slice.py``), the q8 and feature chains atol 1e-6,
the hybrid legs rtol 2e-5 + atol 1e-6; bf16 chains the JAX package's bf16
bound, atol 2e-2 (``tests/test_fast_infer.py``); the fits rel 1e-6.
"""

import os
import pickle
import signal
import subprocess
import sys
from functools import partial

import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu_torch.features.lfcc import LFCCConfig as TConfig
from dfac_tpu_torch.models import build_model as tbuild
from dfac_tpu_torch.models import fast_infer as tfast
from dfac_tpu_torch.parallel import data_parallel as dp
from dfac_tpu_torch.parallel import multihost as mh
from dfac_tpu_torch.parallel import serving as sv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TASK_TIMEOUT_S = 120.0
CLI_TIMEOUT_S = 240
FRAMES, BC, B_ = 17, 4, 16  # the waveform scorers (tests/test_parallel.py:176-264)
F_, T_ = 20, 33  # the feature scorers (tests/test_parallel.py:534)
HF, HT = 36, 33  # the hybrid scorer (tests/test_parallel.py:419)
CF, CT, N_CLI = 20, 37, 11  # the serving CLIs' corpus: 11 utterances at B=4, a padded tail
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a sharded scorer against the port's single-device chain on the whole batch: a row's score depends on that row
# alone, but the CPU's convolutions block their work by batch size, so a sum may part by an ulp
SINGLE_ATOL = 1e-6


@pytest.fixture(scope="module")
def pool():
    with dp.RankPool(["cpu"] * WORLD, backend="gloo", timeout_s=TASK_TIMEOUT_S, threads=1) as p:
        yield p


def _run(pool, fn, *args) -> list:
    return pool.run(fn, *args, timeout_s=TASK_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh():
    import jax

    from dfac_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=8, devices=jax.devices()[:8])


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _start_all(commands: dict) -> dict:
    """Start every command at once, each in a session of its own (so that
    :func:`_finish_all` can end it with the rank processes it spawned)."""
    return {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                env=_env(), start_new_session=True) for k, cmd in commands.items()}


def _finish_all(procs: dict) -> dict:
    """``{name: (rc, stdout, stderr)}`` of :func:`_start_all`'s processes;
    on a timeout every session is killed, children included."""
    out = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=CLI_TIMEOUT_S)
            out[k] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)  # the session's leftovers: a rank a failed parent left behind
            except ProcessLookupError:
                pass
            p.wait(10)
    return out


def _run_all(commands: dict) -> dict:
    return _finish_all(_start_all(commands))


def _ok(runs: dict, name: str) -> str:
    rc, stdout, stderr = runs[name]
    assert rc == 0, f"{name}: {stderr[-3000:]}"
    return stdout


def _cluster(n: int, *, local: int = 1) -> list[list[str]]:
    """The ``--multihost`` flags of ``n`` processes meeting at a free port;
    with ``local`` > 1 each process runs that many CPU ranks (as a host with
    ``local`` cards), through a wrapper that sets ``multihost.local_devices``."""
    port = dp.free_port()
    flags = [["--multihost", "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", str(n),
              "--process-id", str(i)] for i in range(n)]
    return flags if local == 1 else [[f"--local-ranks={local}", *f] for f in flags]


def _cli(module: str, *argv: str) -> list[str]:
    """A CLI command line; a ``--local-ranks=K`` first argument runs it with ``K`` CPU ranks a process."""
    if argv and argv[0].startswith("--local-ranks="):
        k = int(argv[0].split("=")[1])
        code = ("import importlib, sys; from dfac_tpu_torch.parallel import multihost as mh; "
                f"mh.local_devices = lambda device: ['cpu'] * {k}; "
                f"importlib.import_module({module!r}).main(sys.argv[1:])")
        return [sys.executable, "-c", code, *argv[1:]]
    return [sys.executable, "-m", module, *argv]


# -- helpers -------------------------------------------------------------------------------------------

@pytest.mark.parametrize("world, rank, n_ranks, n_rows, want", [
    (2, 0, 1, 8, (0, 4)), (2, 1, 1, 8, (4, 8)), (4, 2, 2, 16, (8, 16)), (1, 0, 1, 5, (0, 5)),
])
def test_local_row_range(world, rank, n_ranks, n_rows, want):
    assert mh.local_row_range(world, rank, n_rows, n_ranks) == want


def test_local_row_range_refusals():
    with pytest.raises(ValueError, match="batch_size must divide over the mesh data axis"):
        mh.local_row_range(2, 0, 7)
    with pytest.raises(ValueError, match="in multihost mode the mesh must span every host's chips"):
        mh.local_row_range(2, 2, 8)


@pytest.mark.parametrize("identities, want", [
    (["h/a", "h/b"], "nccl"), (["h/a", "h/a"], "gloo"), (["cpu", "cpu"], "gloo"), (["h/a", "cpu"], "gloo"),
    (["h/a"], "nccl"),
])
def test_backend_rule(identities, want):
    """NCCL where every rank has a card of its own (two processes on one card share its UUID), else gloo."""
    assert mh.backend_for(identities) == want


@pytest.mark.parametrize("missing", ["--coordinator-address", "--num-processes", "--process-id"])
def test_initialize_names_the_three_flags(missing):
    flags = {"--coordinator-address": "127.0.0.1:1", "--num-processes": 2, "--process-id": 0}
    flags[missing] = None
    with pytest.raises(SystemExit, match="--coordinator-address HOST:PORT .* --num-processes N and --process-id I"):
        mh.initialize(*flags.values(), device="cpu")


def _configs(package: str, **kw):
    """Each trainer's config class of ``package`` ('dfac_tpu' or 'dfac_tpu_torch'), built with ``kw``."""
    import importlib

    mods = ("loop", "cae_loop", "detector_loop")
    names = ("TrainConfig", "CAEConfig", "DetectorConfig")
    return {n: partial(getattr(importlib.import_module(f"{package}.train.{m}"), n), **kw) for m, n in zip(mods, names)}


@pytest.mark.parametrize("name", ["TrainConfig", "CAEConfig", "DetectorConfig"])
def test_multihost_configs_refuse_one_rank_with_the_jax_message(name):
    """``multihost`` with ``data_parallel`` ≤ 1: each config's ``ValueError``, word for word the JAX config's."""
    with pytest.raises(ValueError) as want:
        _configs("dfac_tpu", multihost=True, data_parallel=1, batch_size=8)[name]()
    with pytest.raises(ValueError) as got:
        _configs("dfac_tpu_torch", multihost=True, data_parallel=1, batch_size=8)[name]()
    assert str(got.value) == str(want.value) and "GLOBAL device count" in str(got.value)
    _configs("dfac_tpu_torch", multihost=True, data_parallel=2, batch_size=8)[name]()


@pytest.mark.parametrize("trainer, config", [("Trainer", "TrainConfig"), ("CAETrainer", "CAEConfig"),
                                             ("DetectorTrainer", "DetectorConfig")])
def test_fused_fit_refusals(trainer, config):
    """A fused fit of a multi-host trainer needs ``device_resident`` (the
    CLIs' ``--fused-fit`` sets it); a single-process data-parallel one stays
    refused; each with the JAX trainer's message."""
    from dfac_tpu_torch.train.fused_fit import check_fused

    def fake(**kw):  # the state check_fused reads: the config and the ranks, under the trainer's class name
        t = type(trainer, (), {})()
        t.cfg, t.ranks = _configs("dfac_tpu_torch", data_parallel=2, batch_size=8, **kw)[config](), object()
        return t

    with pytest.raises(ValueError, match=r"^multihost fused .*fit requires device_resident=True"):
        check_fused(fake(multihost=True))
    with pytest.raises(ValueError, match=r"^fit_fused with data_parallel is the MULTIHOST GSPMD path"):
        check_fused(fake(device_resident=True))
    check_fused(fake(multihost=True, device_resident=True))


HELPER = """
import json, sys, torch
from dfac_tpu_torch.parallel import multihost as mh
from dfac_tpu_torch.parallel.data_parallel import Ranks
c = mh.initialize(sys.argv[1], 2, int(sys.argv[2]), "cpu")
r = Ranks.of()
lo, hi = mh.local_row_range(r.world, r.rank, 8)
x = torch.arange(lo, hi, dtype=torch.float32).repeat(3) + 100 * torch.arange(3).repeat_interleave(hi - lo)
out = {"world": c.world, "backend": c.backend, "coordinator": c.is_coordinator, "rows": [lo, hi],
       "gathered": mh.gather_rows(x, r, rows=hi - lo).tolist(),
       "broadcast": mh.broadcast_pyobj({"from": r.rank} if r.rank == 0 else "ignored")}
mh.sync()
c.close()
print(json.dumps(out))
"""


def test_helpers_on_two_processes():
    """Two CPU processes meet at a free port: gloo, world 2; each holds its
    rows of a global batch of 8, ``gather_rows`` gives every process three
    batches' rows in corpus order, ``broadcast_pyobj`` the coordinator's
    value."""
    import json

    port = dp.free_port()
    runs = _run_all({i: [sys.executable, "-c", HELPER, f"127.0.0.1:{port}", str(i)] for i in range(2)})
    outs = [json.loads(_ok(runs, i).splitlines()[-1]) for i in range(2)]
    want = [float(100 * b + r) for b in range(3) for r in range(8)]
    for i, o in enumerate(outs):
        assert (o["world"], o["backend"], o["coordinator"]) == (2, "gloo", i == 0)
        assert o["rows"] == [4 * i, 4 * i + 4]
        assert o["gathered"] == want
        assert o["broadcast"] == {"from": 0}


# -- sharded scorers ---------------------------------------------------------------------------------------

def _torch_sd(weights: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()}


def _cnn2d_variables(in_features, frames, base, seed):
    """A JAX CNN2D init with non-trivial BatchNorm statistics (as after training), and its port state_dict (numpy)."""
    import jax
    import jax.numpy as jnp

    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu_torch.utils.convert import state_dict_from_jax

    model = jbuild("cnn2d", in_features=in_features, base_channels=base)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)({"params": jax.random.key(seed)},
                                                             jnp.zeros((1, frames, in_features))))
    rng = np.random.default_rng(seed)
    for stats in variables["batch_stats"].values():
        stats["mean"] = rng.uniform(-0.2, 0.2, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    return model, variables, {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def _rank_waves(kind: str, weights: dict, waves: np.ndarray, corpus: np.ndarray, dtype_name: str):
    """This rank's part of the waveform scorers ``kind`` ('fast' or 'e2e'),
    per batch and over the corpus, gathered: ``(batch scores, corpus scores)``."""
    ranks = dp.Ranks.of()
    cfg = TConfig()
    if kind == "fast":
        dt = getattr(torch, dtype_name)
        folded = tfast.fold_cnn2d(_torch_sd(weights))
        batch = partial(sv.make_sharded_fast_scorer(cfg, "fft", compute_dtype=dt), folded)
        whole = partial(sv.make_sharded_fast_corpus_scorer(cfg, "fft", compute_dtype=dt), folded)
    else:
        model = tbuild("cnn2d", base_channels=BC)
        model.load_state_dict(_torch_sd(weights))
        batch, whole = sv.make_sharded_e2e_scorer(model, cfg, "fft"), sv.make_sharded_corpus_scorer(model, cfg, "fft")
    got = mh.gather_rows(batch(torch.from_numpy(sv.rank_rows(waves, ranks))), ranks)
    rows = corpus.shape[1] // ranks.world
    got_corpus = mh.gather_rows(whole(torch.from_numpy(sv.rank_rows(corpus, ranks, axis=1))), ranks, rows=rows)
    return got, got_corpus


@pytest.fixture(scope="module")
def wave_inputs():
    """CNN2D at in_features 180, base 4 (JAX's init) and waveforms of 17 frames: one batch of 16, a corpus of 3."""
    model, variables, weights = _cnn2d_variables(180, FRAMES, BC, 0)
    rng = np.random.default_rng(1)
    n = TConfig().num_samples(FRAMES)
    return (model, variables, weights, rng.normal(size=(B_, n)).astype(np.float32),
            rng.normal(size=(3, B_, n)).astype(np.float32))


@pytest.mark.parametrize("kind, dtype", [("fast", "float32"), ("fast", "bfloat16"), ("e2e", "float32")])
def test_sharded_waveform_scorers_match_jax(pool, mesh, wave_inputs, kind, dtype):
    """The fast scorer (folded chain) and the e2e scorer (the eval model),
    each per batch and in its corpus form, on two ranks: the port's
    single-device chain on the whole batch, and JAX's scorers over 8
    devices within the dtype's tolerance."""
    import jax.numpy as jnp

    from dfac_tpu.features.lfcc import LFCCConfig as JConfig
    from dfac_tpu.models.fast_infer import fold_cnn2d as jfold
    from dfac_tpu.parallel import serving as jsv

    model, variables, weights, waves, corpus = wave_inputs
    flat = corpus.reshape(-1, corpus.shape[-1])
    if kind == "fast":
        jdt = getattr(jnp, dtype)
        folded = jfold(variables)
        want = jsv.make_sharded_fast_scorer(mesh, JConfig(), "fft", compute_dtype=jdt)(folded, waves)
        want_c = jsv.make_sharded_fast_corpus_scorer(mesh, JConfig(), "fft", compute_dtype=jdt)(folded, corpus)
        single = sv.make_sharded_fast_scorer(TConfig(), "fft", compute_dtype=getattr(torch, dtype))
        tfolded = tfast.fold_cnn2d(_torch_sd(weights))
        ref, ref_c = (single(tfolded, torch.from_numpy(x)).numpy() for x in (waves, flat))
    else:
        want = jsv.make_sharded_e2e_scorer(model, mesh, JConfig(), "fft")(variables, waves)
        want_c = jsv.make_sharded_corpus_scorer(model, mesh, JConfig(), "fft")(variables, corpus)
        tmodel = tbuild("cnn2d", base_channels=BC)
        tmodel.load_state_dict(_torch_sd(weights))
        single = sv.make_sharded_e2e_scorer(tmodel, TConfig(), "fft")
        ref, ref_c = (single(torch.from_numpy(x)).numpy() for x in (waves, flat))
    for got, got_c in _run(pool, _rank_waves, kind, weights, waves, corpus, dtype):
        assert got.shape == (B_,) and got_c.shape == (3 * B_,)
        np.testing.assert_allclose(got, ref, atol=SINGLE_ATOL)
        np.testing.assert_allclose(got_c, ref_c, atol=SINGLE_ATOL)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL[dtype])
        np.testing.assert_allclose(got_c, np.asarray(want_c), atol=TOL[dtype])


def _rank_features(weights: dict, feats: np.ndarray, dtype_name: str, q8: bool):
    """This rank's part of the feature scorer (``q8``: on ``quant_i8``'s rows and scales), gathered."""
    from dfac_tpu_torch.io.fastcast import quant_i8

    ranks = dp.Ranks.of()
    folded = tfast.fold_cnn2d(_torch_sd(weights))
    scorer = sv.make_sharded_cnn2d_feature_scorer(compute_dtype=getattr(torch, dtype_name), ingest_int8=q8)
    local = sv.rank_rows(feats, ranks)
    out = scorer(folded, *quant_i8(local)) if q8 else scorer(folded, torch.from_numpy(local))
    return mh.gather_rows(out, ranks)


@pytest.mark.parametrize("dtype, q8", [("float32", False), ("bfloat16", False), ("float32", True)],
                         ids=["f32", "bf16", "q8"])
def test_sharded_feature_scorer_matches_jax(pool, mesh, dtype, q8):
    """``predict --fast --data-parallel``'s chain (K2 on the card), f32,
    bf16 and with int8 ingest (each rank quantizes its own rows), against
    JAX's sharded scorer and the port's single-device chain."""
    import jax
    import jax.numpy as jnp

    from dfac_tpu.io.fastcast import quant_i8 as jquant
    from dfac_tpu.models.fast_infer import fold_cnn2d as jfold
    from dfac_tpu.parallel.mesh import batch_sharding
    from dfac_tpu.parallel.serving import make_sharded_cnn2d_feature_scorer as jscorer
    from dfac_tpu_torch.io.fastcast import quant_i8

    _, variables, weights = _cnn2d_variables(F_, T_, BC, 2)
    feats = np.random.default_rng(3).normal(size=(B_, F_, T_)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scorer = jscorer(mesh, compute_dtype=jdt, ingest_int8=q8)
    single = sv.make_sharded_cnn2d_feature_scorer(compute_dtype=tdt, ingest_int8=q8)
    tfolded = tfast.fold_cnn2d(_torch_sd(weights))
    if q8:
        sb = batch_sharding(mesh)
        want = scorer(jfold(variables), *(jax.device_put(a, sb) for a in jquant(feats)))
        ref = single(tfolded, *quant_i8(feats)).numpy()
    else:
        want = scorer(jfold(variables), jnp.asarray(feats))
        ref = single(tfolded, torch.from_numpy(feats)).numpy()
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    for got in _run(pool, _rank_features, weights, feats, dtype, q8):
        np.testing.assert_allclose(got, ref, atol=SINGLE_ATOL)
        np.testing.assert_allclose(got, np.asarray(want), atol=tol)


def _rank_hybrid(model: str, sup: dict, cae: dict, mean: np.ndarray, std: np.ndarray, feats: np.ndarray):
    """This rank's part of the hybrid scorer (f32), both legs gathered."""
    ranks = dp.Ranks.of()
    fold = tfast.fold_cnn2d if model == "cnn2d" else tfast.fold_cnn1d
    scorer = sv.make_sharded_hybrid_scorer(compute_dtype=torch.float32, model=model)
    legs = scorer(fold(_torch_sd(sup)), tfast.fold_cae(_torch_sd(cae)), torch.from_numpy(mean),
                  torch.from_numpy(std), torch.from_numpy(sv.rank_rows(feats, ranks)))
    return tuple(mh.gather_rows(leg, ranks) for leg in legs)


@pytest.mark.parametrize("model", ["cnn2d", "cnn1d"])
def test_sharded_hybrid_scorer_matches_jax(pool, mesh, model):
    """Both submission legs (the folded supervised chain, CNN2D or CNN1D,
    and the CAE's MSE) on two ranks, f32, against JAX's hybrid scorer
    (``tests/test_parallel.py:412-493``'s geometry) and the port's
    single-device legs."""
    import jax
    import jax.numpy as jnp

    from dfac_tpu.models import build_model as jbuild
    from dfac_tpu.models import fast_infer as jfast
    from dfac_tpu.parallel.serving import make_sharded_hybrid_scorer as jscorer
    from dfac_tpu_torch.utils.convert import state_dict_from_jax

    rng = np.random.default_rng(4)
    kw = {"in_features": HF, "base_channels": 8} if model == "cnn2d" else {"in_channels": HF}
    # jitted inits: the CAE's eager init alone takes ~13 s
    sup_vars = jax.jit(jbuild(model, **kw).init)({"params": jax.random.key(0)}, jnp.zeros((1, HT, HF)))
    cae_vars = jax.jit(jbuild("cae", base_channels=4).init)({"params": jax.random.key(1)}, jnp.zeros((1, HF, HT)))
    sup_vars, cae_vars = (jax.tree.map(np.asarray, v) for v in (sup_vars, cae_vars))
    for variables in (sup_vars, cae_vars):
        for d in variables["batch_stats"].values():
            d["mean"] = (rng.normal(size=d["mean"].shape) * 0.2).astype(np.float32)
            d["var"] = (rng.random(d["var"].shape) + 0.5).astype(np.float32)
    mean = rng.normal(size=(HF,)).astype(np.float32)
    std = (rng.random(HF) + 0.5).astype(np.float32)
    feats = rng.normal(size=(B_, HF, HT)).astype(np.float32)
    jfold = jfast.fold_cnn2d if model == "cnn2d" else jfast.fold_cnn1d
    want = jscorer(mesh, compute_dtype=jnp.float32, model=model)(jfold(sup_vars), jfast.fold_cae(cae_vars),
                                                                   jnp.asarray(mean), jnp.asarray(std),
                                                                   jnp.asarray(feats))
    sup, cae = ({k: v.numpy() for k, v in state_dict_from_jax(v, name).items()}
                for v, name in ((sup_vars, model), (cae_vars, "cae")))
    tfold = tfast.fold_cnn2d if model == "cnn2d" else tfast.fold_cnn1d
    ref = sv.make_sharded_hybrid_scorer(compute_dtype=torch.float32, model=model)(
        tfold(_torch_sd(sup)), tfast.fold_cae(_torch_sd(cae)), torch.from_numpy(mean), torch.from_numpy(std),
        torch.from_numpy(feats))
    for got in _run(pool, _rank_hybrid, model, sup, cae, mean, std, feats):
        for g, r, w in zip(got, ref, want):
            np.testing.assert_allclose(g, r.numpy(), rtol=2e-5, atol=SINGLE_ATOL)
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no folded hybrid scorer"):
        sv.make_sharded_hybrid_scorer(model="crnn")


# -- serving CLIs ----------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """A CNN2D, a CAE and a normalizer (JAX checkpoints of numpy-drawn
    weights) and an 11-utterance corpus; then the port's serving CLIs, all
    started at once: ``predict`` (``--fast`` and not) and ``predict_hybrid
    --fast`` with ``--data-parallel 2``, and two ``--multihost`` processes
    of ``predict --fast`` (two ranks each) and of ``predict_hybrid --fast``."""
    from test_torch_port_cae import numpy_weights

    from dfac_tpu.data.normalizer import FeatureNormalizer as JNormalizer
    from dfac_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
    from dfac_tpu_torch.utils.convert import jax_from_state_dict

    root = tmp_path_factory.mktemp("mh_serving")
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(N_CLI, CF, CT)).astype(np.float32)
    ids = [f"utt{i:02d}" for i in range(N_CLI)]
    pd.DataFrame({"uttid": ids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(root / "f.pkl")
    paths = {"features": str(root / "f.pkl"), "root": root}
    for i, (name, kw) in enumerate((("cnn2d", {"in_features": CF}),  # the JAX predict CLI builds base 32
                                    ("cae", {"base_channels": 4}))):
        paths[name] = str(root / f"{name}.ckpt")
        jsave_checkpoint(paths[name], jax_from_state_dict(numpy_weights(tbuild(name, **kw).state_dict(), 20 + i),
                                                          name))
    JNormalizer().fit(np.transpose(feats, (0, 2, 1))).save(str(root / "norm.npz"))
    paths["normalizer"] = str(root / "norm.npz")
    predict = ["--features", paths["features"], "--checkpoint", paths["cnn2d"], "--model", "cnn2d",
               "--in-features", str(CF), "--batch-size", "4", "--device", "cpu"]
    hybrid = ["--features", paths["features"], "--cnn-checkpoint", paths["cnn2d"], "--cae-checkpoint", paths["cae"],
              "--normalizer", paths["normalizer"], "--batch-size", "4", "--in-features", str(CF),
              "--base-channels", "4", "--device", "cpu", "--fast"]
    commands = {
        "predict_dp_fast": _cli("dfac_tpu_torch.cli.predict", *predict, "--fast", "--data-parallel", "2",
                                "--out", str(root / "predict_dp_fast.pkl")),
        "predict_dp": _cli("dfac_tpu_torch.cli.predict", *predict, "--data-parallel", "2",
                           "--out", str(root / "predict_dp.pkl")),
        "hybrid_dp": _cli("dfac_tpu_torch.cli.predict_hybrid", *hybrid, "--data-parallel", "2",
                          "--out", str(root / "hybrid_dp.pkl")),
    }
    for i, flags in enumerate(_cluster(2, local=2)):
        commands[f"predict_mh{i}"] = _cli("dfac_tpu_torch.cli.predict", *flags, *predict, "--fast",
                                          "--out", str(root / f"predict_mh{i}.pkl"))
    for i, flags in enumerate(_cluster(2)):
        commands[f"hybrid_mh{i}"] = _cli("dfac_tpu_torch.cli.predict_hybrid", *flags, *hybrid,
                                         "--out", str(root / f"hybrid_mh{i}.pkl"))
    paths["runs"] = _run_all(commands)
    paths["predict"], paths["hybrid"] = predict, hybrid
    return paths


def _predictions(path) -> tuple[list, np.ndarray]:
    df = pd.read_pickle(path)
    return df["uttid"].tolist(), df["predictions"].to_numpy()


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "eval_model"])
def test_predict_cli_data_parallel_matches_jax(serving, fast):
    """``predict --data-parallel 2`` (the sharded feature scorer with
    ``--fast``, the eval model's ``predict_scores(ranks=...)`` without)
    against the JAX CLI's ``--data-parallel 2`` over two virtual devices,
    and against the port's single-device run."""
    from dfac_tpu.cli import predict as jpredict
    from dfac_tpu_torch.cli import predict as tpredict

    root = serving["root"]
    name = "predict_dp_fast" if fast else "predict_dp"
    out = _ok(serving["runs"], name).splitlines()
    assert out[0] == f"wrote {N_CLI} predictions to {root / name}.pkl" and "on 2 ranks over gloo (cpu" in out[1]
    flags = [*serving["predict"][:-2], *(["--fast"] if fast else [])]  # the JAX CLI takes no --device cpu
    jpredict.main([*flags, "--data-parallel", "2", "--out", str(root / f"j_{name}.pkl")])
    tpredict.main([*flags, "--device", "cpu", "--out", str(root / f"t_{name}.pkl")])
    ids, got = _predictions(root / f"{name}.pkl")
    jids, want = _predictions(root / f"j_{name}.pkl")
    _, single = _predictions(root / f"t_{name}.pkl")
    assert ids == jids == [f"utt{i:02d}" for i in range(N_CLI)]
    np.testing.assert_allclose(got, single, atol=SINGLE_ATOL)
    np.testing.assert_allclose(got, want, atol=TOL["float32"])


def test_predict_hybrid_cli_data_parallel_matches_jax(serving):
    """``predict_hybrid --fast --data-parallel 2``: both bf16 legs sharded
    (an f32 upload), the fusion over the gathered corpus; the port's
    single-process ``--fast`` file, and the fusion of the port's legs, each
    leg within the JAX package's bf16 bound of the JAX leg (scores atol
    2e-2, CAE MSE rtol 0.1; ``tests/test_torch_port_submission.py``) and
    the JAX CLI's ``--data-parallel 2`` file the fusion of the JAX legs."""
    from dfac_tpu.cli import predict_hybrid as jhybrid
    from dfac_tpu.data.normalizer import FeatureNormalizer as JNormalizer
    from dfac_tpu.data.pipeline import load_dataset as jload_dataset
    from dfac_tpu.ensemble.hybrid import fuse_scores as jfuse
    from dfac_tpu.models import fast_infer as jfast
    from dfac_tpu.train.checkpoint import load_model_variables as jload_variables
    from dfac_tpu_torch.cli import predict_hybrid as thybrid
    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.ensemble.hybrid import fuse_scores
    from dfac_tpu_torch.train.checkpoint import load_model_variables

    root, cpu = serving["root"], torch.device("cpu")
    out = _ok(serving["runs"], "hybrid_dp").splitlines()
    assert out[0] == f"wrote {N_CLI} hybrid predictions (alpha=0.8) to {root / 'hybrid_dp.pkl'}"
    jhybrid.main([*serving["hybrid"][:-3], "--fast", "--data-parallel", "2", "--out", str(root / "j_hybrid.pkl")])
    thybrid.main([*serving["hybrid"], "--out", str(root / "t_hybrid.pkl")])
    ids, got = _predictions(root / "hybrid_dp.pkl")
    jids, want = _predictions(root / "j_hybrid.pkl")
    _, single = _predictions(root / "t_hybrid.pkl")
    assert ids == jids
    np.testing.assert_allclose(got, single, atol=SINGLE_ATOL)
    ds, jds = load_dataset(serving["features"]), jload_dataset(serving["features"])
    sup = tfast.predict_scores_fast(load_model_variables(serving["cnn2d"], "cnn2d"), ds, cpu, 4)
    cae = tfast.cae_mse_scores_fast(load_model_variables(serving["cae"], "cae"), ds,
                                    FeatureNormalizer.load(serving["normalizer"]), cpu, 4)
    jsup = np.asarray(jfast.predict_scores_fast(jload_variables(serving["cnn2d"], "cnn2d"), jds, 4))
    jcae = np.asarray(jfast.cae_mse_scores_fast(jload_variables(serving["cae"], "cae"), jds,
                                                JNormalizer.load(serving["normalizer"]), 4))
    np.testing.assert_allclose(sup, jsup, atol=TOL["bfloat16"])
    np.testing.assert_allclose(cae, jcae, rtol=0.1)
    np.testing.assert_allclose(got, fuse_scores(sup, cae, 0.80), atol=SINGLE_ATOL)
    np.testing.assert_allclose(want, jfuse(jsup, jcae, 0.80), atol=SINGLE_ATOL)


@pytest.mark.parametrize("cli", ["predict", "hybrid"])
def test_serving_clis_multihost(serving, cli):
    """Two ``--multihost`` processes (``predict``: two ranks each, world 4,
    one row a rank of each batch of 4): process 0 writes the single-process
    file and prints; process 1 writes nothing and prints nothing."""
    root = serving["root"]
    out0 = _ok(serving["runs"], f"{cli}_mh0")
    assert _ok(serving["runs"], f"{cli}_mh1") == ""
    assert not (root / f"{cli}_mh1.pkl").exists()
    world = 4 if cli == "predict" else 2
    assert f"to {root / f'{cli}_mh0.pkl'}" in out0.splitlines()[0]
    if cli == "predict":
        assert f"on {world} ranks over gloo (cpu" in out0.splitlines()[1]
    single = root / f"t_{cli}_mh.pkl"
    if cli == "predict":
        from dfac_tpu_torch.cli import predict as tpredict

        tpredict.main([*serving["predict"], "--fast", "--out", str(single)])
    else:
        from dfac_tpu_torch.cli import predict_hybrid as thybrid

        thybrid.main([*serving["hybrid"], "--out", str(single)])
    ids, got = _predictions(root / f"{cli}_mh0.pkl")
    want_ids, want = _predictions(single)
    assert ids == want_ids
    np.testing.assert_allclose(got, want, atol=SINGLE_ATOL)


# -- training CLIs ----------------------------------------------------------------------------------------

TRAIN_SPLITS = {"train": 24, "dev": 12}
TRAIN_MODES = {"host_fed": [], "chunked": ["--resident-chunk-batches", "2"], "fused": ["--fused-fit"]}


def _train_args(data, *extra):
    return ["--train-features", str(data / "train" / "features.pkl"),
            "--train-labels", str(data / "train" / "labels.pkl"),
            "--dev-features", str(data / "dev" / "features.pkl"), "--dev-labels", str(data / "dev" / "labels.pkl"),
            "--device", "cpu", "--batch-size", "8", "--in-features", str(CF), "--quiet",
            "--lr-scheduler", "plateau", "--label-smoothing", "0.05", *extra]


def _rank_fit(argv: list, train_ds, dev_ds):
    """``train --data-parallel 2``'s fit on this rank."""
    from dfac_tpu_torch.cli import train as ttrain

    ttrain._fit(ttrain.parse_args(argv), train_ds, dev_ds)


@pytest.fixture(scope="module")
def training(pool, tmp_path_factory):
    """Two ``train --multihost`` processes in each mode, all at once, with
    each process's own ``--checkpoint-dir``; meanwhile the
    ``--data-parallel 2`` fits on the pool; then two processes resuming the
    host-fed run's coordinator file (process 1 is given a path that does not
    exist: only the coordinator reads), beside the pool's resume."""
    from dfac_tpu_torch.data.pipeline import load_dataset

    root = tmp_path_factory.mktemp("mh_training")
    data = root / "data"
    rng = np.random.default_rng(6)
    for split, n in TRAIN_SPLITS.items():
        feats = rng.normal(size=(n, CF, CT)).astype(np.float32)
        labels = np.arange(n) % 2
        feats[labels == 1, :4] += 0.5
        ids = [f"{split}{i}" for i in range(n)]
        (data / split).mkdir(parents=True)
        pd.DataFrame({"uttid": ids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(
            data / split / "features.pkl")
        pd.DataFrame({"uttid": ids, "label": labels}).to_pickle(data / split / "labels.pkl")
    commands = {}
    for mode, extra in TRAIN_MODES.items():
        for i, flags in enumerate(_cluster(2)):
            commands[f"{mode}{i}"] = _cli("dfac_tpu_torch.cli.train", *flags, *_train_args(
                data, "--epochs", "2", *extra, "--checkpoint-dir", str(root / f"{mode}{i}")))
    procs = _start_all(commands)
    try:
        train_ds = load_dataset(str(data / "train" / "features.pkl"), str(data / "train" / "labels.pkl"))
        dev_ds = load_dataset(str(data / "dev" / "features.pkl"), str(data / "dev" / "labels.pkl"))
        for mode in ("host_fed", "chunked"):
            _run(pool, _rank_fit, _train_args(data, "--epochs", "2", "--data-parallel", "2", *TRAIN_MODES[mode],
                                              "--checkpoint-dir", str(root / f"dp_{mode}")), train_ds, dev_ds)
    finally:
        runs = _finish_all(procs)
    resume = ["--epochs", "3", "--resume"]
    coordinator_file = str(root / "host_fed0" / "cnn2d_last.ckpt")
    if runs["host_fed0"][0] == 0:
        cluster = _cluster(2)
        runs.update(_run_all({f"resume{i}": _cli("dfac_tpu_torch.cli.train", *cluster[i], *_train_args(
            data, *resume, coordinator_file if i == 0 else str(root / "elsewhere.ckpt"),
            "--checkpoint-dir", str(root / f"resume{i}"))) for i in range(2)}))
        _run(pool, _rank_fit, _train_args(data, *resume, coordinator_file, "--data-parallel", "2",
                                          "--checkpoint-dir", str(root / "dp_resume")), train_ds, dev_ds)
    return root, runs


def _ckpt(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float64)]


@pytest.mark.parametrize("mode", [*TRAIN_MODES, "resume"])
def test_train_cli_multihost_equals_the_data_parallel_fit(training, mode):
    """Two ``train --multihost`` processes equal ``--data-parallel 2`` on the
    same data (rel 1e-6): the last checkpoint's weights and optimizer
    moments, the best epoch and the best-tracking state; ``--fused-fit``
    (the resident fit, every rank holding the corpus) is held to the
    host-fed DP fit, as a fused DP run is refused. Process 1 writes no
    file and prints nothing."""
    root, runs = training
    assert _ok(runs, f"{mode}1") == ""
    assert not (root / f"{mode}1").exists()
    lines = _ok(runs, f"{mode}0").splitlines()
    assert lines[-1].startswith("best dev EER: ")
    ref = root / ("dp_host_fed" if mode == "fused" else f"dp_{mode}")
    assert sorted(os.listdir(root / f"{mode}0")) == sorted(os.listdir(ref)) == ["cnn2d_best.ckpt", "cnn2d_last.ckpt"]
    for name in ("cnn2d_best.ckpt", "cnn2d_last.ckpt"):
        got, want = _ckpt(root / f"{mode}0" / name), _ckpt(ref / name)
        assert got["epoch"] == want["epoch"]
        if name.endswith("_last.ckpt"):  # a fused run's best file holds the run's final state, as JAX's CLI writes it
            ts, want_ts = got["config"]["_trainer_state"], want["config"]["_trainer_state"]
            assert ts.keys() == want_ts.keys() and [v is None for v in ts.values()] == [
                v is None for v in want_ts.values()]
            np.testing.assert_allclose([v for v in ts.values() if v is not None],
                                       [v for v in want_ts.values() if v is not None], rtol=1e-6)
        # the optimizer's moments of the last epoch (a fused run's best file, written at the end, has none)
        trees = [_leaves({"model": c["model_state"], "opt": (c.get("torch_optimizer_state") or {}).get("state", {})
                          if name.endswith("_last.ckpt") else {}}) for c in (got, want)]
        assert len(trees[0]) == len(trees[1])
        for a, b in zip(*trees):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if mode == "resume":
        assert _ckpt(root / "resume0" / "cnn2d_last.ckpt")["epoch"] == 3
