"""A run whose timed path is broken underneath comes out not correct.

Each test skips the look for a card, drives the rest of a run on the CPU
at a tiny size with one fault planted in the program, and reads
``correct``: false for the fault, true for the same run without it (so the
fault is what flips it). The faults are those each cell can have: an
answer altered where it is produced, half of a batch left out, a step
that leaves its state unchanged. A training cell's faults sit in the
window's own call (``Trainer.train_epoch``, ``run_epoch``), and one of them
only in the window's epochs. One chip, so no exchange between chips can
be left out.
"""

from __future__ import annotations

import copy
import json

import pytest
from conftest import tiny

from perfbench import run


def correct(cell: str, cpu) -> bool:
    ctx, outcome, numbers = run.run_cell(cell, 77, 0.3, False, cpu, tiny(cell))
    return run.is_correct(ctx, outcome, numbers)


def alter_one(fn, scale):
    """``fn`` with the first row of its (B,) answer altered."""
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        out[0] = out[0] * scale + 1e-3
        return out
    return wrapped


def half_left_out(fn):
    """``fn`` with the second half of its (B,) answer taken from the first half."""
    def wrapped(*a, **k):
        out = fn(*a, **k).clone()
        h = len(out) // 2
        out[h : 2 * h] = out[:h]
        return out
    return wrapped


def fused_altered(fn):
    def wrapped(*a, **k):
        out = fn(*a, **k).copy()
        out[0] += 0.25
        return out
    return wrapped


def state_kept(fn, from_epoch=0):
    """``Trainer.train_epoch`` that leaves the model and the optimizer as it
    found them, in epochs from ``from_epoch`` on."""
    def wrapped(self, ds, epoch, *a, **k):
        if epoch < from_epoch:
            return fn(self, ds, epoch, *a, **k)
        kept = copy.deepcopy((self.model.state_dict(), self.optimizer.state_dict()))
        try:
            return fn(self, ds, epoch, *a, **k)
        finally:
            self.model.load_state_dict(kept[0])
            self.optimizer.load_state_dict(kept[1])
    return wrapped


def half_batch(fn):
    """``run_epoch`` whose step weighs the first half of each batch alone, the mean over it."""
    def wrapped(step, batches, *a, **k):
        def half(feats, labels, weights):
            w = weights.clone()
            w[len(w) // 2 :] = 0
            return step(feats, labels, w)
        return fn(half, batches, *a, **k)
    return wrapped


SCORE_FAULTS = {
    "cnn2d-score-f32": [("dfac_tpu_torch.ops.conv_block", "cnn2d_head", lambda f: alter_one(f, 1.01)),
                        ("dfac_tpu_torch.ops.conv_block", "cnn2d_head", half_left_out)],
    "hybrid-score-bf16": [("dfac_tpu_torch.ops.conv_block", "cnn2d_head", lambda f: alter_one(f, 1.5)),
                          ("dfac_tpu_torch.models.fast_infer", "cae_fast_mse", lambda f: alter_one(f, 1.5)),
                          ("dfac_tpu_torch.models.fast_infer", "cae_fast_mse", half_left_out),
                          ("dfac_tpu_torch.ensemble.hybrid", "fuse_scores", fused_altered)],
}
TRAIN_FAULTS = [("dfac_tpu_torch.train.loop", "Trainer.train_epoch", state_kept),
                ("dfac_tpu_torch.train.loop", "Trainer.train_epoch", lambda f: state_kept(f, from_epoch=1)),
                ("dfac_tpu_torch.train.loop", "run_epoch", half_batch)]
CASES = [(c, *f) for c, fs in SCORE_FAULTS.items() for f in fs] + \
        [(c, *f) for c in ("cnn2d-train-b32", "cnn2d-train-b512") for f in TRAIN_FAULTS]


@pytest.mark.parametrize("cell,module,name,fault", CASES,
                         ids=[f"{c}-{n}-{i}" for i, (c, m, n, f) in enumerate(CASES)])
def test_a_planted_fault_is_not_correct(cell, module, name, fault, cpu, monkeypatch):
    import importlib

    assert correct(cell, cpu)
    owner, attr = importlib.import_module(module), name
    if "." in name:
        cls, attr = name.split(".")
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    assert not correct(cell, cpu)


def test_a_loaded_jax_refuses_the_run(cpu, capsys, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    cell = "cnn2d-score-f32"
    argv = ["--workload", cell, "--seed", "1", "--seconds", "0.2", "--trace", "0"]
    assert run.main(argv, device=cpu, overrides=tiny(cell)) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
