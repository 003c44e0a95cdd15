"""Training throughput on the card: the helpers ``chip_smoke.py``'s
training phases (15 and 17) time the trainers with.

* :func:`synthetic_dataset`: a labeled corpus from a seed whose classes
  overlap (dev EER well above 0), at any geometry;
* :func:`epoch_seconds`: host seconds of whole epochs of a trainer's
  ``train_epoch(ds, epoch)`` (:class:`~dfac_tpu_torch.train.loop.Trainer`,
  :class:`~dfac_tpu_torch.train.cae_loop.CAETrainer`; each ends in a fetch
  of the epoch's loss, so the card has finished), after a warm-up;
  :func:`run_seconds` of any such run;
* :func:`profile_epoch` (:func:`profile_run`): one epoch under
  ``torch.profiler``: device time per step, the largest device items, and
  the kernels under the forward and backward of the convolution whose
  input has a given shape (conv1's: ``(B, 1, T, F)``).

There is no command line; on the CPU the profiler records no device time
and every helper still runs (the tests rehearse them).
"""

from __future__ import annotations

import time

import numpy as np

REPS = 7  # timed epochs per setting
TOP = 8  # largest device items listed
SHIFT, SPREAD = 0.2, 0.1  # the synthetic classes' offset and its spread: they overlap


def synthetic_dataset(n: int, in_features: int, frames: int, seed: int):
    """N(0, 1) features whose first ``min(60, in_features)`` rows (the
    LFCC block) carry a per-utterance offset ``SHIFT * label + SPREAD *
    N(0, 1)``: the classes overlap, so a trained model's EER is not 0."""
    from dfac_tpu_torch.data.pipeline import ArrayDataset

    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(size=(n, in_features, frames), dtype=np.float32)
    labels = (np.arange(n) % 2).astype(np.int32)
    offset = SHIFT * labels + SPREAD * rng.normal(size=n)
    feats[:, : min(60, in_features), :] += offset.astype(np.float32)[:, None, None]
    return ArrayDataset(uttids=[f"utt{seed}_{i:06d}" for i in range(n)], features=feats, labels=labels)


def epoch_seconds(trainer, ds, reps: int = REPS, first_epoch: int = 1) -> list[float]:
    """Host seconds of ``reps`` epochs after one warm-up epoch (epochs
    numbered from ``first_epoch``, so each has its own shuffle)."""
    return run_seconds(lambda i: trainer.train_epoch(ds, first_epoch + i), reps)


def run_seconds(run, reps: int = REPS) -> list[float]:
    """Host seconds of ``run(1)`` .. ``run(reps)`` after a warm-up
    ``run(0)``; each run must end in a fetch from the device (an epoch's
    loss), so that the card has finished when the clock stops."""
    run(0)
    out = []
    for r in range(reps):
        t0 = time.perf_counter()
        run(1 + r)
        out.append(time.perf_counter() - t0)
    return out


def _subtree_kernels(evt) -> list:
    found = list(evt.kernels)
    for child in evt.cpu_children:
        found += _subtree_kernels(child)
    return found


def conv_kernels(events, in_shape) -> dict[str, dict[str, list]]:
    """``{"forward"|"backward": {kernel name: [total us, launches]}}`` of
    the device kernels launched under ``aten::convolution`` /
    ``aten::convolution_backward`` for the convolution whose input has
    shape ``in_shape`` (the profile must record shapes), and the ops'
    count under the key ``"ops"``."""
    in_shape = list(in_shape)
    out: dict = {"forward": {}, "backward": {}, "ops": {"forward": 0, "backward": 0}}
    for evt in events:
        shapes = evt.input_shapes or []
        if evt.name == "aten::convolution" and shapes[:1] == [in_shape]:
            kind = "forward"
        elif evt.name == "aten::convolution_backward" and shapes[1:2] == [in_shape]:
            kind = "backward"
        else:
            continue
        out["ops"][kind] += 1
        for k in _subtree_kernels(evt):
            entry = out[kind].setdefault(k.name, [0.0, 0])
            entry[0] += k.duration
            entry[1] += 1
    return out


def profile_epoch(trainer, ds, epoch: int, conv_input_shape) -> dict:
    """One epoch of ``trainer`` under ``torch.profiler`` (shapes recorded).

    Returns per step: ``device_ms`` (the sum of device kernel and copy
    times), ``top`` [(name, ms, launches)] of the largest device items, and
    ``conv`` (:func:`conv_kernels` of ``conv_input_shape``, in ms per step);
    plus ``steps`` and ``wall_ms`` (the profiled epoch's host time per step,
    the profiler's own host work included)."""
    steps = -(-len(ds) // trainer.cfg.batch_size)
    return profile_run(lambda: trainer.train_epoch(ds, epoch), trainer.device, steps, conv_input_shape)


def profile_run(run, device, steps: int, conv_input_shape) -> dict:
    """:func:`profile_epoch` of any ``run()`` of ``steps`` train steps on
    ``device`` (the detector's epochs take a drawn order, not an epoch
    number)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dfac_tpu_torch.profiling import device_us

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities, record_shapes=True) as prof:
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(
        ((e.key, e.count, device_us(e)) for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[2],
    )
    conv = conv_kernels(prof.events(), conv_input_shape)
    for kind in ("forward", "backward"):
        conv[kind] = {name: (us / 1e3 / steps, n / steps) for name, (us, n) in conv[kind].items()}
    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_ms": sum(r[2] for r in rows) / 1e3 / steps,
        "top": [(name, us / 1e3 / steps, n / steps) for name, n, us in rows[:TOP]],
        "conv": conv,
    }
