"""Counterpart of ``scripts/pool_kernel_probe.py``: three (2,1) time pools
in the CNN2D inference chain, timed on the card.

    python -m dfac_tpu_torch.scripts.pool_kernel_probe [--batch 512] [--n-corpus 4096] [--device cuda|cpu] [--seed 0]

The chain is conv -> pool -> conv -> pool -> conv -> head on an N(0,1)
bf16 corpus of (n, 321, 180) made on the device, with a CNN2D of random
weights (seeded) folded by :func:`~dfac_tpu_torch.models.fast_infer.fold_cnn2d`.
The pools:

* ``reduce_window``: ``F.avg_pool2d`` (the JAX script's ``nn.avg_pool``);
* ``depthwise``: a grouped stride-(2,1) conv with weights 0.5;
* ``pallas``: kernel 5, :func:`dfac_tpu_torch.ops.pool.time_pool`.

It prints each variant's largest logit difference from ``reduce_window``,
each variant's utt/s (best of 5 runs over the corpus after one warm-up,
host clock ending in a synchronize), kernel 5's launches in the timed
``pallas`` runs, and last the whole run's kernel launches. The convs and
the head are plain PyTorch, as the JAX script leaves them to XLA.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch
import torch.nn.functional as F

from dfac_tpu_torch.device import resolve_device
from dfac_tpu_torch.models import build_model
from dfac_tpu_torch.models.fast_infer import fold_cnn2d
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops.conv_block import cnn2d_head, reference_conv_block
from dfac_tpu_torch.ops.pool import time_pool

T, FEATS = 321, 180


def random_cnn2d(seed: int) -> torch.nn.Module:
    """CNN2D with flax's default initialisation drawn from a seeded
    generator: N(0, 1/fan_in) kernels, zero biases, identity BatchNorm."""
    model = build_model("cnn2d", in_features=FEATS).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) / math.sqrt(fan_in))
                mod.bias.zero_()
    return model


def conv(h: torch.Tensor, folded: dict, i: int) -> torch.Tensor:
    """3x3 SAME conv of NHWC bf16 h with block i's bf16-rounded folded
    weights, f32 sum + f32 bias, ReLU, one rounding to bf16
    (``pool_kernel_probe.py:54-60``). A bf16 ``F.conv2d`` would round the sum
    before the bias, so the conv runs in f32 on the bf16 values: the plain
    conv block without its pool. cuDNN's TF32 (PyTorch's default) is exact
    here, since bf16 operands fit TF32 and their products fit f32."""
    return reference_conv_block(h, folded[f"w{i}"], folded[f"b{i}"], pool=False)


def pool_avg(h: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(h.permute(0, 3, 1, 2), (2, 1)).permute(0, 2, 3, 1)


def pool_depthwise(h: torch.Tensor) -> torch.Tensor:
    c = h.shape[-1]
    w = torch.full((c, 1, 2, 1), 0.5, dtype=h.dtype, device=h.device)
    return F.conv2d(h.permute(0, 3, 1, 2), w, stride=(2, 1), groups=c).permute(0, 2, 3, 1)


# ``conv`` returns NHWC-contiguous tensors, as kernel 5 requires
POOLS = {"reduce_window": pool_avg, "depthwise": pool_depthwise, "pallas": time_pool}


def make_chain(folded: dict, pool):
    """(B, 321, 180) bf16 -> (B,) f32 logits (``pool_kernel_probe.py:111-119``)."""

    def chain(x):
        h = conv(x[..., None], folded, 1)
        h = pool(h)
        h = conv(h, folded, 2)
        h = pool(h)
        h = conv(h, folded, 3)
        return cnn2d_head(h, folded, apply_sigmoid=False)

    return chain


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, batches, device: torch.device) -> tuple[float, int]:
    """(utt/s, batches run): best of 5 runs over the corpus after one warm-up."""

    def run():
        for b in batches:
            fn(b)
        _sync(device)

    run()
    best = math.inf
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return sum(len(b) for b in batches) / best, 6 * len(batches)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n-corpus", type=int, default=4096)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    folded = {k: v.to(device) for k, v in fold_cnn2d(random_cnn2d(args.seed).state_dict()).items()}
    n, bsz = args.n_corpus, args.batch
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    feats = torch.randn(n, T, FEATS, generator=gen, device=device).to(torch.bfloat16)
    batches = [feats[s : s + bsz] for s in range(0, n, bsz)]

    before = _build.launch_counts()
    result = {"diff": {}, "utt_s": {}}
    with torch.inference_mode():
        chains = {name: make_chain(folded, pool) for name, pool in POOLS.items()}
        base = chains["reduce_window"](batches[0])
        for name, fn in chains.items():
            if name != "reduce_window":
                d = (base - fn(batches[0])).abs().max().item()
                result["diff"][name] = d
                print(f"max |logit diff| vs base ({name}): {d:.3e}")
        for name, fn in chains.items():
            timed_before = _build.launch_counts()
            result["utt_s"][name], n_batches = timeit(fn, batches, device)
            print(f"{name:14s}: {result['utt_s'][name]:8,.0f} utt/s")
            if name == "pallas":
                result["pallas_launches"] = _build.launches_since(timed_before)["time_pool"]
                result["pallas_batches"] = n_batches
    print(f"time_pool launches in the timed pallas runs: {result['pallas_launches']} over "
          f"{result['pallas_batches']} batches")
    print(f"kernel launches: {json.dumps(_build.launches_since(before))}")
    return result


if __name__ == "__main__":
    main()
