"""Plain CNN2D: the eval forward, the reference recipe's training step, AdamW and the EER.

The architecture of ``src/model.py:5-42`` of the reference repository: on
the model-view grid (B, T, F) as one channel, three blocks of Conv 3x3
SAME -> BatchNorm -> ReLU with channels 1 -> c -> 2c -> 4c, a floor-mode
(2, 1) average pool over time and dropout after blocks 1 and 2; the head is
the mean over time, flattened channel-major (index ``channel * F + f``),
into ``Linear(4c * F, 1)``. Leaves carry the reference ``state_dict``'s
names. BatchNorm is written out (eps 1e-5): the running statistics at
eval, the batch's mean and biased variance in training.

The training step is the reference's robust recipe (``src/train.py``):
the augmentations of ``src/augmentation.py`` in its order (SpecAugment's
time then feature mask, the circular time shift, channel drop, Gaussian
jitter; one draw per batch), byte-quantized dropout (one uint8 per
element, kept where it is >= round(rate * 256), rescaled by the kept
share), label-smoothed BCE averaged over the batch, then AdamW (betas
0.9 / 0.999, eps 1e-8 after the square root, decoupled weight decay).
The random draws are replayed from a generator seeded as the trainer
seeds its own, in the trainer's documented order (each augmentation's
draws, then each dropout's bytes), so that both sides train on the same
masks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import arithmetic, operand

BN_EPS = 1e-5
CONVS = ("conv.0", "conv.5", "conv.10")
NORMS = ("conv.1", "conv.6", "conv.11")
TIME_MASK_MIN, FEATURE_MASK_MIN = 0.05, 0.02  # the lower ends of the masks' ratios
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def channels(m: dict) -> list[int]:
    c = m["base_channels"]
    return [1, c, 2 * c, 4 * c]


def leaves(m: dict) -> dict:
    """name -> (shape, init rule) for :func:`perfbench.lib.seeded.state_dict`."""
    ch, f = channels(m), m["in_features"]
    out = {}
    for i, (conv, bn) in enumerate(zip(CONVS, NORMS)):
        fan = 9 * ch[i]
        out[f"{conv}.weight"] = ((ch[i + 1], ch[i], 3, 3), ("fan_in", fan))
        out[f"{conv}.bias"] = ((ch[i + 1],), ("fan_in", fan))
        for field in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{field}"] = ((ch[i + 1],), ("bn", field))
        out[f"{bn}.num_batches_tracked"] = ((), ("count",))
    out["classifier.weight"] = ((1, ch[3] * f), ("fan_in", ch[3] * f))
    out["classifier.bias"] = ((1,), ("fan_in", ch[3] * f))
    return out


def parameter_names(m: dict) -> list[str]:
    return [k for k, (_, rule) in leaves(m).items() if rule[0] == "fan_in" or rule in (("bn", "weight"), ("bn", "bias"))]


def _conv(h, sd, name, p):
    return F.conv2d(operand(h, p), operand(sd[f"{name}.weight"], p), sd[f"{name}.bias"], padding=1)


def _bn(h, sd, name, mean, var):
    inv = sd[f"{name}.weight"] / torch.sqrt(var + BN_EPS)
    return (h - mean[:, None, None]) * inv[:, None, None] + sd[f"{name}.bias"][:, None, None]


def _head(h, sd, p):
    emb = h.mean(dim=2).flatten(1)  # (B, C * F), channel-major
    return (operand(emb, p) @ operand(sd["classifier.weight"], p).t())[:, 0] + sd["classifier.bias"][0]


def eval_logits(sd: dict, feats: torch.Tensor, p: str = "f32") -> torch.Tensor:
    """(B, F, T) stored-orientation features -> (B,) logits, eval mode."""
    with arithmetic(p):
        h = feats.float().transpose(1, 2)[:, None]
        for i, (conv, bn) in enumerate(zip(CONVS, NORMS)):
            h = _conv(h, sd, conv, p)
            h = torch.relu(_bn(h, sd, bn, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"]))
            if i < 2:
                h = F.avg_pool2d(h, (2, 1))
        return _head(h, sd, p)


def logits_of_rows(sd: dict, feats_host: np.ndarray, device, p: str = "f32", block: int = 128) -> np.ndarray:
    """:func:`eval_logits` over host rows, ``block`` rows at a time."""
    out = []
    with torch.inference_mode():
        for s in range(0, len(feats_host), block):
            x = torch.as_tensor(np.asarray(feats_host[s : s + block], np.float32), device=device)
            out.append(eval_logits(sd, x, p).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row BCE on logits, the stable form ``max(x, 0) - x y + log(1 + exp(-|x|))``."""
    return torch.clamp_min(logits, 0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


# -- the recipe's augmentations, one draw per batch, on (B, T, F) ---------------------------


def _uniform(gen, device, shape=(), minval=0.0, maxval=1.0):
    u = torch.rand(shape, generator=gen, device=device)
    return u if (minval, maxval) == (0.0, 1.0) else minval + (maxval - minval) * u


def _segment(length: int, u, u2, device):
    seg = (length * u.float()).to(torch.int32).clamp(1, length - 1)
    start = torch.minimum((u2.float() * (length - seg + 1).float()).to(torch.int32), length - seg)
    idx = torch.arange(length, device=device)
    return (idx >= start) & (idx < start + seg)


def augment(x: torch.Tensor, gen, a: dict) -> torch.Tensor:
    dev = x.device
    b, t, f = x.shape
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    if a["spec_augment"]:
        tu = _uniform(gen, dev, minval=TIME_MASK_MIN, maxval=a["time_mask_ratio"]), _uniform(gen, dev)
        fu = None
        if a["feature_mask"]:
            fu = _uniform(gen, dev, minval=FEATURE_MASK_MIN, maxval=a["feature_mask_ratio"]), _uniform(gen, dev)
        x = torch.where(_segment(t, *tu, dev)[None, :, None], zero, x)
        if fu is not None:
            x = torch.where(_segment(f, *fu, dev)[None, None, :], zero, x)
    if a["time_shift"]:
        m = int(t * a["time_shift_ratio"]) if t > 1 and a["time_shift_ratio"] > 0 else 0
        if m >= 1:
            shift = torch.randint(-m, m + 1, (), generator=gen, device=dev)
            x = x.index_select(1, torch.remainder(torch.arange(t, device=dev) - shift, t))
    if a["channel_drop"] and a["channel_drop_prob"] > 0:
        keep = _uniform(gen, dev, (1, 1, f)) >= a["channel_drop_prob"]
        x = x * keep.to(x.dtype)
    if a["gaussian_jitter"] and a["gaussian_jitter_std"] > 0:
        x = x + torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype) * a["gaussian_jitter_std"]
    return x


def dropout(h: torch.Tensor, gen, rate: float) -> torch.Tensor:
    thresh = max(0, min(int(round(rate * 256)), 256))
    if thresh == 0:
        return h
    bits = torch.randint(0, 256, h.shape, dtype=torch.uint8, device=h.device, generator=gen)
    return torch.where(bits >= thresh, h / (1.0 - thresh / 256.0), torch.zeros((), dtype=h.dtype, device=h.device))


def train_logits(sd: dict, x: torch.Tensor, gen, rate: float, p: str) -> torch.Tensor:
    """Model-view (B, T, F) batch -> (B,) logits in training mode."""
    h = x[:, None]
    for i, (conv, bn) in enumerate(zip(CONVS, NORMS)):
        h = _conv(h, sd, conv, p)
        mean = h.mean(dim=(0, 2, 3))
        var = (h - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        h = torch.relu(_bn(h, sd, bn, mean, var))
        if i < 2:
            h = dropout(F.avg_pool2d(h, (2, 1)), gen, rate)
    return _head(h, sd, p)


def train_steps(sd0: dict, batches, recipe: dict, seed: int, m: dict, p: str = "f32", drop_half: bool = False):
    """The recipe's steps from ``sd0`` on ``batches`` ((B, F, T) features, (B,)
    labels on the device). Returns each step's loss, the first step's
    gradients, and the parameters after the last step. ``drop_half`` plants
    a fault: the loss is the mean over the batch's first half alone."""
    names = parameter_names(m)
    params = {k: sd0[k].detach().float().clone() for k in names}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}
    gen = torch.Generator(device=params[names[0]].device).manual_seed(seed)
    lr, wd, ls = recipe["lr"], recipe["weight_decay"], recipe["label_smoothing"]
    losses, first = [], None
    with arithmetic(p):
        for t, (feats, labels) in enumerate(batches, 1):
            x = augment(feats.float().transpose(1, 2), gen, recipe["augment"]).contiguous()
            leaf = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            per = bce(train_logits({**sd0, **leaf}, x, gen, recipe["dropout"], p), labels * (1.0 - ls) + 0.5 * ls)
            if drop_half:
                per = per[: len(per) // 2]
            loss = per.sum() / len(per)
            grads = torch.autograd.grad(loss, [leaf[k] for k in names])
            if t == 1:
                first = {k: g.detach().clone() for k, g in zip(names, grads)}
            with torch.no_grad():
                for k, g in zip(names, grads):
                    v, (m1, m2) = params[k], state[k]
                    v.mul_(1.0 - lr * wd)
                    m1.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                    m2.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                    denom = (m2.sqrt() / (1.0 - BETAS[1] ** t) ** 0.5).add_(ADAM_EPS)
                    v.addcdiv_(m1, denom, value=-lr / (1.0 - BETAS[0] ** t))
            losses.append(float(loss.detach()))
    return {"losses": losses, "first_grads": first, "params": params}


def eer(scores, labels) -> float:
    """The reference's discrete EER (``scripts/evaluation.py:7-56``): scores
    sorted ascending (stable), FAR from 1 and FRR from 0 at each cut, the
    midpoint of the two at the first argmin of ``|FAR - FRR|``."""
    scores, labels = np.asarray(scores), np.asarray(labels)
    order = np.argsort(scores, kind="stable")
    lab = labels[order]
    n_bona = int(labels.sum())
    n_spoof = len(labels) - n_bona
    if n_bona == 0 or n_spoof == 0:
        return 0.0
    far = np.concatenate([[1.0], (n_spoof - np.cumsum(lab == 0)) / n_spoof])
    frr = np.concatenate([[0.0], np.cumsum(lab == 1) / n_bona])
    i = int(np.argmin(np.abs(far - frr)))
    return float((far[i] + frr[i]) / 2.0)
