"""Explicit device selection: the port never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` -> :class:`torch.device`.

    ``None`` means ``"cuda"``: the port is written for the card, and a run
    that silently lands on the CPU would report CPU numbers as the card's.
    Asking for CUDA where none is present raises.
    """
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain PyTorch path on the CPU"
        )
    return dev
