"""The benchmark measures the PyTorch port alone: no JAX in the process.

Names are compared whole at their top level (the part before the first
dot), so ``dfac_tpu_torch`` is not ``dfac_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dfac_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded() -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    return sorted(n for n in list(sys.modules) if top_level(n) in FORBIDDEN)
