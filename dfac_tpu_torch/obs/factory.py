"""Visualizer factory with graceful degradation.

Counterpart of :mod:`dfac_tpu.obs.factory`; parity target reference
``src/visualizers/__init__.py:25-60`` —
``create_visualizer('rich'|'tqdm'|'noop')`` with ImportError fallback chain
rich -> tqdm -> noop. The chain chooses a display only, never a device or
a kernel.
"""

from __future__ import annotations

from dfac_tpu_torch.obs.base import TrainingVisualizer
from dfac_tpu_torch.obs.noop import NoOpVisualizer


def create_visualizer(kind: str = "rich") -> TrainingVisualizer:
    if kind == "noop":
        return NoOpVisualizer()
    if kind == "rich":
        try:
            from dfac_tpu_torch.obs.rich_visualizer import RichVisualizer

            return RichVisualizer()
        except ImportError:
            kind = "tqdm"
    if kind == "tqdm":
        try:
            from dfac_tpu_torch.obs.tqdm_visualizer import TqdmVisualizer

            return TqdmVisualizer()
        except ImportError:
            return NoOpVisualizer()
    raise ValueError(f"unknown visualizer '{kind}' (rich|tqdm|noop)")
