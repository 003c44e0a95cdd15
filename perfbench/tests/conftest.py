"""Shared pieces of the benchmark's own tests (run on the CPU at tiny sizes; ``cuda`` tests on the card).

    python -m pytest perfbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_INPUT = {"input": {"in_features": 16, "frames": 17}}
TINY_MODELS = {"cnn2d": {"base_channels": 4}, "cae": {"base_channels": 4}}
TINY_SCORE = {"corpus_utterances": 64, "batch_size": 8, "request_rows": {"min": 8, "max": 24, "cycle": 4},
              "sample_requests": 3}
TINY_TRAIN = {"train_utterances": 64, "dev_utterances": 32, "batch_size": 8}


def tiny(cell: str, **config) -> dict:
    """Overrides that shrink ``cell`` to a CPU test's size: 16 features by 17
    frames, base width 4, a 64-utterance corpus in batches of 8. The hybrid
    runs in f32 here, as the CPU's bf16 gaps at these widths say nothing of
    the card's."""
    from perfbench.lib import bench

    c = bench.data("cells", cell)
    names = bench.data("configs", c["config"])["models"]
    models = {m: TINY_MODELS[m] for m in names}
    extra = {"dtype": "float32"} if c["config"] == "cnn2d-cae-hybrid" else {}
    traffic = TINY_TRAIN if c["driver"] == "train_epochs" else TINY_SCORE
    return {"config": {**TINY_INPUT, "models": models, **extra, **config}, "traffic": dict(traffic)}


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
