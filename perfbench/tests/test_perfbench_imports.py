"""Nothing under perfbench/ imports JAX or the JAX package, and the references import nothing of the program."""

from __future__ import annotations

import ast
import sys
import types

import pytest

from perfbench.lib import bench
from perfbench.lib.guard import FORBIDDEN, forbidden_loaded, top_level

SOURCES = sorted(p for p in bench.BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set[str]:
    """Every module name an ``import`` or ``from ... import`` of ``path`` names."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(bench.ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    bad = sorted(n for n in imported(path) if top_level(n) in FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_the_port_is_not_the_jax_package():
    assert top_level("dfac_tpu_torch.models.fast_infer") == "dfac_tpu_torch"
    assert top_level("dfac_tpu_torch.models") not in FORBIDDEN
    assert top_level("dfac_tpu.models") in FORBIDDEN


@pytest.mark.parametrize("path", sorted((bench.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not [n for n in imported(path) if top_level(n) == "dfac_tpu_torch"]


def test_the_guard_sees_a_loaded_jax(monkeypatch):
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "dfac_tpu", types.ModuleType("dfac_tpu"))
    assert forbidden_loaded() == ["dfac_tpu", "jax.numpy"]
