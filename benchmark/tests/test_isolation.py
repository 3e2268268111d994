"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: every import's top-level name
(before the first dot) compared whole, since the program's name begins
with the JAX package's."""

import ast
from pathlib import Path

import pytest

from dcbench import env

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "depth_image_captioning_pub_tpu"}
PROGRAM = "depth_image_captioning_pub_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert PROGRAM not in names
    assert "dcbench" not in names     # the harness imports the program
    assert names <= {"__future__", "contextlib", "typing", "torch",
                     "numpy", "math", "zlib", "reference"}


def test_top_level_names_compared_whole():
    assert "depth_image_captioning_pub_torch" not in env.FORBIDDEN
    assert set(env.FORBIDDEN) == JAX


def test_the_run_finds_jax_modules(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "depth_image_captioning_pub_tpu.x",
                        types.ModuleType("x"))
    assert env.forbidden_modules() == ["depth_image_captioning_pub_tpu"]


def test_the_run_ignores_the_program(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "depth_image_captioning_pub_torch_x",
                        types.ModuleType("x"))
    assert "depth_image_captioning_pub_torch_x" not in env.forbidden_modules()
