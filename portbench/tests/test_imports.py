"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: checked on every module under
portbench/ by whole top-level module name."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "wordgesture_gan_tpu"}
PROGRAM = "wordgesture_gan_tpu_torch"


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported_tops(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(imported_tops(path))
    assert not set(imported_tops(path)) & {"portbench"}   # nor the harness that calls it


def test_whole_names_are_compared():
    # The program's name begins with the JAX package's: a prefix test would
    # flag every import of the program.
    assert PROGRAM.startswith("wordgesture_gan_tpu") and PROGRAM not in JAX
