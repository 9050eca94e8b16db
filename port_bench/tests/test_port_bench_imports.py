"""No module of the benchmark imports JAX, flax or the JAX package, and the
plain reference imports nothing of the program."""

import ast
import pathlib

import pytest

from port_bench import common

BENCH = pathlib.Path(common.__file__).resolve().parent
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: pathlib.Path) -> set:
    """Top-level names of every import in a file, each taken whole up to the
    first dot."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "mvlt_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert common.PROGRAM not in imported_tops(path)


def test_whole_names_are_compared():
    """The port's name begins with the JAX package's and passes; the JAX
    package and its submodules do not."""
    assert common.forbidden_loaded({"mvlt_tpu_torch": 1, "mvlt_tpu_torch.ops": 1}) == []
    assert common.forbidden_loaded({"mvlt_tpu": 1, "jax.numpy": 1, "flax": 1}) == [
        "flax", "jax.numpy", "mvlt_tpu"]
