"""No module of the harness imports jax or the JAX package, and the
reference imports nothing of the program either."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent
MODULES = sorted(p for p in HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "nimble_tpu"}


REFERENCE = [p for p in MODULES if p.parent.name == "reference"] + [
    HERE / "control.py", HERE / "generate.py", HERE / "roofline.py"]


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_and_the_yardstick_import_nothing_of_the_program(path):
    assert "nimble_tpu_torch" not in _imported(path)
