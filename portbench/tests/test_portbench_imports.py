"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the port.  Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "tensorflowonspark_tpu"}
PORT = "tensorflowonspark_tpu_torch"


def _top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__")) or (
                isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "__import__"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    found = {(str(f.relative_to(PB)), n) for f in files
             for n in _top_names(f) if n in JAX}
    assert not found


def test_reference_imports_nothing_of_the_port():
    files = sorted((PB / "reference").rglob("*.py"))
    assert files
    found = {(str(f.relative_to(PB)), n) for f in files
             for n in _top_names(f) if n == PORT}
    assert not found


def test_names_are_compared_whole():
    assert PORT not in JAX and PORT.startswith("tensorflowonspark_tpu")
