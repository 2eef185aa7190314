"""The PyTorch port's user examples (``examples/torch_*.py``): each compiles
and imports the port and nothing of the JAX package or JAX. They run on the
card, so here they are parsed, and each name they import from the port is
looked up in its module; nothing of an example runs."""

import ast
import importlib
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# The JAX package's user examples, each with its counterpart in the port.
PORTED = ["basic_synthesis", "batch_serving", "streaming_synthesis", "voice_selection",
          "convert_reference", "train_dit"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "vietvoice_tts_tpu"}


def _imported_roots(tree: ast.AST) -> set:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_only_the_port(name):
    path = EXAMPLES / f"torch_{name}.py"
    source = path.read_text()
    compile(source, str(path), "exec")
    tree = ast.parse(source)
    roots = _imported_roots(tree)
    assert "vietvoice_tts_tpu_torch" in roots
    assert not roots & FORBIDDEN, roots & FORBIDDEN
    assert ast.get_docstring(tree), "an example says what it does and how to run it"
    assert (EXAMPLES / f"{name}.py").exists(), "the JAX example it ports"


@pytest.mark.parametrize("name", PORTED)
def test_example_names_exist_in_the_port(name):
    """Every ``from vietvoice_tts_tpu_torch... import X`` of the example names
    something its module has, so a renamed API fails here and not on the card."""
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    imported = [(node.module, alias.name) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "vietvoice_tts_tpu_torch"
                for alias in node.names]
    assert imported
    missing = [f"{module}.{attr}" for module, attr in imported
               if not hasattr(importlib.import_module(module), attr)]
    assert not missing, missing
