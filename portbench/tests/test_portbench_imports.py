"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "quantized_distillation_tpu"}
PORT = "quantized_distillation_tpu_torch"


def imported(path: Path):
    """Top-level names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


def test_files_found():
    assert len(FILES) > 20 and HERE / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path))


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(imported(path))
    assert PORT not in names and "portbench" not in names


def test_whole_names_compared():
    # the port's name begins with the JAX package's: it is not JAX's
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "quantized_distillation_tpu" in FORBIDDEN


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    import sys

    from portbench.harness import loaded_forbidden

    monkeypatch.setitem(sys.modules, "quantized_distillation_tpu_torch_fake", object())
    assert "quantized_distillation_tpu_torch_fake" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in loaded_forbidden()
