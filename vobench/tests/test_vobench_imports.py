"""Nothing the benchmark runs imports JAX or the JAX package, by top-level
module names compared whole (``dvo_tpu_torch`` begins with ``dvo_tpu``), and
the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from vobench import harness

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "dvo_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "dataclasses", "types", "typing",
                                       "torch", "vobench"}
    text = path.read_text()
    assert "dvo_tpu_torch" not in text.replace("``dvo_tpu_torch``", "")


def test_only_program_module_imports_the_program():
    users = {p.name for p in SOURCES if "dvo_tpu_torch" in top_level_imports(p)
             or "from dvo_tpu_torch" in p.read_text() or "import dvo_tpu_torch" in p.read_text()}
    assert users == {"program.py"}


def test_forbidden_names_are_whole(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "dvo_tpu_torch_fake", object())
    assert "dvo_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dvo_tpu.models", object())
    assert harness.forbidden_modules() == ["dvo_tpu"]
