"""Nothing of the benchmark imports JAX or the JAX package, by whole
top-level module name (the port, `repro_torch`, is allowed outside the
reference); the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "lpbench" not in top_level_imports(path)


def test_scan_sees_the_port():
    """The scan compares whole names: the harness's import of the port
    is seen, and is not taken for the JAX package."""
    assert "repro_torch" in top_level_imports(HERE / "run.py") | set().union(
        *(top_level_imports(p) for p in SOURCES))
