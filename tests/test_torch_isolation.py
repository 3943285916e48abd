"""The port imports neither JAX nor the JAX package: an AST scan of every
file under src/repro_torch/ and of chip_smoke.py."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert len(FILES) > 15
    assert all(p.exists() for p in FILES)


# the observability slice's modules, each of which the scan must cover
OBS_MODULES = ("obs/memory.py", "obs/profile.py", "obs/__init__.py",
               "launch/census.py", "launch/report.py",
               "core/baseline_numpy.py", "core/maximizer.py")


@pytest.mark.parametrize("rel", OBS_MODULES)
def test_observability_modules_scanned(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
