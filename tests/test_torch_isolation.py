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


# the solver examples and the dense LM serving path, each of which the scan
# must cover
EXAMPLE_AND_LM_MODULES = (
    "examples/__init__.py", "examples/_common.py", "examples/quickstart.py",
    "examples/moe_lp_routing.py", "examples/formulations_tour.py",
    "examples/matching_scale.py", "examples/chaos_smoke.py",
    "examples/allocation_server.py", "examples/serve_lm.py",
    "models/__init__.py", "models/config.py", "models/layers.py",
    "models/attention.py", "models/transformer.py", "models/model.py",
    "configs/__init__.py", "configs/qwen3_1_7b.py", "configs/gemma_2b.py",
    "configs/chatglm3_6b.py", "configs/deepseek_coder_33b.py",
    "configs/granite_moe_1b.py", "configs/jamba_1_5_large.py",
    "configs/llama4_scout.py", "configs/mamba2_780m.py",
    "configs/pixtral_12b.py", "configs/seamless_m4t_medium.py",
    "serving/__init__.py", "serving/engine.py",
    "core/preconditioning.py", "convert.py")


@pytest.mark.parametrize("rel", EXAMPLE_AND_LM_MODULES)
def test_example_and_lm_modules_scanned(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
