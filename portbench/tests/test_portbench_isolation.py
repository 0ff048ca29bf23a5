"""The benchmark stands apart: nothing under portbench/ imports jax or the
JAX package (top-level module names compared whole, since the port's
name begins with the JAX package's), no file reads the JAX package's
benchmark, the smoke script or the scripts folder, and the references
import nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import REPO

PKG = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "datafusion_tpu"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_port_is_not_mistaken_for_the_jax_package():
    """The whole-name rule: the port's top-level name is allowed, the JAX
    package's is not."""
    assert "datafusion_tpu_torch" not in FORBIDDEN and "datafusion_tpu" in FORBIDDEN
    assert top_level_imports(PKG / "core" / "port.py") & FORBIDDEN == set()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_reads_nothing_of_the_old_benchmarks(path):
    text = path.read_text()
    for other in ("bench" + "marks/", "chip_" + "smoke", "scripts" + "/", "bench" + ".py"):
        assert other not in text, f"{path} names {other}"


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "datafusion_tpu_torch" not in top_level_imports(path)


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.cities, portbench.makers.cities\n"
            "import portbench.core.compare, portbench.core.traffic\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'datafusion_tpu', "
            "'datafusion_tpu_torch'})\nprint(bad)\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
