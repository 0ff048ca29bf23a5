"""Shared pieces of the benchmark's tests: a checkout of the benchmark at
a tiny scale in a temporary directory, and the marker of tests that need
a CUDA device (they skip inside the `cuda` fixture, never at import)."""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path
from typing import Optional

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the tiny scale every CPU test runs at
TINY_ROWS = {
    "cities_2e25": {"cities": 50000},
    "cities_2e27_mesh4": {"cities": 80000},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark refuses to run without one)")
    return torch.device("cuda", 0)


def tiny_cfg(name: str) -> dict:
    with open(REPO / "portbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["rows"] = TINY_ROWS[name]
    return cfg


def make_checkout(dest: Path) -> Path:
    """A copy of `BENCHMARK.json` and `portbench/` with every
    configuration at the tiny scale, beside the port."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "datafusion_tpu_torch", dest / "datafusion_tpu_torch")
    for name in TINY_ROWS:
        with open(dest / "portbench" / "configs" / f"{name}.json", "w") as f:
            json.dump(tiny_cfg(name), f)
    return dest


def run_checkout(root: Path, argv: list[str], patch: str = "", device: Optional[str] = "cpu") -> tuple[int, dict, str]:
    """Run the checkout's harness on `device` (None: the cell's CUDA
    devices, as the driver runs it) in a fresh process, after the
    statements in `patch` (which may break the port underneath): exit
    code, the last line as JSON (or {}), standard error."""
    import subprocess

    code = (f"import sys, pathlib; sys.path.insert(0, {str(root)!r})\n{patch}\n"
            f"from portbench.run import main\n"
            f"sys.exit(main({argv!r}, device={device!r}, root=pathlib.Path({str(root)!r})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600,
                       env={**os.environ, **({"CUDA_VISIBLE_DEVICES": ""} if device == "cpu" else {})})
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    return p.returncode, (json.loads(last) if last.startswith("{") else {}), p.stderr
