"""The harness as the driver runs it, at a tiny scale on the CPU: each
cell runs and is correct; the harness refuses without the cell's CUDA
devices and in a directory that holds only the benchmark; and a cell
made of new files alone (a configuration, a mix, a per-layer metric and
one BENCHMARK.json entry) is found and run with no edit to its code."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, make_checkout, run_checkout

SEED = 2_147_483_659  # above 2**31
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_and_is_correct(checkout, cell, trace):
    rc, out, err = run_checkout(checkout, ["--workload", cell, "--seed", str(SEED), "--seconds", "1", "--trace", trace])
    assert rc == 0, err[-3000:]
    assert out["correct"] is True, err[-3000:]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"failed", "exact_mismatch", "float_err"}
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace == "0":
        assert set(out["metrics"]) == {"qps", "p95_ms", "setup_s"}
    else:
        assert "plan_ms" in out["metrics"] and "qps" not in out["metrics"]
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


def test_refuses_without_cuda(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_in_a_bare_checkout(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_new_cell_from_files_alone(tmp_path):
    root = make_checkout(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "cities_tiny_skew.json").write_text(json.dumps(
        {"name": "cities_tiny_skew", "maker": "cities", "rows": {"cities": 30000}, "chips": 1, "shards": None,
         "reduced": [], "assumed": [], "guarantees": []}))
    (pb / "mixes" / "tiny_mix.json").write_text(json.dumps(
        {"what": "a later mix", "reference": "cities", "pool": 2, "keep": 16, "templates": {
            "q3": {"sql": "SELECT d, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM cities GROUP BY d ORDER BY d LIMIT 10",
                   "params": {}, "ordered": True},
            "q5": {"sql": "SELECT g, MIN(lat), MAX(lng), COUNT(lat) FROM cities WHERE lat > {LAT} GROUP BY g",
                   "params": {"LAT": {"kind": "float", "lo": 50.0, "hi": 56.0, "digits": 2}}, "ordered": False}}}))
    (pb / "metrics" / "queries_traced.py").write_text("def read(t):\n    return float(t.queries) or None\n")
    (pb / "limits" / "cities_tiny_skew.tiny.json").write_text(json.dumps({"float_err": 1000.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cities_tiny_skew", "source": "https://example.org/tiny",
                            "file": "portbench/configs/cities_tiny_skew.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "cities_tiny_skew.tiny", "config": "cities_tiny_skew", "traffic": "tiny_mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "queries_traced", "unit": "queries", "better": "higher",
                              "source": "program_counter", "layer": "front end", "moves": "qps",
                              "workloads": ["cities_tiny_skew.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    argv = ["--workload", "cities_tiny_skew.tiny", "--seed", str(SEED), "--seconds", "1"]
    rc, out, err = run_checkout(root, argv + ["--trace", "1"])
    assert rc == 0 and out["correct"] is True, err[-3000:]
    assert out["metrics"]["queries_traced"]["value"] == out["attempted"]
    rc, out, err = run_checkout(root, argv + ["--trace", "0"])
    assert rc == 0 and out["correct"] is True and out["metrics"]["qps"]["value"] > 0, err[-3000:]


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if not c.startswith("cities_2e27")])
def test_cell_on_the_card(cuda, checkout, cell):
    """The one-card cells at the tiny scale on the card, through the
    harness's own look for it: `python -m pytest portbench/tests -m card`."""
    rc, out, err = run_checkout(checkout, ["--workload", cell, "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                                device=None)
    assert rc == 0 and out["correct"] is True, err[-3000:]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
