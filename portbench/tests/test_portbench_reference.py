"""Every template of every mix, at a tiny scale on the CPU: the port's
rows (through `ExecutionContext.sql`) against the plain reference's, on
the same generated tensors, by the comparison the run uses and held to
the cell's limits; and the control, the reference in float32, fails them."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, tiny_cfg

SEED = 3_000_000_019  # above 2**31, as the driver's seeds are


def cells():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)["workloads"]


def mix_of(cell):
    with open(REPO / "portbench" / "mixes" / f"{cell['traffic']}.json") as f:
        return json.load(f)


CASES = [(c["name"], t) for c in cells() for t in mix_of(c)["templates"]]


@pytest.fixture(scope="module")
def sessions():
    return {}


def session_of(sessions, name):
    import importlib

    from portbench.core import port, traffic

    if name not in sessions:
        cell = next(c for c in cells() if c["name"] == name)
        cfg = tiny_cfg(cell["config"])
        mix = mix_of(cell)
        mesh = port.mesh(cfg.get("shards"), [torch.device("cpu")] * cell["chips"])
        made = importlib.import_module(f"portbench.makers.{cfg['maker']}").make(cfg, SEED, port.homes(mesh, "cpu"))
        ctx = port.session(made, "cpu", mesh)
        tables = made.joined("cpu")
        ref = importlib.import_module(f"portbench.reference.{mix['reference']}")
        with open(REPO / "portbench" / "limits" / f"{name}.json") as f:
            limits = json.load(f)
        sessions[name] = (tables, ctx, mix, ref, traffic.instances(mix, cfg, SEED), limits)
    return sessions[name]


@pytest.mark.parametrize("cell,template", CASES, ids=[f"{c}-{t}" for c, t in CASES])
def test_port_matches_reference(sessions, cell, template):
    from portbench.core import compare

    tables, ctx, mix, ref, pools, limits = session_of(sessions, cell)
    t = mix["templates"][template]
    for inst in pools[template]:
        got = compare.port_columns(ctx.sql(inst.sql))
        want = getattr(ref, template)(tables, inst.params, torch.float64)
        exact, ferr = compare.compare(got, want, t["ordered"])
        assert exact == 0, (inst.sql, exact)
        assert ferr <= limits["float_err"], (inst.sql, ferr)


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_control_fails(sessions, cell):
    """The reference computed in float32, put in the port's place, comes
    out not correct: it fails one of the cell's numbers."""
    from portbench.calibrate import readings

    tables, ctx, mix, ref, pools, limits = session_of(sessions, cell)

    class Cell:
        pass

    c = Cell()
    c.mix, c.reference = mix, ref
    r = readings(c, tables, ctx, pools, control=True)
    assert r["program"]["exact_mismatch"] == 0 and r["program"]["float_err"] <= limits["float_err"]
    assert r["control"]["exact_mismatch"] > 0 or r["control"]["float_err"] > limits["float_err"], r["control"]
