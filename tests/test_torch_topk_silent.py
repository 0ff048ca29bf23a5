"""ORDER BY ... LIMIT and the silent-wrong-answer checks through the torch
port against the JAX package.

tests/test_topk.py's queries (NULL placement under ORDER BY nv [DESC]
LIMIT, k larger than the matches, multi-key orders over dictionary and
integer keys, tie order) and tests/test_silent_wrong.py's cases (SUM /
AVG over Utf8 or Boolean and SUM of a date are PlanErrors; integer
division and modulo by zero give NULL; float division keeps IEEE) run on
the CPU through both packages, on one device and on a mesh of 8 shards:
`result_str` is equal byte for byte, and where the JAX package raises
PlanError the port raises its PlanError.
"""

import datetime

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import PlanError as RefPlanError
from datafusion_tpu.parallel.mesh import make_mesh as ref_make_mesh
from datafusion_tpu_torch.errors import PlanError


def _contexts(data, mesh=False):
    r = ref.ExecutionContext(mesh=ref_make_mesh() if mesh else None)
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")) if mesh else port.ExecutionContext(device="cpu")
    for name, cols in data.items():
        r.register_table(name, ref.Table.from_pydict(dict(cols)))
        p.register_table(name, port.Table.from_pydict(dict(cols), device="cpu"))
    return r, p


def _topk_data():
    rng = np.random.default_rng(3)
    n = 5000
    v = rng.random(n).astype(np.float64) * 200 - 100
    a = rng.integers(-1000, 1000, n).astype(np.int64)
    nv = v.copy()
    nv[rng.random(n) < 0.1] = np.nan
    return {"t": {"a": a, "v": v, "s": np.array([f"s{int(x) % 37:02d}" for x in a], dtype=object), "nv": nv}}


def _multi_data():
    rng = np.random.default_rng(7)
    n = 4000
    a = rng.integers(-50, 50, n).astype(np.int64)
    s = np.array([f"g{int(x) % 7}" for x in a], dtype=object)
    ns = s.copy()
    ns[rng.random(n) < 0.15] = None
    return {"t": {"a": a, "v": rng.random(n), "s": s, "ns": list(ns)}}


TOPK = [
    "SELECT a, v FROM t ORDER BY v LIMIT 25",
    "SELECT a, v FROM t ORDER BY v DESC LIMIT 25",
    "SELECT a FROM t ORDER BY a LIMIT 40",
    "SELECT a FROM t ORDER BY a DESC LIMIT 40",
    "SELECT s, a FROM t ORDER BY s LIMIT 15",
    "SELECT a, nv FROM t WHERE a > 500 ORDER BY nv LIMIT 30",
    "SELECT a, nv FROM t WHERE a > 500 ORDER BY nv DESC LIMIT 30",
    "SELECT a FROM t WHERE a > 990 ORDER BY a LIMIT 4000",  # k > matches
]
MULTI = [
    "SELECT a, s FROM t ORDER BY s, a LIMIT 25",
    "SELECT a, s FROM t ORDER BY s DESC, a LIMIT 25",
    "SELECT a, s FROM t ORDER BY s, a DESC LIMIT 25",
    "SELECT a, s, v FROM t ORDER BY s, a, v DESC LIMIT 25",
    "SELECT a, s FROM t WHERE a > 0 ORDER BY a DESC, s LIMIT 30",
    "SELECT a, ns FROM t ORDER BY ns, a LIMIT 60",  # NULL dictionary keys
    "SELECT a, ns FROM t ORDER BY ns DESC, a DESC LIMIT 60",
]


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
@pytest.mark.parametrize("data,queries", [(_topk_data, TOPK), (_multi_data, MULTI)], ids=["one_key", "multi_key"])
def test_topk_matches_jax(data, queries, mesh):
    r, p = _contexts(data(), mesh)
    for sql in queries:
        assert p.sql(sql).result_str() == r.sql(sql).result_str(), sql


def test_topk_tie_stability():
    r, p = _contexts({
        "t": {"k": np.array([1, 1, 0, 1, 0, 0], np.int64), "row": np.arange(6, dtype=np.int64)},
        "u": {"k1": np.array([1, 1, 0, 1, 0, 0], np.int32), "k2": np.array([2, 2, 9, 2, 9, 9], np.int32),
              "row": np.arange(6, dtype=np.int64)},
    })
    for sql, rows in (("SELECT k, row FROM t ORDER BY k LIMIT 4", [2, 4, 5, 0]),
                      ("SELECT row FROM u ORDER BY k1, k2 LIMIT 5", [2, 4, 5, 0, 1])):
        assert [row["row"] for row in p.sql(sql).to_pylist()] == rows
        assert p.sql(sql).result_str() == r.sql(sql).result_str()


def _silent_data():
    return {
        "t": {"s": ["a", "b", "c", "d"], "flag": [True, False, True, False], "v": [1.0, None, 3.0, None],
              "k": [1, None, 3, 7], "a": [10, 20, 30, 40], "b": [2, 0, 5, 0], "f": [1.0, 2.0, 4.0, 8.0]},
        "dt": {"d": [datetime.date(2020, 1, 1)]},
    }


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
@pytest.mark.parametrize("sql", [
    "SELECT SUM(s) FROM t",
    "SELECT AVG(s) FROM t",
    "SELECT SUM(flag) FROM t",
    "SELECT AVG(flag) FROM t",
    "SELECT s, SUM(s) FROM t GROUP BY s",
    "SELECT SUM(d) FROM dt",
])
def test_non_numeric_sums_are_plan_errors(sql, mesh):
    r, p = _contexts(_silent_data(), mesh)
    with pytest.raises(RefPlanError):
        r.sql(sql)
    with pytest.raises(PlanError):
        p.sql(sql)


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
def test_silent_wrong_cases_match_jax(mesh):
    # the reference is the JAX package on one device: its mesh raises on a
    # literal zero divisor (`a / 0`: a rank-0 validity in its shard_map)
    r, _ = _contexts(_silent_data())
    _, p = _contexts(_silent_data(), mesh)
    for sql, want in (
        ("SELECT MIN(s), MAX(s) FROM t", '"a"\t"d"\n'),
        ("SELECT SUM(v), COUNT(v), AVG(v) FROM t", "4.0\t2\t2.0\n"),
        ("SELECT SUM(k), COUNT(k) FROM t", "11\t3\n"),
        ("SELECT a / b FROM t", "5\nNULL\n6\nNULL\n"),
        ("SELECT a % b FROM t", "0\nNULL\n0\nNULL\n"),
        ("SELECT a / 0 FROM t", "NULL\n" * 4),
        ("SELECT a % 0 FROM t", "NULL\n" * 4),
        ("SELECT a / 2 FROM t", "5\n10\n15\n20\n"),
        ("SELECT f / 0.0 FROM t", "inf\n" * 4),
        ("SELECT k / b FROM t", "0\nNULL\n0\nNULL\n"),
        ("SELECT s, a / b FROM t WHERE b = 0 OR a > 25 ORDER BY s", '"b"\tNULL\n"c"\t6\n"d"\tNULL\n'),
    ):
        got = p.sql(sql).result_str()
        assert got == r.sql(sql).result_str() == want, sql


def test_from_pydict_nulls_match_jax():
    r, p = _contexts({"n": {"v": [None, None]}, "s": {"s": ["x", None, "y"]},
                      "d": {"d": np.array(["2020-01-01", "NaT", "2020-01-03"], dtype="datetime64[D]")}})
    for sql in ("SELECT COUNT(v) FROM n", "SELECT s FROM s", "SELECT COUNT(s) FROM s", "SELECT COUNT(d), MIN(d) FROM d",
                "DESCRIBE n"):
        assert p.sql(sql).result_str() == r.sql(sql).result_str(), sql
