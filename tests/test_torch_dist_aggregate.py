"""The aggregate family over the port's mesh on the CPU:
`ExecutionContext(mesh=make_mesh(8, device="cpu"))` against the
single-card port over the same tables, and against the JAX mesh on its 8
virtual CPU devices.

A grouped aggregate holding DISTINCT, MEDIAN / percentiles or VAR /
STDDEV (holistic: a shard's partials do not merge) hash-repartitions its
rows by the group keys through K5 and aggregates each shard's groups
whole; an ungrouped one gathers its rows and aggregates once. A desugared
aggregate UDF is SUM / MIN / MAX + COUNT and takes the mesh's usual
routes (the K6 fold over a small probed key). Rows reach a receiver
sender by sender, in row-block order, so each group's rows keep the
single card's order and its sums agree to the bit; partitioned results
come shard by shard, so without an ORDER BY they compare as multisets.
Float fields against the JAX mesh compare within rel 1e-12 (`same`).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_mesh
from test_torch_aggregates import nullable
from test_torch_join import port_table
from test_torch_window import same

REPART = "aggregate: hash-repartition by group keys over K5 (ragged exchange, 8 shards)"
GATHER = "aggregate: gather to replicated, local evaluation"
FOLD = "fused ragged-exchange fold, K6"


def tables():
    """JAX tables: `t` (test_distributed's random table), `sk` (80% of
    the rows on one key, NULL keys over other data, NULL values), `m` /
    `d` / `gg` (the mesh cases of test_nulls_extract_stats and
    test_advice_r2), `tiny` (fewer rows than shards)."""
    rng = np.random.default_rng(0)
    n = 5000
    t = ref.Table.from_pydict({"k": rng.integers(0, 37, n).astype(np.int32), "v": np.round(rng.random(n) * 100, 3),
                               "w": rng.integers(-1000, 1000, n).astype(np.int64),
                               "f": rng.integers(0, 9, n) / 2.0, "g": rng.integers(1, 5001, n).astype(np.int32)})
    m = 4000
    key = np.where(rng.random(m) < 0.8, 7, rng.integers(0, 300, m)).astype(np.int32)
    sk = nullable({"k": key, "v": np.round(rng.normal(0, 50, m), 2), "i": rng.integers(0, 40, m).astype(np.int32)},
                  {"k": rng.random(m) > 0.1, "v": rng.random(m) > 0.2})
    schema = ref.Schema([ref.Field("g", ref.DataType.Utf8), ref.Field("v", ref.DataType.Float64, True)])
    med = ref.Table.from_arrays(schema, [["a", "a", "a", "b", "b"], np.array([4.0, 0.0, 2.0, 8.0, 6.0])],
                                validity=[None, np.array([True, False, True, True, True])])
    d = ref.Table.from_pydict({"g": ["a", "a", "a", "b", "b"], "v": np.array([1.0, 1.0, 3.0, 5.0, 5.0])})
    gg = ref.Table.from_pydict({"k": ["a", "a", "a", "a", "b", "b", "b"],
                                "x": np.array([1.0, 2.0, 3.0, 4.0, 10.0, 20.0, 30.0])})
    tiny = ref.Table.from_pydict({"k": np.array([3, 1, 3, 2, 1], np.int32), "v": np.array([1.0, 2.0, 2.0, 5.0, 1.0])})
    return {"t": t, "sk": sk, "m": med, "d": d, "gg": gg, "tiny": tiny}


def register_udafs(ctx, jax_side: bool):
    lib = __import__("jax.numpy", fromlist=["log"]) if jax_side else torch
    pk = ref if jax_side else port
    meta = pk.FunctionMeta("geomean", (pk.Field("x", pk.DataType.Float64, False),), pk.DataType.Float64,
                           pk.FunctionType.Aggregate)
    ctx.register_function(meta, pk.AggregateUDF(map=lib.log, combine="sum", finalize=lambda s, n: lib.exp(s / n)))
    meta = pk.FunctionMeta("hi", (pk.Field("x", pk.DataType.Float64, False),), pk.DataType.Float64,
                           pk.FunctionType.Aggregate)
    ctx.register_function(meta, pk.AggregateUDF(combine="max"))


@pytest.fixture(scope="module")
def ctxs():
    """(port mesh, port single card, JAX tables) over `tables()`, with the
    UDAFs geomean (SUM + COUNT) and hi (MAX)."""
    ts = tables()
    m, s = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")), port.ExecutionContext(device="cpu")
    for name, jt in ts.items():
        pt = port_table(jt)
        m.register_table(name, pt)
        s.register_table(name, pt)
    for c in (m, s):
        register_udafs(c, False)
    return m, s, ts


def rows(text: str) -> Counter:
    return Counter(text.splitlines())


def explain(ctx, q: str) -> str:
    return ctx.sql("EXPLAIN VERBOSE " + q).result_str()


@pytest.mark.parametrize("q,route", [
    ("SELECT k, COUNT(DISTINCT w) FROM t GROUP BY k ORDER BY k", REPART),
    ("SELECT k, MEDIAN(v), PERCENTILE(v, 0.9), PERCENTILE_DISC(v, 0.25), MIN(v), COUNT(v) FROM t GROUP BY k "
     "ORDER BY k", REPART),
    ("SELECT k, STDDEV(v), VAR_POP(v), SUM(DISTINCT w), AVG(DISTINCT v) FROM t GROUP BY k ORDER BY k", REPART),
    ("SELECT f, k, COUNT(DISTINCT w), MEDIAN(w) FROM t WHERE v > 20 GROUP BY f, k ORDER BY f, k", REPART),
    ("SELECT g, MEDIAN(v), COUNT(v) FROM m GROUP BY g ORDER BY g", REPART),
    ("SELECT g, SUM(DISTINCT v), AVG(DISTINCT v), MIN(DISTINCT v) FROM d GROUP BY g ORDER BY g", REPART),
    ("SELECT k, PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY x DESC) FROM gg GROUP BY k ORDER BY k", REPART),
    ("SELECT k, COUNT(DISTINCT i), MEDIAN(v), STDDEV(v), SUM(DISTINCT v) FROM sk GROUP BY k ORDER BY k", REPART),
    ("SELECT k, VARIANCE(v), COUNT(DISTINCT v) FROM tiny GROUP BY k ORDER BY k", REPART),
    ("SELECT COUNT(DISTINCT w), MEDIAN(v), STDDEV_SAMP(v), SUM(DISTINCT k) FROM t", GATHER),
    ("SELECT COUNT(DISTINCT i), PERCENTILE_DISC(v, 0.5), VAR_POP(v) FROM sk WHERE i > 3", GATHER),
    ("SELECT g, geomean(v), hi(v) FROM t GROUP BY g ORDER BY g", FOLD),
    ("SELECT k, geomean(v) FROM t GROUP BY k ORDER BY k", "dense sort-free group-by per shard"),
    ("SELECT geomean(v), hi(v) FROM t", "per-shard"),
])
def test_mesh_equals_single_card(ctxs, q, route):
    """Holistic aggregates see each group's rows whole, in the single
    card's order: byte-exact after ORDER BY. The UDAFs' SUMs merge
    per-shard partials (the dense merge, the fold): rel 1e-12."""
    m, s, _ = ctxs
    plan = explain(m, q)
    if route == "per-shard":
        assert "aggregate:" not in plan  # ungrouped SUM / MAX / COUNT merge their per-shard scalars
    else:
        assert route in plan
    a, b = s.sql(q).result_str(), m.sql(q).result_str()
    if route in (REPART, GATHER):
        assert a == b
    else:
        same(a, b)


@pytest.mark.parametrize("q", [
    "SELECT k, COUNT(DISTINCT i), MEDIAN(v), STDDEV(v), SUM(DISTINCT v), PERCENTILE(v, 0.3) FROM sk GROUP BY k",
    "SELECT k, f, VAR_SAMP(v), AVG(DISTINCT w) FROM t GROUP BY k, f",
    "SELECT g, MEDIAN(w), COUNT(DISTINCT k) FROM t WHERE v > 1 GROUP BY g",
])
def test_partitioned_groups_are_the_single_cards_multiset(ctxs, q):
    """Without an ORDER BY the groups come shard by shard; each is computed
    from the single card's rows in the single card's order, to the bit."""
    m, s, _ = ctxs
    assert rows(m.sql(q).result_str()) == rows(s.sql(q).result_str())


def test_skewed_and_null_keys(ctxs):
    """80% of the rows on one key and NULL keys over other data: each
    group, the NULL one included, is aggregated whole on one shard."""
    m, s, ts = ctxs
    q = "SELECT k, COUNT(i), COUNT(DISTINCT i), MEDIAN(v) FROM sk GROUP BY k"
    got = m.sql(q).result_str().splitlines()
    assert rows("\n".join(got)) == rows(s.sql(q).result_str())
    sk = ts["sk"]
    kv = np.asarray(sk.columns[0].validity)[:sk.num_rows]
    key = np.asarray(sk.columns[0].data)[:sk.num_rows]
    nulls = [ln for ln in got if ln.startswith("NULL")]
    assert len(nulls) == 1 and int(nulls[0].split("\t")[1]) == int((~kv).sum())
    hot = [ln for ln in got if ln.startswith("7\t")]
    assert len(hot) == 1 and int(hot[0].split("\t")[1]) == int(((key == 7) & kv).sum())
    assert "aggregate: dense per shard and exchange-fold declined (COUNT_DISTINCT needs each group's rows on one " \
           "shard)" in explain(m, q)


def test_routes_of_the_mesh(ctxs):
    m, _, _ = ctxs
    plan = explain(m, "SELECT k, STDDEV(v) FROM t GROUP BY k")
    assert REPART in plan and "packed-gid co-sort (int[0,36])" in plan
    assert "VAR/STDDEV squared deviations in a second K2 sorted pass" in plan
    assert "the local co-sort + segmented reduce per shard" in explain(m, "SELECT f, MEDIAN(v) FROM t GROUP BY f")
    # non-holistic aggregates keep their routes
    assert "dense sort-free group-by per shard" in explain(m, "SELECT k, SUM(v), COUNT(*) FROM t GROUP BY k")
    assert FOLD in explain(m, "SELECT g, geomean(v) FROM t GROUP BY g")


@pytest.mark.parametrize("q,exact", [
    ("SELECT k, COUNT(DISTINCT w) FROM t GROUP BY k ORDER BY k", True),
    ("SELECT g, MEDIAN(v), COUNT(v) FROM m GROUP BY g ORDER BY g", True),
    ("SELECT g, SUM(DISTINCT v), AVG(DISTINCT v), MIN(DISTINCT v) FROM d GROUP BY g ORDER BY g", True),
    ("SELECT k, PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY x DESC) FROM gg GROUP BY k ORDER BY k", True),
    ("SELECT k, STDDEV(v), VAR_POP(v), MEDIAN(v) FROM t GROUP BY k ORDER BY k", False),
    ("SELECT g, geomean(v) FROM t GROUP BY g ORDER BY g", False),
])
def test_against_the_jax_mesh(ctxs, q, exact):
    m, _, ts = ctxs
    rc = ref.ExecutionContext(mesh=ref_mesh())
    for name, jt in ts.items():
        rc.register_table(name, jt)
    register_udafs(rc, True)
    a, b = rc.sql(q).result_str(), m.sql(q).result_str()
    if exact:
        assert a == b
    else:
        same(a, b)


def test_null_keys_are_one_group_on_the_mesh():
    """The JAX mesh hashes a NULL key's stored data, so NULL keys over
    different data land on different shards and its repartition aggregate
    returns one NULL group per shard (ROADMAP Queue 3). The port zeroes
    the data under a NULL key before the hash: SQL's one NULL group."""
    k = np.array([1, 5, 7, 9, 11, 13, 1, 2], np.int32)
    kv = np.array([True, False, False, False, False, False, True, True])
    pt = port_table(nullable({"k": k, "v": np.arange(8.0)}, {"k": kv}))
    m = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    m.register_table("t", pt)
    q = "SELECT k, COUNT(DISTINCT v), MEDIAN(v), COUNT(v) FROM t GROUP BY k"
    assert rows(m.sql(q).result_str()) == rows("1\t2\t3.0\t2\n2\t1\t7.0\t1\nNULL\t5\t3.0\t5\n")
