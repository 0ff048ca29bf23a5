"""Windows and UNION over the port's mesh on the CPU:
`ExecutionContext(mesh=make_mesh(8, device="cpu"))` against the
single-card port over the same tables, and two cases against the JAX mesh
on its 8 virtual CPU devices.

A window whose expressions share one PARTITION BY hash-repartitions its
rows by those keys through K5 and runs per shard; any other window
gathers its rows and runs once. Rows reach a receiver sender by sender,
so ties inside a partition keep the single card's order, and a query
with an ORDER BY over unique keys returns the single card's bytes.
Without one, a partitioned result comes shard by shard, so rows compare
as multisets, as the JAX mesh's tests compare them. Window sums compare
within rel 1e-12 (a shard sums its partitions whole, the single card
the same rows in the same order: they agree to the bit here).
"""

from collections import Counter

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_mesh
from test_torch_join import port_table
from test_torch_window import same


@pytest.fixture(scope="module")
def ctxs():
    """(port mesh context, port single-card context) over `t` (3,000 rows,
    13 partitions, ties in `v`), `n` (NULL keys with other data stored
    under each) and the grouping-sets table `r`."""
    rng = np.random.default_rng(1)
    n = 3000
    t = ref.Table.from_pydict({"id": np.arange(n, dtype=np.int32), "g": rng.integers(0, 13, n).astype(np.int32),
                               "v": rng.integers(0, 50, n).astype(np.float64) / 4,
                               "s": np.array([["x", "y", "z"][i] for i in rng.integers(0, 3, n)], dtype=object)})
    schema = ref.Schema([ref.Field("g", ref.DataType.Int32, True), ref.Field("v", ref.DataType.Float64, False)])
    nk = ref.Table.from_arrays(schema, [np.arange(600, dtype=np.int32) % 50, rng.random(600)],
                               validity=[rng.random(600) > 0.3, None])
    r = ref.Table.from_pydict({"r": ["e", "e", "e", "w", "w", "w"], "g": ["a", "a", "b", "b", "c", "c"],
                               "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 65.0])})
    m, s = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")), port.ExecutionContext(device="cpu")
    for name, jt in (("t", t), ("n", nk), ("r", r)):
        pt = port_table(jt)
        m.register_table(name, pt)
        s.register_table(name, pt)
    return m, s


def rows(text: str) -> Counter:
    return Counter(text.splitlines())


def explain(ctx, q: str) -> str:
    return ctx.sql("EXPLAIN VERBOSE " + q).result_str()


REPART = "hash-repartition by PARTITION BY keys over K5"
GATHER = "window: gather to replicated, local evaluation"


@pytest.mark.parametrize("q,route", [
    ("SELECT id, g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn, RANK() OVER (PARTITION BY g ORDER BY v), "
     "SUM(v) OVER (PARTITION BY g ORDER BY v), COUNT(*) OVER (PARTITION BY g), MAX(v) OVER (PARTITION BY g) "
     "FROM t ORDER BY id", REPART),
    ("SELECT id, s, g, LAG(v) OVER (PARTITION BY s, g ORDER BY v DESC), "
     "FIRST_VALUE(id) OVER (PARTITION BY s, g ORDER BY v) FROM t WHERE v > 3 ORDER BY id", REPART),
    ("SELECT id, v, RANK() OVER (ORDER BY v DESC) FROM t ORDER BY id", GATHER),
    ("SELECT id, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v), ROW_NUMBER() OVER (PARTITION BY s ORDER BY id) "
     "FROM t ORDER BY id", GATHER),
])
def test_mesh_window_equals_single_card(ctxs, q, route):
    """Ties in `v` keep the single card's row order after the repartition
    (the ROW_NUMBER of tied rows follows row order), and each route is
    the one EXPLAIN shows."""
    m, s = ctxs
    assert route in explain(m, q)
    same(s.sql(q).result_str(), m.sql(q).result_str())


def test_mesh_window_without_order_by_is_a_multiset(ctxs):
    m, s = ctxs
    q = "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, id), AVG(v) OVER (PARTITION BY g) FROM t"
    assert rows(m.sql(q).result_str()) == rows(s.sql(q).result_str())
    q = "SELECT g, SUM(v) OVER (PARTITION BY g) AS s FROM t ORDER BY g, s LIMIT 80"
    same(s.sql(q).result_str(), m.sql(q).result_str())


def test_null_partition_keys_land_on_one_shard(ctxs):
    """NULL keys, each stored over other data, hash alike (their data is
    zeroed), so the NULL partition is counted whole on one shard."""
    m, s = ctxs
    q = "SELECT g, COUNT(*) OVER (PARTITION BY g), ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) FROM n"
    got = m.sql(q)
    assert rows(got.result_str()) == rows(s.sql(q).result_str())
    nulls = [ln for ln in got.result_str().splitlines() if ln.startswith("NULL")]
    assert nulls and all(ln.split("\t")[1] == str(len(nulls)) for ln in nulls)
    assert sorted(int(ln.split("\t")[2]) for ln in nulls) == list(range(1, len(nulls) + 1))


def test_mesh_rollup_union_and_except_all(ctxs):
    """ROLLUP's branches take other layouts on the mesh (the fold's output
    is partitioned, the dense and ungrouped ones replicated): UNION
    gathers them. INTERSECT / EXCEPT ALL number rows per shard after the
    repartition, then join."""
    m, s = ctxs
    for q in ("SELECT r, g, SUM(v) FROM r GROUP BY ROLLUP(r, g) ORDER BY 1, 2",
              "SELECT g, s, COUNT(*), MIN(v) FROM t GROUP BY CUBE(g, s) ORDER BY 1, 2",
              "SELECT s, g FROM t WHERE v > 5 EXCEPT ALL SELECT s, g FROM t WHERE v < 6 ORDER BY 1, 2",
              "SELECT COUNT(*) FROM (SELECT g FROM t WHERE v > 5 INTERSECT ALL SELECT g FROM t WHERE id < 900) q",
              "SELECT g, v FROM t WHERE id < 5 UNION ALL SELECT g, v FROM t WHERE id > 2995 ORDER BY 1, 2"):
        same(s.sql(q).result_str(), m.sql(q).result_str())
    q = "SELECT s, g FROM t WHERE v > 5 EXCEPT ALL SELECT s, g FROM t WHERE v < 6"
    assert rows(m.sql(q).result_str()) == rows(s.sql(q).result_str())
    q = "SELECT id, SUM(v), COUNT(*) FROM t GROUP BY ROLLUP(id) ORDER BY 1"  # K6 fold + the ungrouped branch
    plan = explain(m, q)
    assert "fused ragged-exchange fold, K6" in plan and "union: partitioned inputs gathered to replicated" in plan
    same(s.sql(q).result_str(), m.sql(q).result_str())


@pytest.mark.parametrize("q", [
    "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, id) AS rn FROM t ORDER BY g, v, rn LIMIT 80",
    "SELECT r, g, SUM(v) FROM r GROUP BY ROLLUP(r, g) ORDER BY 1, 2",
])
def test_against_the_jax_mesh(ctxs, q):
    m, _ = ctxs
    rc = ref.ExecutionContext(mesh=ref_mesh())
    rng = np.random.default_rng(1)
    n = 3000
    rc.register_table("t", ref.Table.from_pydict({
        "id": np.arange(n, dtype=np.int32), "g": rng.integers(0, 13, n).astype(np.int32),
        "v": rng.integers(0, 50, n).astype(np.float64) / 4,
        "s": np.array([["x", "y", "z"][i] for i in rng.integers(0, 3, n)], dtype=object)}))
    rc.register_table("r", ref.Table.from_pydict({"r": ["e", "e", "e", "w", "w", "w"],
                                                   "g": ["a", "a", "b", "b", "c", "c"],
                                                   "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 65.0])}))
    same(rc.sql(q).result_str(), m.sql(q).result_str())
