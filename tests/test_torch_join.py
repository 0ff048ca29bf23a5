"""Joins: the JAX package (the reference) vs the torch port on the CPU.

The SQL of tests/test_join_strategies.py, tests/test_outer_joins.py,
tests/test_join_domain_narrowing.py and the join statements of
tests/test_empty_tables.py, tests/test_sql_e2e.py, tests/test_types.py
and tests/test_overflow_retry.py run through
`datafusion_tpu.ExecutionContext()` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
columns (each JAX table carried into the port with
`Table.from_reference_arrays`), and `result_str()` must match byte for
byte: rows in the same order too where the statement has no ORDER BY,
which holds the port's strategy ladder to the JAX package's (the swapped
direct join emits rows in the right side's order, every other strategy
in the left side's). Float SUM/AVG columns compare at rtol=1e-12.

Unit cases feed the same numpy inputs to ops/join.py of both packages.
The JAX package's joins match a NULL key against the build value stored
under it (ROADMAP Queue 3); the NULL-key cases here assert SQL's answer.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.ops import join as ref_join
from datafusion_tpu_torch.ops import join as port_join


def port_table(jt):
    return port.Table.from_reference_arrays(
        [port.Field(f.name, port.DataType[f.dtype.name], f.nullable) for f in jt.schema.fields],
        [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
        [c.dictionary for c in jt.columns],
        device="cpu",
        num_rows=jt.num_rows,
    )


def register_both(r, p, tables: dict) -> None:
    """Register each {name: pydict} as a JAX table in `r` and the same
    columns in `p`."""
    for name, data in tables.items():
        jt = ref.Table.from_pydict(data)
        r.register_table(name, jt)
        p.register_table(name, port_table(jt))


def compare(a: str, b: str, tol_cols=()) -> None:
    """Byte-exact, except columns in `tol_cols` (float SUM/AVG) at rtol 1e-12."""
    if not tol_cols:
        assert a == b
        return
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for ra, rb in zip(la, lb):
        fa, fb = ra.split("\t"), rb.split("\t")
        assert len(fa) == len(fb)
        for j, (x, y) in enumerate(zip(fa, fb)):
            if j in tol_cols and x != y and "NULL" not in (x, y):
                assert math.isclose(float(x), float(y), rel_tol=1e-12), (j, x, y)
            else:
                assert x == y, (j, x, y)


def _strategy_tables():
    """tests/test_join_strategies.py's tables, under distinct names."""
    rng = np.random.default_rng(0)
    n, d = 5000, 512
    p = {"k": rng.integers(0, d, n).astype(np.int32), "x": rng.random(n).astype(np.float32)}
    bk = np.arange(d, dtype=np.int32)
    state = rng.bit_generator.state
    b = {"k": bk, "w": rng.random(d).astype(np.float32)}
    rng.bit_generator.state = state  # _ctx(dup=True) draws its extra keys from here
    bk2 = np.concatenate([bk, rng.integers(0, d, d // 4).astype(np.int32)])
    bd = {"k": bk2, "w": rng.random(len(bk2)).astype(np.float32)}
    rng3 = np.random.default_rng(3)
    sp = {"k": rng3.integers(0, 1 << 30, 100).astype(np.int32)}
    sb = {"k": rng3.integers(0, 1 << 30, 50).astype(np.int32), "w": rng3.random(50).astype(np.float32)}
    rng8 = np.random.default_rng(8)
    lu = {"ok": np.arange(500, dtype=np.int32), "w": rng8.random(500)}
    rf = {"fk": rng8.integers(0, 500, 4000).astype(np.int32), "v": rng8.random(4000)}
    return {
        "p": p, "b": b, "bd": bd, "sp": sp, "sb": sb, "lu": lu, "rf": rf,
        "p2": {"k": np.array([1, 2], np.int32)},
        "b3": {"k": np.array([1, 1, 1, 2], np.int32), "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32)},
        "p3": {"k": np.array([5, 1, 7, 1], np.int32)},
        "b4": {"k": np.array([1, 5, 9], np.int32), "w": np.array([10.0, 50.0, 90.0], np.float32)},
        "ps": {"s": np.array(["b", "a", "c", "a"], dtype=object)},
        "ds": {"s": np.array(["a", "b"], dtype=object), "v": np.array([1.0, 2.0], np.float32)},
        "ta": {"a": np.array([1, 2, 3], np.int32)},
        "ub": {"b": np.array([10.0, 20.0], np.float32)},
        "a3": {"c1": ["x", "x", "y", "z", "x"], "c2": np.array([1, 1, 2, 3, 1], np.int32),
               "c3": np.array([7.0, 8.0, 7.0, 7.0, 9.0]), "v": np.arange(5, dtype=np.int32)},
        "b3k": {"d1": ["x", "y", "z", "x"], "d2": np.array([1, 2, 3, 1], np.int32),
                "d3": np.array([8.0, 7.0, 9.0, 9.0]), "w": np.array([10, 20, 30, 40], np.int32)},
        "a2": {"c1": ["x", "x", "y", "z"], "c2": ["p", "q", "p", "q"], "v": np.arange(4, dtype=np.int32)},
        "b2": {"d1": ["x", "y", "z"], "d2": ["q", "p", "z"], "w": np.array([10, 20, 30], np.int32)},
        "na": {"k": np.array([1, 1, 2, 3], np.int32), "v": np.array([5.0, 50.0, 5.0, 5.0])},
        "nb": {"k": np.array([1, 2, 9], np.int32), "w": np.array([10.0, 1.0, 1.0])},
        "neg": {"k": np.array([-3, -1, 0, 2, 7], np.int32)},
        "negb": {"k": np.array([-3, 0, 2], np.int32), "w": np.array([1.0, 2.0, 3.0], np.float32)},
        # tests/test_outer_joins.py, tests/test_sql_e2e.py
        "people": {"pid": np.array([1, 2, 3], np.int32), "name": ["ann", "bob", "cat"]},
        "orders": {"oid": np.array([10, 11, 12, 13], np.int32), "pid": np.array([3, 1, 3, 9], np.int32),
                   "amount": np.array([5.0, 7.5, 2.5, 99.0], np.float64)},
        "fa": {"k": np.array([1, 2], np.int32), "x": ["p", "q"]},
        "fb": {"k": np.array([7, 8, 9], np.int32), "y": ["r", "s", "t"]},
        "emp": {"id": np.array([1, 2, 3], np.int32), "boss": np.array([3, 3, 3], np.int32),
                "name": ["ann", "bob", "cat"]},
        # tests/test_empty_tables.py
        "e": {"k": np.array([], np.int32), "v": np.array([], np.float64)},
        "t2": {"k": np.array([1, 2], np.int32)},
        # tests/test_types.py:78 (NULL v), tests/test_overflow_retry.py:21
        "tv": {"k": np.array([1, 2, 3, 4], np.int32), "v": [1.0, None, 3.0, 3.0]},
        "ol": {"k": np.zeros(3000, np.int32), "x": np.arange(3000, dtype=np.int32)},
        "orr": {"k": np.zeros(20, np.int32), "y": np.arange(20, dtype=np.int32)},
        # mixed key widths: i32 against i64, f32 against f64
        "mi": {"k": np.array([1, 2, 3, 2], np.int32), "f": np.array([0.5, -0.0, 2.5, 7.0], np.float32)},
        "mj": {"k": np.array([2, 3, 5], np.int64), "f": np.array([0.0, 2.5, 9.0])},
        # two int keys (a sort join) over overlapping ranges: a in [0, 99] and [50, 299]
        "ia": {"a": np.arange(100, dtype=np.int32), "b": np.arange(100, dtype=np.int32) % 3},
        "ib": {"a": np.arange(50, 300, dtype=np.int32), "b": np.arange(50, 300, dtype=np.int32) % 2},
    }


def _narrow_tables(nd):
    """tests/test_join_domain_narrowing.py's tables."""
    rng = np.random.default_rng(3)
    n, kdom = 1 << 13, 1 << 16
    kk = rng.integers(0, kdom, n).astype(np.int32)
    lat = (rng.random(n) * 40 + 30).astype(np.float32)
    w = rng.random(nd).astype(np.float32)
    return {"big": {"k": kk, "lat": lat}, "dim": {"pk": np.arange(nd, dtype=np.int32), "w": w}}


@pytest.fixture(scope="module")
def contexts():
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    register_both(r, p, _strategy_tables())
    n1 = _narrow_tables(1 << 11)
    n2 = _narrow_tables(1000)
    register_both(r, p, {"big": n1["big"], "dim": n1["dim"], "dim1k": n2["dim"]})
    return r, p


JOINS = [
    "SELECT p.k, p.x, b.w FROM p JOIN b ON p.k = b.k",
    "SELECT p.k, b.w FROM p LEFT JOIN b ON p.k = b.k",
    "SELECT p.k, b.w FROM p JOIN b ON p.k = b.k WHERE p.x > 0.5",
    "SELECT p.k, COUNT(p.x), MAX(b.w) FROM p JOIN b ON p.k = b.k GROUP BY p.k",
]
# (sql, float SUM/AVG columns at rtol 1e-12)
CASES = (
    [(q, ()) for q in JOINS]
    + [(q.replace(" b ", " bd ").replace("b.", "bd."), ()) for q in JOINS]
    + [
        ("SELECT p2.k, b3.v FROM p2 JOIN b3 ON p2.k = b3.k", ()),
        ("SELECT p3.k, b4.w FROM p3 JOIN b4 ON p3.k = b4.k", ()),
        ("SELECT ps.s, ds.v FROM ps JOIN ds ON ps.s = ds.s", ()),
        ("SELECT ta.a, ub.b FROM ta CROSS JOIN ub", ()),
        ("SELECT ta.a, SUM(ub.b) FROM ta CROSS JOIN ub WHERE ta.a > 1 GROUP BY ta.a", (1,)),
        ("SELECT a3.v, b3k.w FROM a3 JOIN b3k ON a3.c1 = b3k.d1 AND a3.c2 = b3k.d2 AND a3.c3 = b3k.d3 ORDER BY v", ()),
        ("SELECT a3.v, b3k.w FROM a3 LEFT JOIN b3k ON a3.c1 = b3k.d1 AND a3.c2 = b3k.d2 AND a3.c3 = b3k.d3 "
         "ORDER BY v", ()),
        ("SELECT a2.v, b2.w FROM a2 JOIN b2 ON a2.c1 = b2.d1 AND a2.c2 = b2.d2 ORDER BY v", ()),
        ("SELECT a2.v, b2.w FROM a2 JOIN b2 ON a2.c1 = b2.d1 AND a2.c2 = b2.d2", ()),
        ("SELECT na.v, nb.w FROM na JOIN nb ON na.k = nb.k AND na.v < nb.w ORDER BY v", ()),
        ("SELECT na.v, nb.w FROM na JOIN nb ON na.v > nb.w ORDER BY v, w", ()),
        ("SELECT sp.k, sb.w FROM sp JOIN sb ON sp.k = sb.k", ()),
        ("SELECT neg.k, negb.w FROM neg JOIN negb ON neg.k = negb.k", ()),
        ("SELECT w, v FROM lu JOIN rf ON lu.ok = rf.fk", ()),
        ("SELECT w, v FROM lu JOIN rf ON lu.ok = rf.fk ORDER BY v LIMIT 5", ()),
        ("SELECT w, v FROM lu LEFT JOIN rf ON lu.ok = rf.fk", ()),
        # tests/test_outer_joins.py
        ("SELECT orders.oid, people.name FROM orders LEFT JOIN people ON orders.pid = people.pid ORDER BY oid", ()),
        ("SELECT orders.oid, people.name FROM orders LEFT JOIN people ON orders.pid = people.pid", ()),
        ("SELECT orders.oid, people.name FROM orders RIGHT JOIN people ON orders.pid = people.pid ORDER BY name", ()),
        ("SELECT orders.oid, people.name FROM orders RIGHT JOIN people ON orders.pid = people.pid", ()),
        ("SELECT orders.oid, people.name FROM orders FULL JOIN people ON orders.pid = people.pid", ()),
        ("SELECT people.name, orders.oid FROM people FULL OUTER JOIN orders ON people.pid = orders.pid", ()),
        ("SELECT COUNT(people.name), COUNT(orders.oid) FROM orders FULL JOIN people ON orders.pid = people.pid", ()),
        ("SELECT fa.x, fb.y FROM fa FULL JOIN fb ON fa.k = fb.k", ()),
        ("SELECT COUNT(people.name), COUNT(orders.oid) FROM orders LEFT JOIN people ON orders.pid = people.pid", ()),
        ("SELECT e.name, m.name FROM emp AS e JOIN emp AS m ON e.boss = m.id ORDER BY name", ()),
        ("SELECT e.name, m.name FROM emp AS e JOIN emp AS m ON e.boss = m.id", ()),
        # tests/test_sql_e2e.py:232-240
        ("SELECT people.name, orders.amount FROM orders JOIN people ON orders.pid = people.pid ORDER BY amount", ()),
        ("SELECT COUNT(*) FROM orders JOIN people ON orders.pid = people.pid", ()),
        # tests/test_empty_tables.py:43-46
        ("SELECT t2.k FROM t2 JOIN e ON t2.k = e.k", ()),
        ("SELECT t2.k, e.v FROM t2 LEFT JOIN e ON t2.k = e.k ORDER BY k", ()),
        ("SELECT e.k, t2.k FROM e LEFT JOIN t2 ON e.k = t2.k", ()),
        ("SELECT t2.k, e.v FROM t2 FULL JOIN e ON t2.k = e.k", ()),
        ("SELECT e.v, t2.k FROM e FULL JOIN t2 ON e.k = t2.k", ()),
        ("SELECT t2.k, e.v FROM t2 RIGHT JOIN e ON t2.k = e.k", ()),
        # tests/test_types.py:78, tests/test_overflow_retry.py:21
        ("SELECT tv.k FROM tv JOIN tv2 ON tv.k = tv2.k WHERE tv.v IS NOT DISTINCT FROM tv2.v ORDER BY 1", ()),
        ("SELECT COUNT(*) FROM ol JOIN orr ON ol.k = orr.k", ()),
        # mixed key widths
        ("SELECT mi.k, mj.f FROM mi JOIN mj ON mi.k = mj.k", ()),
        ("SELECT ia.a, COUNT(ib.b) FROM ia JOIN ib ON ia.a = ib.a AND ia.b = ib.b GROUP BY ia.a", ()),
        # tests/test_join_domain_narrowing.py
        ("SELECT big.k, COUNT(big.lat), MAX(dim.w) FROM big JOIN dim ON big.k = dim.pk WHERE big.lat > 40 "
         "GROUP BY k ORDER BY k", ()),
        ("SELECT big.k, COUNT(big.lat) FROM big LEFT JOIN dim ON big.k = dim.pk GROUP BY k ORDER BY k LIMIT 5", ()),
        ("SELECT big.k, SUM(big.lat), COUNT(big.lat) FROM big JOIN dim1k ON big.k = dim1k.pk GROUP BY k ORDER BY k",
         (1,)),
        ("SELECT big.k, SUM(big.lat), COUNT(big.lat) FROM big JOIN dim1k ON big.k = dim1k.pk GROUP BY k", (1,)),
        ("SELECT big.lat, dim1k.w FROM big JOIN dim1k ON big.k = dim1k.pk", ()),
    ]
)


@pytest.fixture(scope="module", autouse=True)
def _self_join_table(contexts):
    r, p = contexts
    r.register_table("tv2", r._tables["tv"])
    p.register_table("tv2", p.table("tv"))


@pytest.mark.parametrize("sql,tol", CASES, ids=[c[0] for c in CASES])
def test_join_parity(contexts, sql, tol):
    r, p = contexts
    compare(p.sql(sql).result_str(), r.sql(sql).result_str(), tol)


# (sql, the run-time route of each join, in plan order)
ROUTES = [
    (JOINS[0], ("join: direct",)),
    (JOINS[1], ("join: direct",)),
    ("SELECT p.k, bd.w FROM p JOIN bd ON p.k = bd.k", ("join: sort",)),
    ("SELECT w, v FROM lu JOIN rf ON lu.ok = rf.fk", ("join: direct (swapped: build=left side)",)),
    ("SELECT w, v FROM lu LEFT JOIN rf ON lu.ok = rf.fk", ("join: sort",)),
    ("SELECT ps.s, ds.v FROM ps JOIN ds ON ps.s = ds.s", ("join: direct",)),
    ("SELECT sp.k, sb.w FROM sp JOIN sb ON sp.k = sb.k", ("join: sort",)),
    ("SELECT ta.a, ub.b FROM ta CROSS JOIN ub", ("join: sort",)),
    ("SELECT orders.oid, people.name FROM orders FULL JOIN people ON orders.pid = people.pid", ("join: sort",)),
]


def test_mixed_float_width_keys(contexts):
    """An f32 key against an f64 key compares their values: the JAX
    package compares their bit images and matches only 0.0 (ROADMAP
    Queue 3)."""
    _, p = contexts
    assert p.sql("SELECT mi.f, mj.k FROM mi JOIN mj ON mi.f = mj.f").result_str() == "-0.0\t2\n2.5\t3\n"


@pytest.mark.parametrize("sql,routes", ROUTES, ids=[c[0] for c in ROUTES])
def test_join_routes(contexts, sql, routes):
    """Each strategy of the ladder is taken where the JAX package's retry
    ladder ends (the parity cases above hold their row order)."""
    _, p = contexts
    assert p.sql(sql).routes == routes


@pytest.mark.parametrize(
    "sql,note",
    [
        (JOINS[0], "join: direct (dense build domain [0, 512)"),
        ("SELECT sp.k, sb.w FROM sp JOIN sb ON sp.k = sb.k", "join: sort ("),
        ("SELECT ps.s, ds.v FROM ps JOIN ds ON ps.s = ds.s", "join: direct (dense build domain [0, 3)"),
        ("SELECT w, v FROM lu JOIN rf ON lu.ok = rf.fk", "direct (swapped: build=left side) (dense build domain"),
        ("SELECT big.k, COUNT(big.lat), MAX(dim.w) FROM big JOIN dim ON big.k = dim.pk WHERE big.lat > 40 "
         "GROUP BY k ORDER BY k", ",2047]"),
        ("SELECT big.k, SUM(big.lat), COUNT(big.lat) FROM big JOIN dim1k ON big.k = dim1k.pk GROUP BY k",
         "aggregate: dense sort-free group-by (int[11,999])"),
    ],
)
def test_join_explain(contexts, sql, note):
    _, p = contexts
    assert note in p.sql("EXPLAIN VERBOSE " + sql).result_str()


def test_left_join_does_not_narrow(contexts):
    _, p = contexts
    txt = p.sql("EXPLAIN VERBOSE SELECT big.k, COUNT(big.lat) FROM big LEFT JOIN dim ON big.k = dim.pk "
                "GROUP BY k").result_str()
    assert ",2047]" not in txt and "int[11,65534]" in txt


def test_inner_sort_join_publishes_key_range(contexts):
    """An INNER sort join bounds its keys by both sides' scanned ranges."""
    _, p = contexts
    txt = p.sql("EXPLAIN VERBOSE SELECT ia.a, COUNT(ib.b) FROM ia JOIN ib ON ia.a = ib.a AND ia.b = ib.b "
                "GROUP BY ia.a").result_str()
    assert "join: sort" in txt and "int[50,99]" in txt


# ---------------------------------------------------------------------------
# NULL keys never match (the JAX package's joins read key data only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def null_ctx():
    p = port.ExecutionContext(device="cpu")
    p.register_table("a", port.Table.from_pydict({"k": [1, None, 3], "v": [10, 20, 30]}, device="cpu"))
    p.register_table("b", port.Table.from_pydict({"k": [1, None, 0], "s": ["x", "y", "z"]}, device="cpu"))
    p.register_table("b2", port.Table.from_pydict({"k": [1, 5, 0], "s": ["x", "y", "z"]}, device="cpu"))
    return p


def test_null_keys_inner(null_ctx):
    assert null_ctx.sql("SELECT a.k, a.v, b.s FROM a JOIN b ON a.k = b.k").result_str() == '1\t10\t"x"\n'


def test_null_keys_left(null_ctx):
    assert null_ctx.sql("SELECT a.k, a.v, b2.s FROM a LEFT JOIN b2 ON a.k = b2.k").result_str() == (
        '1\t10\t"x"\nNULL\t20\tNULL\n3\t30\tNULL\n'
    )


@pytest.mark.parametrize("jt", ["JOIN", "LEFT JOIN", "FULL JOIN", "RIGHT JOIN"])
def test_null_keys_sort_join(null_ctx, jt):
    """The sort join (two keys) leaves NULL keys out of the match too."""
    want = {
        "JOIN": '1\t"x"\n',
        "LEFT JOIN": '1\t"x"\nNULL\tNULL\n3\tNULL\n',
        "FULL JOIN": '1\t"x"\nNULL\tNULL\n3\tNULL\nNULL\t"y"\nNULL\t"z"\n',
        "RIGHT JOIN": '1\t"x"\nNULL\t"y"\nNULL\t"z"\n',
    }[jt]
    got = null_ctx.sql(f"SELECT a.k, b.s FROM a {jt} b ON a.k = b.k AND a.k = b.k").result_str()
    assert got == want


@pytest.mark.xfail(
    strict=True,
    reason="reference fault inherited from the copied planner (ROADMAP Queue 3): NOT IN (subquery) plans as "
    "a LEFT anti-join and ignores a NULL in the subquery, which makes every NOT IN NULL or false",
)
def test_null_keys_not_in(null_ctx):
    assert null_ctx.sql("SELECT a.v FROM a WHERE a.k NOT IN (SELECT k FROM b)").result_str() == ""


# ---------------------------------------------------------------------------
# ops/join.py of both packages on the same numpy inputs
# ---------------------------------------------------------------------------


def _unit_inputs(seed, n_p=300, n_b=120, dom=40, dup=True):
    rng = np.random.default_rng(seed)
    pk = rng.integers(-5, dom + 5, n_p).astype(np.int32)
    bk = rng.integers(0, dom, n_b).astype(np.int32) if dup else rng.permutation(dom)[:n_b].astype(np.int32)
    return pk, rng.random(n_p) > 0.2, bk, rng.random(bk.shape[0]) > 0.1


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_join_indices_equal(keep, seed):
    pk, ps, bk, bs = _unit_inputs(seed)
    pi, bi, sel, matched, total, bm = ref_join.join_indices(
        [jnp.asarray(pk)], jnp.asarray(ps), [jnp.asarray(bk)], jnp.asarray(bs), 4096,
        keep_unmatched_probe=keep, want_build_matched=True,
    )
    t = torch.from_numpy
    qi, qb, qm, qbm = port_join.join_indices([(t(pk), None)], t(ps), [(t(bk), None)], t(bs),
                                             keep_unmatched_probe=keep, want_build_matched=True)
    total = int(total)
    assert qi.shape[0] == total
    np.testing.assert_array_equal(qi.numpy(), np.asarray(pi)[:total])
    np.testing.assert_array_equal(qm.numpy(), np.asarray(matched)[:total])
    m = qm.numpy()
    np.testing.assert_array_equal(qb.numpy()[m], np.asarray(bi)[:total][m])
    np.testing.assert_array_equal(qbm.numpy(), np.asarray(bm))


def test_join_indices_float_and_two_keys():
    """-0.0 matches 0.0; two 32-bit keys pack as the JAX package packs them."""
    rng = np.random.default_rng(5)
    pf = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, 7.0], np.float32), 200)
    bf = np.array([0.0, 1.5, 7.0, 3.0, -2.25], np.float32)
    pk2, bk2 = rng.integers(0, 4, 200).astype(np.int32), np.array([0, 1, 2, 3, 3], np.int32)
    ps, bs = np.ones(200, bool), np.ones(5, bool)
    for pkeys, bkeys in (([pf], [bf]), ([pf, pk2], [bf, bk2])):
        pi, bi, sel, matched, total = ref_join.join_indices(
            [jnp.asarray(k) for k in pkeys], jnp.asarray(ps), [jnp.asarray(k) for k in bkeys], jnp.asarray(bs), 1024
        )
        qi, qb, qm = port_join.join_indices([(torch.from_numpy(k), None) for k in pkeys], torch.from_numpy(ps),
                                            [(torch.from_numpy(k), None) for k in bkeys], torch.from_numpy(bs))
        total = int(total)
        np.testing.assert_array_equal(qi.numpy(), np.asarray(pi)[:total])
        np.testing.assert_array_equal(qb.numpy(), np.asarray(bi)[:total])


@pytest.mark.parametrize("keep", [False, True])
def test_direct_index_join_equal(keep):
    pk, ps, bk, bs = _unit_inputs(2, dup=False, n_b=35)
    rng = np.random.default_rng(9)
    wd, wv = rng.random(bk.shape[0]), rng.random(bk.shape[0]) > 0.3
    xi = rng.integers(-100, 100, bk.shape[0]).astype(np.int64)
    cols_j = [(jnp.asarray(wd), jnp.asarray(wv)), (jnp.asarray(xi), None)]
    out_j, m_j, dups_j = ref_join.direct_index_join(jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(bk),
                                                    jnp.asarray(bs), cols_j, 0, 40, matched_validity=keep)
    t = torch.from_numpy
    out_p, m_p, dups_p = port_join.direct_index_join((t(pk), None), t(ps), (t(bk), None), t(bs),
                                                     [(t(wd), t(wv)), (t(xi), None)], 0, 40, matched_validity=keep)
    assert int(dups_j) == dups_p == 0
    m = np.asarray(m_j)
    np.testing.assert_array_equal(m_p.numpy(), m)
    for (dj, vj), (dp, vp) in zip(out_j, out_p):
        np.testing.assert_array_equal(dp.numpy()[m], np.asarray(dj)[m])
        if vj is None:
            assert vp is None
        else:
            # off the matched rows the JAX table's sentinel slot holds
            # some unselected build row's validity: compared where matched
            np.testing.assert_array_equal(vp.numpy()[m], np.asarray(vj)[m])
            assert not vp.numpy()[~m].any()
    # repeated build keys: both count the slots taken more than once
    pk, ps, bk, bs = _unit_inputs(3)
    _, _, dups_j = ref_join.direct_index_join(jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(bk), jnp.asarray(bs),
                                              cols_j[:0], 0, 40)
    assert port_join.direct_index_join((t(pk), None), t(ps), (t(bk), None), t(bs), [], 0, 40)[2] == int(dups_j) > 0


def test_full_merge_tail_equal():
    pk, ps, bk, bs = _unit_inputs(4)
    rng = np.random.default_rng(4)
    pd_, bd_ = rng.random(pk.shape[0]), rng.integers(0, 9, bk.shape[0]).astype(np.int32)
    bv = rng.random(bk.shape[0]) > 0.25
    cap = 2048
    pi, bi, sel, matched, total, bm = ref_join.join_indices(
        [jnp.asarray(pk)], jnp.asarray(ps), [jnp.asarray(bk)], jnp.asarray(bs), cap,
        keep_unmatched_probe=True, want_build_matched=True,
    )
    bcols_j = [(jnp.asarray(bd_), jnp.asarray(bv))]
    pcols_j = ref_join.gather_columns([(jnp.asarray(pd_), None)], pi)
    hcols_j = ref_join.gather_columns(bcols_j, bi)
    un_j = jnp.logical_and(jnp.asarray(bs), jnp.logical_not(bm))
    op_j, ob_j, _, total_full = ref_join.full_merge_tail(pcols_j, hcols_j, matched, total, bcols_j, un_j, cap)
    t = torch.from_numpy
    qi, qb, qm, qbm = port_join.join_indices([(t(pk), None)], t(ps), [(t(bk), None)], t(bs),
                                             keep_unmatched_probe=True, want_build_matched=True)
    bcols_p = [(t(bd_), t(bv))]
    op_p, ob_p, n = port_join.full_merge_tail(port_join.gather_columns([(t(pd_), None)], qi, pk.shape[0]),
                                              port_join.gather_columns(bcols_p, qb, bk.shape[0]), qm, bcols_p,
                                              t(bs) & ~qbm)
    n_j = int(total_full)
    assert n == n_j
    for (dj, vj), (dp, vp) in zip(op_j + ob_j, op_p + ob_p):
        v = np.asarray(vj)[:n]
        np.testing.assert_array_equal(vp.numpy(), v)
        np.testing.assert_array_equal(dp.numpy()[v], np.asarray(dj)[:n][v])
