"""The bigdense GROUP BY (K3 + K4, opt-in with DFTPU_BIGDENSE) through the
port on the CPU, against the JAX package and against the port's own
packed co-sort.

  * the four QUERIES of tests/test_bigdense_groupby.py under
    DFTPU_BIGDENSE=force in both engines (JAX with DFTPU_PALLAS=1, as its
    test runs), compared at that file's rel=1e-3: the JAX kernels sum f32
  * the port's bigdense route against its packed route
    (DFTPU_BIGDENSE=0): keys, counts and MIN/MAX equal, sums at
    rtol=1e-12
  * the routing decisions of that file's three routing tests, in both
    engines. The one difference is by design: the port's bigdense mode
    takes MIN/MAX too (on the H100 the windowed MIN/MAX beat the packed
    co-sort, PERF.md), where the JAX package's "1" keeps them on the
    co-sort (a TPU v5e measurement) and needs "force"
  * DFTPU_BIGDENSE is read once, when the ExecutionContext is made, so
    EXPLAIN and the executed (cached) plan agree
  * the NaN / +-inf SUM case of tests/test_ieee_inf.py on the bigdense
    route
MEDIAN is not part of the port, so that file's MEDIAN fallback test has
no counterpart here.
"""

import math

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from test_bigdense_groupby import QUERIES, _assert_match, _data
from test_ieee_inf import EXPECT, _check, _specials_data

# float SUM/AVG columns of each query, compared at rtol=1e-12 between routes
SUM_COLS = [(1, 5, 7), (), (3,), ()]


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("DFTPU_PALLAS", "1")


def _contexts(data):
    r = ref.ExecutionContext()
    jt = ref.Table.from_pydict(dict(data))
    r.register_table("t", jt)
    p = port.ExecutionContext(device="cpu")
    p.register_table("t", port.Table.from_reference_arrays(
        [port.Field(f.name, port.DataType[f.dtype.name], f.nullable) for f in jt.schema.fields],
        [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
        [c.dictionary for c in jt.columns],
        device="cpu",
        num_rows=jt.num_rows,
    ))
    return r, p


def _route(text):
    for marker, name in (("bigdense radix-partition", "bigdense"), ("dense sort-free", "dense"),
                         ("packed-gid co-sort", "packed")):
        if marker in text:
            return name
    return "other"


def _explain(ctx, sql):
    res = ctx.sql("EXPLAIN VERBOSE " + sql)
    return res.raw_text or ""


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_port_bigdense_matches_jax(monkeypatch, qi):
    monkeypatch.setenv("DFTPU_BIGDENSE", "force")
    r, p = _contexts(_data())
    sql = QUERIES[qi]
    _assert_match(p.sql(sql).result_str(), r.sql(sql).result_str())


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_bigdense_matches_the_packed_route(monkeypatch, qi):
    sql = QUERIES[qi]
    data = _data()
    monkeypatch.setenv("DFTPU_BIGDENSE", "force")
    _, p = _contexts(data)
    routed = _route(_explain(p, sql))
    a = p.sql(sql).result_str()
    monkeypatch.setenv("DFTPU_BIGDENSE", "0")
    _, p0 = _contexts(data)
    assert _route(_explain(p0, sql)) == "packed"
    # the multi-key query's domain product (7 x 5001) is past the bigdense cap
    assert routed == ("packed" if "GROUP BY s, k" in sql else "bigdense")
    b = p0.sql(sql).result_str()
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for ra, rb in zip(la, lb):
        for j, (x, y) in enumerate(zip(ra.split("\t"), rb.split("\t"), strict=True)):
            if j in SUM_COLS[qi] and x != y:
                assert math.isclose(float(x), float(y), rel_tol=1e-12), (j, x, y)
            else:
                assert x == y, (j, x, y)


@pytest.mark.parametrize(
    "mode,kdom,sql,jax_route,port_route",
    [
        # engages past the dense window
        ("force", 5000, "SELECT k, COUNT(v) FROM t GROUP BY k ORDER BY k LIMIT 3", "bigdense", "bigdense"),
        # the dense window keeps small domains
        ("1", 1000, "SELECT k, COUNT(v) FROM t GROUP BY k LIMIT 3", "dense", "dense"),
        # "1" takes SUM/COUNT shapes in both engines
        ("1", 5000, "SELECT k, SUM(v), COUNT(v) FROM t GROUP BY k LIMIT 3", "bigdense", "bigdense"),
        # JAX's "1" leaves MIN/MAX on the co-sort; the port has one "on" mode
        ("1", 5000, "SELECT k, MIN(v) FROM t GROUP BY k LIMIT 3", "packed", "bigdense"),
    ],
)
def test_routes_as_jax_does(monkeypatch, mode, kdom, sql, jax_route, port_route):
    monkeypatch.setenv("DFTPU_BIGDENSE", mode)
    r, p = _contexts(_data(kdom=kdom))
    text = _explain(p, sql)
    assert _route(text) == port_route, text
    assert _route(_explain(r, sql)) == jax_route


def test_the_route_is_fixed_when_the_context_is_made(monkeypatch):
    """A context reads DFTPU_BIGDENSE once: changing it afterwards moves
    neither EXPLAIN nor the executed plan, and the constructor's
    argument overrides it."""
    from datafusion_tpu_torch.ops import aggregate as agg

    calls = []
    real = agg.grouped_aggregate_bigdense
    monkeypatch.setattr(agg, "grouped_aggregate_bigdense", lambda *a: calls.append(1) or real(*a))
    sql = "SELECT k, SUM(v), MIN(v) FROM t GROUP BY k ORDER BY k"
    monkeypatch.setenv("DFTPU_BIGDENSE", "1")
    _, p = _contexts(_data())
    first = p.sql(sql).result_str()
    assert len(calls) == 1
    monkeypatch.setenv("DFTPU_BIGDENSE", "0")
    assert _route(_explain(p, sql)) == "bigdense"
    assert p.sql(sql).result_str() == first and len(calls) == 2
    p0 = port.ExecutionContext(device="cpu")
    p0.register_table("t", p.table("t"))
    assert _route(_explain(p0, sql)) == "packed"
    p0.sql(sql)
    assert len(calls) == 2
    on = port.ExecutionContext(device="cpu", bigdense=True)
    on.register_table("t", p.table("t"))
    assert _route(_explain(on, sql)) == "bigdense"
    assert on.sql(sql).result_str() == first and len(calls) == 3


def test_bigdense_declines_what_its_gate_cannot_bound(monkeypatch):
    """Past K4's shared memory (14 windows) the plan keeps the co-sort
    and says why; nothing is decided at run time."""
    monkeypatch.setenv("DFTPU_BIGDENSE", "force")
    _, p = _contexts(_data())
    aggs = ", ".join(f"{f}(v + {i})" for i in range(4) for f in ("SUM", "MIN", "MAX"))
    text = _explain(p, f"SELECT k, {aggs} FROM t GROUP BY k")
    assert _route(text) == "packed" and "K4's shared memory" in text, text


def test_ieee_specials_bigdense(monkeypatch):
    monkeypatch.setenv("DFTPU_BIGDENSE", "1")
    k, v = _specials_data(8192, 4000)
    sql = "SELECT k, SUM(v) FROM t GROUP BY k ORDER BY k"
    r, p = _contexts({"k": k, "v": v})
    assert _route(_explain(p, sql)) == "bigdense"
    res = p.sql(sql)
    _check(res.to_pylist())
    assert set(EXPECT) <= {row["k"] for row in res.to_pylist()}
    _assert_match(res.result_str(), r.sql(sql).result_str())
