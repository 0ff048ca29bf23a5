"""Window functions: the JAX package (the reference) vs the torch port on the CPU.

The SQL of tests/test_window_functions.py and the window statements of
tests/test_advice_r2.py, tests/test_review_regressions.py and
tests/test_nulls_extract_stats.py, plus NULL / NaN / frame cases, run
through `datafusion_tpu.ExecutionContext()` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
columns, and `result_str()` must match byte for byte, row order included.
Window SUM / AVG columns may differ by the stated tolerance: the JAX
package sums windows as differences of one f64 prefix stream, which
loses the ulp of the global prefix at every row, so its error is bounded
by n * (n * max|v|) * 2^-53 (n rows), with rel 1e-12 beside it; the port
(whole partitions on K2, the rest on exact fixed-point digit prefixes)
stays within n * max|v| * 2^-52 of the exact sum, with rel 1e-12 beside
it, and is held to that against a long-double oracle, partition by
partition.

Unit cases feed the same seeded numpy inputs to `window_spec` of both
packages: every kind, ROWS frames, NULL arguments, NaN / +-inf, and
unselected rows, compared on the selected rows (values elsewhere are
don't-care). Where the JAX package splits NULL partition keys by the
data stored under them (ROADMAP Queue 3), the test asserts SQL's answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import PlanError as RefPlanError
from datafusion_tpu.ops import window as ref_window
from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.ops import window as port_window
from test_torch_join import port_table

RTOL = 1e-12


def contexts(tables: dict):
    """(JAX context, port context) over the same columns; `tables` maps
    names to JAX Tables or pydicts."""
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, t in tables.items():
        jt = t if isinstance(t, ref.Table) else ref.Table.from_pydict(t)
        r.register_table(name, jt)
        p.register_table(name, port_table(jt))
    return r, p


def same(a: str, b: str, atol: float = 0.0) -> None:
    """Byte-exact, except float fields, which may differ by atol + RTOL * |a|."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (a[:400], b[:400])
    for ra, rb in zip(la, lb):
        fa, fb = ra.split("\t"), rb.split("\t")
        assert len(fa) == len(fb), (ra, rb)
        for x, y in zip(fa, fb):
            if x == y:
                continue
            assert "." in x and "." in y, (ra, rb)
            fx, fy = float(x), float(y)
            assert abs(fx - fy) <= atol + RTOL * abs(fx), (ra, rb)


def jax_bound(n: int, vmax: float) -> float:
    """The JAX package's window-sum error bound: n additions, each within
    half an ulp of a prefix of at most n * vmax."""
    return n * n * vmax * 2.0**-53


def check_sql(tables, sqls, atol=0.0):
    r, p = contexts(tables)
    for q in sqls:
        same(r.sql(q).result_str(), p.sql(q).result_str(), atol)


T = {"g": ["a", "a", "a", "b", "b", "c"], "k": np.array([3, 1, 2, 5, 4, 9], np.int32),
     "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0])}

WINDOW_FUNCTIONS_SQL = [
    "SELECT g, k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY k) AS rn FROM t ORDER BY g, k",
    "SELECT k, RANK() OVER (ORDER BY g) AS r FROM t ORDER BY k",
    "SELECT k, DENSE_RANK() OVER (ORDER BY g) AS r FROM t ORDER BY k",
    "SELECT g, SUM(v) OVER (PARTITION BY g) AS s, MIN(v) OVER (PARTITION BY g) AS lo, "
    "MAX(v) OVER (PARTITION BY g) AS hi, COUNT(*) OVER (PARTITION BY g) AS c, "
    "AVG(v) OVER (PARTITION BY g) AS m FROM t ORDER BY g",
    "SELECT g, k, SUM(v) OVER (PARTITION BY g ORDER BY k) AS rs FROM t ORDER BY g, k",
    "SELECT g, k, LAG(v) OVER (PARTITION BY g ORDER BY k) AS p, LEAD(k, 1) OVER (PARTITION BY g ORDER BY k) AS n "
    "FROM t ORDER BY g, k",
    "SELECT g, k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY k) AS rn FROM t WHERE k > 1 ORDER BY g, k",
    "SELECT k, LAG(g) OVER (ORDER BY k) AS pg FROM t ORDER BY k",
    "SELECT g, k, SUM(v) OVER (PARTITION BY g ORDER BY k) AS rs FROM t ORDER BY g, k",
    "SELECT g, k, MIN(v) OVER (PARTITION BY g) AS lo FROM t ORDER BY g, k",
    "SELECT g, ROW_NUMBER() OVER (ORDER BY g) FROM t GROUP BY g",
    "SELECT g, k, MIN(v) OVER (PARTITION BY g ORDER BY k) AS lo, MAX(v) OVER (PARTITION BY g ORDER BY k) AS hi "
    "FROM t ORDER BY g, k",
    "SELECT g, k, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY k) AS f, LAST_VALUE(v) OVER (PARTITION BY g ORDER BY k) "
    "AS l, NTILE(2) OVER (PARTITION BY g ORDER BY k) AS t2 FROM t ORDER BY g, k",
    "SELECT g, k FROM (SELECT g, k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v DESC) AS rn FROM t) s "
    "WHERE rn = 1 ORDER BY g",
    # no ORDER BY: the rows in the table's order
    "SELECT g, k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY k DESC), SUM(v) OVER (PARTITION BY g ORDER BY k), "
    "LEAD(v) OVER (ORDER BY v) FROM t",
]


def test_window_functions_sql():
    check_sql({"t": T}, WINDOW_FUNCTIONS_SQL)


def test_window_over_group_by_and_in_order_by():
    gt = {"g": ["a", "a", "b", "b", "c", "c"], "r": ["e", "e", "e", "w", "w", "w"],
          "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 65.0])}
    check_sql({"t": gt}, [
        "SELECT g, SUM(v) AS s, RANK() OVER (ORDER BY SUM(v) DESC) FROM t GROUP BY g ORDER BY g",
        "SELECT r, g, SUM(v), ROW_NUMBER() OVER (PARTITION BY r ORDER BY SUM(v) DESC) FROM t GROUP BY r, g "
        "ORDER BY 1, 2",
        "SELECT g, SUM(v) - AVG(SUM(v)) OVER () AS diff FROM t GROUP BY g ORDER BY g",
        "SELECT g, SUM(v) AS s, RANK() OVER (ORDER BY SUM(v) DESC) AS rk FROM t GROUP BY g HAVING SUM(v) > 40 "
        "ORDER BY rk",
    ], atol=jax_bound(6, 65.0))
    ot = {"g": ["a", "a", "b", "b"], "v": np.array([10.0, 20.0, 30.0, 40.0])}
    check_sql({"t": ot}, [
        "SELECT g, v FROM t ORDER BY ROW_NUMBER() OVER (PARTITION BY g ORDER BY v DESC), g",
        "SELECT g, SUM(v) AS s FROM t GROUP BY g ORDER BY RANK() OVER (ORDER BY SUM(v))",
    ])


def test_percent_rank_cume_dist_nth_value():
    w = {"g": ["a", "a", "a", "a", "b", "b"], "v": np.array([10.0, 20.0, 20.0, 40.0, 5.0, 7.0])}
    check_sql({"w": w}, [
        "SELECT g, v, PERCENT_RANK() OVER (PARTITION BY g ORDER BY v) FROM w ORDER BY g, v",
        "SELECT g, v, CUME_DIST() OVER (PARTITION BY g ORDER BY v) FROM w ORDER BY g, v",
        "SELECT g, NTH_VALUE(v, 2) OVER (PARTITION BY g ORDER BY v) FROM w ORDER BY g, 2",
        "SELECT NTH_VALUE(v, 5) OVER (PARTITION BY g ORDER BY v) FROM w",
    ])


def test_rows_frames_and_grouped_windows():
    frames = {"g": ["a", "a", "a", "a", "b", "b"], "k": np.array([1, 2, 3, 4, 1, 2], np.int32),
              "v": np.array([10.0, 20.0, 30.0, 40.0, 5.0, 7.0])}
    check_sql({"t": frames}, [
        "SELECT k, SUM(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t ORDER BY 1",
        "SELECT k, SUM(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t ORDER BY 1",
        "SELECT k, AVG(v) OVER (ORDER BY k, v ROWS 2 PRECEDING) FROM t ORDER BY 1",
        "SELECT g, k, COUNT(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING), "
        "SUM(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING), "
        "FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 2 PRECEDING AND 1 PRECEDING), "
        "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 1 FOLLOWING AND 3 FOLLOWING), "
        "MAX(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) FROM t",
    ], atol=jax_bound(6, 40.0))
    check_sql({"t": {"x": np.array([1.0, 2.0, 3.0])}}, [
        "SELECT SUM(x) OVER (ORDER BY x ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t"])
    ab = {"a": np.array([1, 1, 2], np.int32), "b": np.array([1.0, 2.0, 3.0])}
    r, p = contexts({"t": ab})
    for q in ("SELECT a, SUM(b) AS sm, ROW_NUMBER() OVER (ORDER BY a) AS r FROM t GROUP BY a ORDER BY a",
              "SELECT a, SUM(b), ROW_NUMBER() OVER (ORDER BY a) FROM t GROUP BY a",
              "SELECT a, SUM(b), ROW_NUMBER() OVER (ORDER BY a) FROM t AS t GROUP BY t.a ORDER BY 1"):
        want, got = r.sql(q), p.sql(q)
        assert got.schema.names() == want.schema.names()
        same(want.result_str(), got.result_str())


def test_window_errors_plan_alike():
    r, p = contexts({"t": T})
    for q in ("SELECT SQRT(v) OVER (ORDER BY k) FROM t", "SELECT k FROM t WHERE ROW_NUMBER() OVER (ORDER BY k) < 3",
              "SELECT MIN(v) OVER (ORDER BY k ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t"):
        with pytest.raises(RefPlanError):
            r.sql(q)
        with pytest.raises(PlanError):
            p.sql(q)


def _nullable_table(n=400, seed=5):
    """Nullable keys and values with NaN / +-inf and ties."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(0, 100, n), 1)
    v[rng.random(n) < 0.03] = np.nan
    v[rng.random(n) < 0.02] = np.inf
    v[rng.random(n) < 0.02] = -np.inf
    schema = ref.Schema([ref.Field("g", ref.DataType.Int32, True), ref.Field("k", ref.DataType.Int64, True),
                         ref.Field("v", ref.DataType.Float64, True), ref.Field("i", ref.DataType.Int32, True),
                         ref.Field("s", ref.DataType.Utf8, True)])
    cols = [rng.integers(0, 6, n).astype(np.int32), rng.integers(-20, 20, n), v,
            rng.integers(-1000, 1000, n).astype(np.int32),
            np.array([["p", "q", "r"][j] for j in rng.integers(0, 3, n)], dtype=object)]
    valid = [rng.random(n) > q for q in (0.1, 0.1, 0.15, 0.2, 0.1)]
    for c, m in zip(cols, valid):
        c[~m] = "p" if c.dtype == object else 0  # the JAX package orders NULL keys by the data under them
    return ref.Table.from_arrays(schema, cols, validity=valid)


def test_window_nulls_nan_inf_sql():
    """Every kind over nullable keys and arguments with NaN and +-inf, in
    the table's row order (no ORDER BY), two specs a query."""
    jt = _nullable_table()
    vmax = 400 * 300.0  # finite |v| stays well below 300
    check_sql({"t": jt}, [
        "SELECT g, k, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY k, v), RANK() OVER (PARTITION BY g ORDER BY k), "
        "DENSE_RANK() OVER (PARTITION BY g ORDER BY k DESC), PERCENT_RANK() OVER (PARTITION BY g ORDER BY k), "
        "CUME_DIST() OVER (PARTITION BY g ORDER BY k NULLS FIRST), NTILE(3) OVER (PARTITION BY g ORDER BY k) FROM t",
        "SELECT g, SUM(v) OVER (PARTITION BY g ORDER BY k), COUNT(v) OVER (PARTITION BY g ORDER BY k), "
        "AVG(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING), "
        "SUM(i) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 2 PRECEDING AND CURRENT ROW), "
        "COUNT(*) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 1 FOLLOWING AND 4 FOLLOWING) FROM t",
        "SELECT g, SUM(v) OVER (PARTITION BY g), AVG(i) OVER (PARTITION BY g), MIN(v) OVER (PARTITION BY g), "
        "MAX(v) OVER (PARTITION BY g), MIN(i) OVER (PARTITION BY g), MAX(s) OVER (PARTITION BY g), "
        "COUNT(v) OVER (PARTITION BY g) FROM t",
        "SELECT g, k, MIN(v) OVER (PARTITION BY g ORDER BY k), MAX(v) OVER (PARTITION BY g ORDER BY k), "
        "MAX(i) OVER (PARTITION BY g ORDER BY k) FROM t",
        "SELECT g, LAG(v, 2) OVER (PARTITION BY g ORDER BY k), LEAD(s) OVER (PARTITION BY g ORDER BY k), "
        "FIRST_VALUE(i) OVER (PARTITION BY g ORDER BY k), LAST_VALUE(s) OVER (PARTITION BY g ORDER BY k), "
        "NTH_VALUE(v, 3) OVER (PARTITION BY g ORDER BY k) FROM t",
        "SELECT s, g, ROW_NUMBER() OVER (PARTITION BY s, g ORDER BY i DESC), SUM(i) OVER (ORDER BY i) FROM t "
        "WHERE i > -500",
    ], atol=jax_bound(400, vmax / 400))


def test_null_partition_keys_are_one_partition():
    """The JAX package splits NULL keys by the data stored under them
    (ROADMAP Queue 3); SQL puts them in one partition, and so does the port."""
    schema = port.Schema([port.Field("g", port.DataType.Int32, True), port.Field("v", port.DataType.Float64, False)])
    t = port.Table.from_arrays(schema, [np.array([5, 7, 1, 1, 9], np.int32), np.arange(5.0)],
                               validity=[np.array([False, False, True, True, False]), None], device="cpu")
    p = port.ExecutionContext(device="cpu")
    p.register_table("t", t)
    out = p.sql("SELECT g, v, COUNT(*) OVER (PARTITION BY g), ROW_NUMBER() OVER (PARTITION BY g ORDER BY v DESC), "
                "RANK() OVER (ORDER BY g) FROM t").result_str()
    assert out == "NULL\t0.0\t3\t3\t3\nNULL\t1.0\t3\t2\t3\n1\t2.0\t2\t2\t1\n1\t3.0\t2\t1\t1\nNULL\t4.0\t3\t1\t3\n"


def test_window_larger_table_sql():
    """tests/test_window_functions.py's 3,000-row table, and the same
    statements in the table's row order."""
    rng = np.random.default_rng(1)
    data = {"g": rng.integers(0, 13, 3000).astype(np.int32), "v": rng.random(3000).round(4)}
    check_sql({"t": data}, [
        "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn FROM t ORDER BY g, v, rn LIMIT 80",
        "SELECT g, SUM(v) OVER (PARTITION BY g) AS s FROM t ORDER BY g, s LIMIT 80",
        "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v), SUM(v) OVER (PARTITION BY g ORDER BY v) FROM t",
    ], atol=jax_bound(3000, 1.0))


# ---------------------------------------------------------------------------
# window_spec, both packages, the same seeded inputs
# ---------------------------------------------------------------------------


def _spec_inputs(n=300, seed=11):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 7, n).astype(np.int32)
    pk_v = rng.random(n) > 0.1
    pk[~pk_v] = 0  # the JAX package's partitions follow the data under a NULL key
    ok = np.round(rng.random(n) * 20, 0)  # ties
    ok_v = rng.random(n) > 0.1
    ok[~ok_v] = 0.0
    f = np.round(rng.normal(0, 50, n), 2)
    f[rng.random(n) < 0.04] = np.nan
    f[rng.random(n) < 0.03] = np.inf
    f[rng.random(n) < 0.03] = -np.inf
    f_v = rng.random(n) > 0.15
    i = rng.integers(-500, 500, n).astype(np.int32)
    i_v = rng.random(n) > 0.2
    sel = rng.random(n) > 0.2
    return pk, pk_v, ok, ok_v, f, f_v, i, i_v, sel


CALLS = [
    ("row_number", None, 1, None), ("rank", None, 1, None), ("dense_rank", None, 1, None),
    ("percent_rank", None, 1, None), ("cume_dist", None, 1, None), ("ntile", None, 4, None),
    ("lag", "f", 2, None), ("lead", "i", 1, None), ("nth_value", "f", 2, None),
    ("first_value", "i", 1, None), ("last_value", "f", 1, None),
    ("first_value", "f", 1, (-2, 1)), ("last_value", "i", 1, (-1, 2)),
    ("sum", "f", 1, None), ("sum", "i", 1, None), ("count", "f", 1, None), ("count", None, 1, None),
    ("avg", "f", 1, None), ("avg", "i", 1, (-3, 2)), ("sum", "f", 1, (-3, 2)), ("sum", "i", 1, (None, 0)),
    ("sum", "f", 1, (0, None)), ("count", "i", 1, (1, 4)), ("sum", "f", 1, (None, None)),
    ("min", "f", 1, None), ("max", "f", 1, None), ("min", "i", 1, None), ("max", "i", 1, (None, 0)),
    ("max", "f", 1, (None, None)),
    # arguments without NULLs: valid wherever the window holds a selected row
    ("sum", "n", 1, None), ("avg", "n", 1, (-2, 0)), ("max", "n", 1, None), ("min", "n", 1, (None, None)),
    ("sum", "n", 1, (1, 3)), ("count", "n", 1, (-1, 1)), ("avg", "n", 1, None),
]
SUMS = {"sum", "avg"}


def _run_both(part, order, calls, sel, args):
    """Both packages' window_spec over numpy inputs: part keys (data,
    valid), order keys ((data, valid), asc, nulls_first), calls (kind,
    argument name in `args` | None, offset, frame)."""
    def jx(cv):
        return None if cv is None else (jnp.asarray(cv[0]), None if cv[1] is None else jnp.asarray(cv[1]))

    def tc(cv):
        return None if cv is None else (torch.from_numpy(cv[0]), None if cv[1] is None else torch.from_numpy(cv[1]))

    jargs = {name: jx(cv) for name, cv in args.items()}

    @jax.jit
    def ref_spec(part, order, jargs, sel):  # one compile, not an eager dispatch per operation
        return ref_window.window_spec(part, [(cv, a, nf) for cv, (a, nf) in zip(order, order_dirs)],
                                      [ref_window.WindowCall(k, jargs.get(a), o, fr) for k, a, o, fr in calls], sel)

    order_dirs = [(a, nf) for _, a, nf in order]
    want = ref_spec([jx(cv) for cv in part], [jx(cv) for cv, _, _ in order], jargs, jnp.asarray(sel))
    got = port_window.window_spec([tc(cv) for cv in part], [(tc(cv), a, nf) for cv, a, nf in order],
                                  [port_window.WindowCall(k, tc(args.get(a)), o, fr) for k, a, o, fr in calls],
                                  torch.from_numpy(sel))
    return want, got


def _assert_same(want, got, calls, sel, atol):
    for call, (wd, wv), (gd, gv) in zip(calls, want, got):
        wd, gd = np.asarray(wd)[sel], gd.numpy()[sel]
        wv = np.ones(sel.sum(), bool) if wv is None else np.asarray(wv)[sel]
        gv = np.ones(sel.sum(), bool) if gv is None else gv.numpy()[sel]
        np.testing.assert_array_equal(gv, wv, err_msg=str(call))
        # the port carries UInt64 counts in int64 (types.py physical_np)
        assert gd.dtype == (np.dtype(np.int64) if wd.dtype == np.uint64 else wd.dtype), call
        wd, gd = wd[wv], gd[wv]
        if call[0] in SUMS and wd.dtype.kind == "f":
            fin = np.isfinite(wd)
            np.testing.assert_array_equal(np.isfinite(gd), fin, err_msg=str(call))
            np.testing.assert_array_equal(gd[~fin].astype(str), wd[~fin].astype(str), err_msg=str(call))
            assert np.all(np.abs(gd[fin] - wd[fin]) <= atol + RTOL * np.abs(wd[fin])), call
        else:
            np.testing.assert_array_equal(gd, wd, err_msg=str(call))


@pytest.mark.parametrize("order_spec", ["partition+order", "partition only", "order only"])
def test_window_spec_every_kind(order_spec):
    pk, pk_v, ok, ok_v, f, f_v, i, i_v, sel = _spec_inputs()
    part = [] if order_spec == "order only" else [(pk, pk_v)]
    order = [] if order_spec == "partition only" else [((ok, ok_v), False, True), ((i, None), True, False)]
    calls = [c for c in CALLS if order or c[3] is None]  # the planner admits ROWS frames only with ORDER BY
    want, got = _run_both(part, order, calls, sel, {"f": (f, f_v), "i": (i, i_v), "n": (ok, None)})
    _assert_same(want, got, calls, sel, jax_bound(len(sel), max(np.abs(f[np.isfinite(f)]).max(), 500.0)))


def test_window_spec_min_max_nan_inf_agree():
    """K2's MIN / MAX over a partition (the grouped aggregate's NaN
    convention: MIN skips NaN unless all are, MAX reports it) against the
    JAX package's sort on the integer image, and the running scan against
    its associative scan, on partitions holding NaN, +inf, -inf, all-NaN
    and all-NULL arguments."""
    pk = np.repeat(np.arange(6, dtype=np.int32), 4)
    v = np.array([1.0, np.nan, -2.0, 3.0, np.nan, np.nan, np.nan, np.nan, np.inf, 1.0, -np.inf, 5.0,
                  -np.inf, -np.inf, 2.0, 7.0, 4.0, 4.0, 4.0, 4.0, 1.0, 2.0, 3.0, 4.0])
    valid = np.ones(24, bool)
    valid[20:] = False
    order = np.arange(24, dtype=np.int32)[::-1].copy()
    sel = np.ones(24, bool)
    calls = [("min", "v", 1, None), ("max", "v", 1, None)]
    for o in ([], [((order, None), True, False)]):
        want, got = _run_both([(pk, None)], o, calls, sel, {"v": (v, valid)})
        _assert_same(want, got, calls, sel, 0.0)
    (mn, mn_v), (mx, mx_v) = got
    assert np.isnan(mx.numpy()[4]) and mn.numpy()[0] == -2.0 and mx.numpy()[8] == np.inf


def test_window_sums_f64_oracle():
    """About 1e5 rows of f64 values over seven decades with both signs: the
    port's running, framed and whole-partition sums against a long-double
    oracle, partition by partition, within n * max|v| * 2^-52 (rel 1e-12
    beside it). On a Float32 column the port sums in f64 and rounds once
    to f32, so it is held to the oracle within an f32 ulp; the JAX
    package's f32 limb path quantizes values at 2^36 / max|v| (ROADMAP
    Queue 3), so its answer is not the yardstick there."""
    n = 100_000
    rng = np.random.default_rng(21)
    v = np.where(rng.random(n) < 0.5, -1.0, 1.0) * 10.0 ** rng.uniform(-2, 5, n)
    p = rng.integers(0, 64, n).astype(np.int32)
    k = rng.integers(0, 1 << 20, n).astype(np.int64)
    sel = rng.random(n) > 0.05
    order = np.lexsort((np.arange(n), k, p))
    order = order[sel[order]]
    bounds = np.r_[0, np.flatnonzero(np.diff(p[order])) + 1, order.shape[0]]

    def oracle(vals, frame):
        out = np.zeros(n, np.longdouble)
        for s, e in zip(bounds[:-1], bounds[1:]):
            rows = order[s:e]
            c = np.r_[0, np.cumsum(vals[rows].astype(np.longdouble))]
            m = e - s
            j = np.arange(m)
            lo = np.zeros(m, int) if frame[0] is None else np.clip(j + frame[0], 0, m)
            hi = np.full(m, m - 1) if frame[1] is None else np.clip(j + frame[1], -1, m - 1)
            out[rows] = np.where(hi >= lo, c[np.maximum(hi, lo - 1) + 1] - c[lo], 0)
        return out

    for dtype in (np.float64, np.float32):
        vd = v.astype(dtype)
        frames = [(None, 0), (-40, 25), (None, None), (0, None)]
        calls = [port_window.WindowCall("sum", (torch.from_numpy(vd), None), frame=fr) for fr in frames]
        calls.append(port_window.WindowCall("sum", (torch.from_numpy(vd), None)))  # whole partition, on K2
        outs = port_window.window_spec([(torch.from_numpy(p), None)], [((torch.from_numpy(k), None), True)], calls,
                                       torch.from_numpy(sel))
        whole = port_window.window_spec([(torch.from_numpy(p), None)], [], calls[-1:], torch.from_numpy(sel))
        atol = n * np.abs(vd).max() * 2.0**-52
        for fr, (d, _) in zip(frames + [(None, None)], outs[:-1] + whole):
            want = oracle(vd, fr)[sel]
            got = d.numpy()[sel].astype(np.longdouble)
            assert d.dtype == torch.from_numpy(vd).dtype
            tol = atol + RTOL * np.abs(want)
            if dtype == np.float32:
                tol = np.spacing(np.abs(want).astype(np.float32)).astype(np.longdouble) + tol
            assert np.all(np.abs(got - want) <= tol), (dtype, fr, float(np.max(np.abs(got - want) - tol)))


def test_sort_layout_packs_keys():
    """The spec sort's passes: the unselected flag, null flags and narrow
    or ranged keys share one packed key; a 64-bit key takes its own."""
    w = port_window.key_width
    assert port_window.sort_layout([w(torch.int32, (0, 999))]) == [[0, 1, 2]]
    assert len(port_window.sort_layout([w(torch.int32, (0, 999)), w(torch.float64, None)])) == 2
    assert len(port_window.sort_layout([w(torch.int32, None), w(torch.int32, None)])) == 2
    assert len(port_window.sort_layout([w(torch.int32, (0, 999)), w(torch.int32, (0, 65535))])) == 1
    assert port_window.sort_layout([]) == [[0]]
