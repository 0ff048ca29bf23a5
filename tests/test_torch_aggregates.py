"""The rest of the aggregate family: the JAX package (the reference) vs the
torch port on one device, the CPU.

STDDEV / VARIANCE, MEDIAN and the percentiles, COUNT / SUM / AVG
(DISTINCT) and aggregate UDFs, with the SQL of
tests/test_nulls_extract_stats.py, tests/test_alias_distinct.py,
tests/test_advice_r2.py and tests/test_udf.py (`torch.log` in place of
`jnp.log`), run through `datafusion_tpu.ExecutionContext()` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
columns. Tolerances:

  * byte-exact `result_str`, row order included: COUNT(DISTINCT), MEDIAN,
    PERCENTILE, PERCENTILE_DISC [DESC], MIN / MAX and the keys
  * rtol 1e-12 (`same`): VAR / STDDEV, UDAF results and SUM / AVG
    (DISTINCT) on finite data, whose sums both packages take in another
    order. Over many groups the JAX package's grouped SUM(DISTINCT) of
    floats loses the ulp of one global prefix sum at every row, so there
    it is held to n * (n * max|v|) * 2^-53 besides; the port's
    SUM(DISTINCT) is held to a `math.fsum` oracle within
    n * max|v| * 2^-52

Where the JAX package is wrong (ROADMAP Queue 3: grouped SUM / AVG
(DISTINCT) as differences of one global prefix sum, so a NaN or +-inf in
one group spreads to every later group; COUNT(DISTINCT) counting every
NaN as a value of its own), the tests assert SQL's answer.
"""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import NotImplementedError_ as RefNotImplemented
from datafusion_tpu_torch.errors import NotImplementedError_, PlanError
from datafusion_tpu_torch.ops import aggregate as agg_ops
from test_torch_join import port_table
from test_torch_window import contexts, same


def both(tables, sqls, exact=True):
    """Each query through both packages: byte-exact, or within `same`'s
    rtol 1e-12 on float fields."""
    r, p = contexts(tables)
    for q in sqls:
        a, b = r.sql(q).result_str(), p.sql(q).result_str()
        if exact:
            assert a == b, (q, a[:400], b[:400])
        else:
            same(a, b)


def port_ctx(tables, **kw):
    p = port.ExecutionContext(device="cpu", **kw)
    for name, t in tables.items():
        p.register_table(name, port_table(ref.Table.from_pydict(t) if isinstance(t, dict) else t))
    return p


def nullable(cols: dict, validity: dict):
    """A JAX table of `cols` (numpy arrays) whose columns in `validity`
    are nullable with that mask."""
    fields, arrays, masks = [], [], []
    for name, a in cols.items():
        dt = {np.dtype(np.float64): ref.DataType.Float64, np.dtype(np.int32): ref.DataType.Int32,
              np.dtype(np.int64): ref.DataType.Int64}[a.dtype]
        fields.append(ref.Field(name, dt, name in validity))
        arrays.append(a)
        masks.append(validity.get(name))
    return ref.Table.from_arrays(ref.Schema(fields), arrays, validity=masks)


def explain(ctx, q):
    return ctx.sql("EXPLAIN VERBOSE " + q).result_str()


# --------------------------------------------------- STDDEV / VARIANCE
STATS = {"g": ["a"] * 4 + ["b"] * 4, "v": np.array([2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0])}


@pytest.mark.parametrize("sql", [
    "SELECT STDDEV_POP(v) FROM t",
    "SELECT STDDEV(v) FROM t",
    "SELECT VAR_POP(v) FROM t",
    "SELECT VARIANCE(v) FROM t",
    "SELECT g, VARIANCE(v) FROM t GROUP BY g ORDER BY g",
    "SELECT g, STDDEV(v), STDDEV_POP(v), VAR_SAMP(v), VAR_POP(v), COUNT(*) FROM t GROUP BY g ORDER BY g",
    "SELECT STDDEV(v) FROM t WHERE v > 8",
    "SELECT VAR_SAMP(v) FROM t WHERE v > 8",
    "SELECT VAR_POP(v) FROM t WHERE v > 8",
    "SELECT g, STDDEV(v), VAR_POP(v) FROM t WHERE v > 4.5 GROUP BY g ORDER BY g",
])
def test_stddev_variance_match_jax(sql):
    both({"t": STATS}, [sql], exact=False)


def test_stddev_variance_goldens():
    p = port_ctx({"t": STATS})
    vals = STATS["v"]
    for q, want in (("SELECT STDDEV_POP(v) FROM t", np.std(vals)), ("SELECT STDDEV(v) FROM t", np.std(vals, ddof=1)),
                    ("SELECT VAR_POP(v) FROM t", np.var(vals)), ("SELECT VARIANCE(v) FROM t", np.var(vals, ddof=1))):
        assert abs(float(p.sql(q).result_str()) - want) <= 1e-12 * want
    assert p.sql("SELECT g, VARIANCE(v) FROM t GROUP BY g ORDER BY g").result_str() == (
        '"a"\t1.0\n"b"\t3.6666666666666665\n')
    assert p.sql("SELECT STDDEV(v) FROM t WHERE v > 8").result_str() == "NULL\n"
    assert p.sql("SELECT VAR_POP(v) FROM t WHERE v > 8").result_str() == "0.0\n"
    with pytest.raises(PlanError):
        p.sql("SELECT STDDEV(g) FROM t")


def test_stddev_over_ints_and_small_n():
    both({"t": {"w": np.array([1, 2, 3, 4], np.int64)}}, ["SELECT VAR_POP(w) FROM t", "SELECT STDDEV(w) FROM t"])
    both({"t": {"v": np.array([42.0])}}, ["SELECT STDDEV(v), VARIANCE(v) FROM t",
                                          "SELECT STDDEV_POP(v), VAR_POP(v) FROM t"])


def test_stddev_stable_when_mean_dominates():
    """The two-pass form where E[x^2] - E[x]^2 would cancel (test_advice_r2)."""
    rng = np.random.default_rng(7)
    vals = 1.0e6 + rng.normal(0.0, 1e-2, size=4096)
    ks = np.array(["a", "b"] * 2048)
    both({"t": {"k": ks, "v": vals}}, ["SELECT STDDEV_POP(v), VAR_POP(v) FROM t",
                                       "SELECT k, STDDEV(v), VAR_POP(v) FROM t GROUP BY k ORDER BY k"], exact=False)
    out = port_ctx({"t": {"k": ks, "v": vals}}).sql("SELECT STDDEV_POP(v), VAR_POP(v) FROM t").result_str()
    got_std, got_var = (float(c) for c in out.split())
    assert abs(got_std - np.std(vals)) / np.std(vals) < 1e-9
    assert abs(got_var - np.var(vals)) / np.var(vals) < 1e-9


# ----------------------------------------------- MEDIAN / PERCENTILE
M = {"g": ["a", "a", "a", "a", "b", "b", "b"], "v": np.array([1.0, 3.0, 2.0, 10.0, 5.0, 7.0, 6.0])}


@pytest.mark.parametrize("sql", [
    "SELECT MEDIAN(v) FROM m",
    "SELECT g, MEDIAN(v) FROM m GROUP BY g ORDER BY g",
    "SELECT g, PERCENTILE(v, 0.25), PERCENTILE(v, 1.0) FROM m GROUP BY g ORDER BY g",
    "SELECT g, MEDIAN(v), MIN(v), MAX(v), COUNT(v) FROM m GROUP BY g ORDER BY g",
    "SELECT PERCENTILE_DISC(v, 0.5), PERCENTILE_DISC(v, 0.0), PERCENTILE_DISC(v, 1.0), PERCENTILE(v, 0.1) FROM m",
    "SELECT g, PERCENTILE_DISC(v, 0.3), PERCENTILE_DISC_DESC(v, 0.3), MEDIAN(v) FROM m GROUP BY g ORDER BY g",
    "SELECT g, PERCENTILE_CONT(0.5) WITHIN GROUP (ORDER BY v) FROM m GROUP BY g ORDER BY g",
    "SELECT PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v DESC) FROM m",
    "SELECT g, MEDIAN(v), MEDIAN(v) FROM m WHERE v > 2 GROUP BY g ORDER BY g",
])
def test_median_percentile_match_jax(sql):
    both({"m": M}, [sql])


def test_median_percentile_goldens():
    p = port_ctx({"m": M, "wg": {"g": ["a"] * 4, "v": np.array([1.0, 2.0, 3.0, 10.0])}})
    assert p.sql("SELECT MEDIAN(v) FROM m").result_str() == "5.0\n"
    assert p.sql("SELECT g, PERCENTILE(v, 0.25), PERCENTILE(v, 1.0) FROM m GROUP BY g ORDER BY g").result_str() == (
        '"a"\t1.75\t10.0\n"b"\t5.5\t7.0\n')
    assert p.sql("SELECT g, PERCENTILE_CONT(0.5) WITHIN GROUP (ORDER BY v) FROM wg GROUP BY g").result_str() == (
        '"a"\t2.5\n')
    assert p.sql("SELECT PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v DESC) FROM wg").result_str() == "4.75\n"


@pytest.mark.parametrize("q, want", [(0.5, "3.0"), (0.0, "4.0"), (1.0, "1.0"), (0.4, "3.0")])
def test_percentile_disc_desc_ansi_boundary(q, want):
    """ANSI: the first value in DESC order whose cumulative fraction
    reaches q, the position n - ceil(q n) (test_advice_r2)."""
    t = {"t": {"x": np.array([1.0, 2.0, 3.0, 4.0])}}
    sql = f"SELECT PERCENTILE_DISC({q}) WITHIN GROUP (ORDER BY x DESC) FROM t"
    assert port_ctx(t).sql(sql).result_str() == want + "\n"
    both(t, [sql, f"SELECT PERCENTILE_DISC({q}) WITHIN GROUP (ORDER BY x) FROM t"])


def test_percentile_disc_desc_grouped():
    t = {"g": {"k": ["a", "a", "a", "a", "b", "b", "b"], "x": np.array([1.0, 2.0, 3.0, 4.0, 10.0, 20.0, 30.0])}}
    sql = "SELECT k, PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY x DESC) FROM g GROUP BY k ORDER BY k"
    assert port_ctx(t).sql(sql).result_str() == '"a"\t3.0\n"b"\t20.0\n'
    both(t, [sql])


def test_median_limits():
    """A second, different MEDIAN argument raises, with the JAX message."""
    t = {"m": {"v": np.array([1.0, 2.0]), "w": np.array([3.0, 4.0])}}
    r, p = contexts(t)
    sql = "SELECT MEDIAN(v), MEDIAN(w), COUNT(v) FROM m GROUP BY v"
    with pytest.raises(RefNotImplemented) as want:
        r.sql(sql)
    with pytest.raises(NotImplementedError_) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)
    with pytest.raises(PlanError):
        p.sql("SELECT PERCENTILE(v, 1.5) FROM m")
    # ungrouped, every argument sorts on its own
    both(t, ["SELECT MEDIAN(v), MEDIAN(w), PERCENTILE_DISC(w, 0.5) FROM m"])


def test_median_signed_zero():
    """-0.0 and 0.0 share the order-preserving image, so the interpolated
    value's sign follows the JAX package's `to_sortable_int`."""
    t = {"z": {"g": np.array([1, 1, 1, 1, 2, 2, 3, 3, 3], np.int32),
               "v": np.array([-0.0, 0.0, 2.0, 2.0, -0.0, -0.0, -0.0, 0.0, -1.0])}}
    both(t, ["SELECT MEDIAN(v), PERCENTILE(v, 0.3), PERCENTILE_DISC(v, 0.2) FROM z",
             "SELECT g, MEDIAN(v), PERCENTILE(v, 0.1), PERCENTILE_DISC(v, 0.5), PERCENTILE_DISC_DESC(v, 0.5), MIN(v), "
             "MAX(v) FROM z GROUP BY g ORDER BY g",
             "SELECT MEDIAN(v) FROM z WHERE g = 2"])


def test_median_nan_and_variance_nan():
    """NaN sorts after +inf in the image; VAR over a group holding NaN is NaN."""
    t = {"n": {"g": np.array([1, 1, 1, 2, 2, 2, 2, 3], np.int32),
               "v": np.array([1.0, np.nan, 3.0, np.nan, np.nan, -np.inf, 4.0, np.inf])}}
    both(t, ["SELECT g, MEDIAN(v), PERCENTILE(v, 0.9), PERCENTILE_DISC(v, 0.9), MIN(v), MAX(v) FROM n "
             "GROUP BY g ORDER BY g", "SELECT MEDIAN(v), PERCENTILE_DISC(v, 1.0) FROM n"])
    both(t, ["SELECT g, STDDEV(v), VAR_POP(v) FROM n GROUP BY g ORDER BY g", "SELECT VAR_POP(v) FROM n"], exact=False)


def test_int64_median_through_f64():
    """Int64 values past 2^53 go through f64, rounding as in the JAX package."""
    big = 2**53
    t = {"i": {"g": np.array([1, 1, 1, 2, 2], np.int32),
               "w": np.array([big + 1, big + 3, -big - 5, 7, big * 4 + 1], np.int64)}}
    both(t, ["SELECT MEDIAN(w), PERCENTILE(w, 0.75), PERCENTILE_DISC(w, 0.5) FROM i",
             "SELECT g, MEDIAN(w), PERCENTILE(w, 0.4), PERCENTILE_DISC_DESC(w, 0.6), COUNT(DISTINCT w) FROM i "
             "GROUP BY g ORDER BY g"])


# ------------------------------------------------------- the DISTINCT family
D = {"g": ["a", "a", "a", "b", "b"], "v": np.array([1.0, 1.0, 3.0, 5.0, 5.0])}
T = {"a": np.array([1, 2, 2, 3, 3, 3], np.int32), "b": np.array([1.0, 2.0, 2.0, 3.0, 9.0, 3.0]),
     "s": ["x", "y", "y", "z", "z", "z"]}


@pytest.mark.parametrize("tables, sql", [
    ({"d": D}, "SELECT SUM(DISTINCT v), AVG(DISTINCT v), COUNT(DISTINCT v), SUM(v) FROM d"),
    ({"d": D}, "SELECT g, SUM(DISTINCT v), AVG(DISTINCT v), MIN(DISTINCT v) FROM d GROUP BY g ORDER BY g"),
    ({"t": T}, "SELECT a, COUNT(DISTINCT b), COUNT(b) FROM t GROUP BY a ORDER BY a"),
    ({"t": T}, "SELECT COUNT(DISTINCT b) FROM t"),
    ({"t": T}, "SELECT COUNT(DISTINCT s) FROM t"),
    ({"t": T}, "SELECT SUM(DISTINCT b) FROM t"),
    ({"t": T}, "SELECT s, COUNT(DISTINCT a), SUM(DISTINCT a), AVG(DISTINCT a) FROM t GROUP BY s ORDER BY s"),
    ({"t": T}, "SELECT a, COUNT(DISTINCT s), COUNT(DISTINCT b), SUM(DISTINCT b) FROM t WHERE b < 9 GROUP BY a "
               "ORDER BY a"),
])
def test_distinct_match_jax(tables, sql):
    both(tables, [sql])


def test_distinct_goldens():
    p = port_ctx({"d": D, "t": T})
    assert p.sql("SELECT SUM(DISTINCT v), AVG(DISTINCT v), COUNT(DISTINCT v), SUM(v) FROM d").result_str() == (
        "9.0\t3.0\t3\t15.0\n")
    assert p.sql("SELECT g, SUM(DISTINCT v), AVG(DISTINCT v), MIN(DISTINCT v) FROM d GROUP BY g ORDER BY g"
                 ).result_str() == '"a"\t4.0\t2.0\t1.0\n"b"\t5.0\t5.0\t5.0\n'
    assert p.sql("SELECT a, COUNT(DISTINCT b), COUNT(b) FROM t GROUP BY a ORDER BY a").result_str() == (
        "1\t1\t1\n2\t1\t2\n3\t2\t3\n")
    assert p.sql("SELECT COUNT(DISTINCT s) FROM t").result_str() == "3\n"
    with pytest.raises(PlanError, match="DISTINCT"):
        p.sql("SELECT STDDEV(DISTINCT v) FROM d")


def test_sum_distinct_nonfinite_per_group():
    """Reference fault 1 (ROADMAP Queue 3): the JAX package takes grouped
    SUM / AVG(DISTINCT) as differences of one global prefix sum, so group
    1's NaN spreads to groups 2 and 3. SQL's answer: NaN, inf, 2.0."""
    t = {"f": {"g": np.array([1, 1, 1, 2, 2, 3, 3], np.int32),
               "v": np.array([np.nan, np.nan, 1.0, np.inf, 5.0, 2.0, 2.0])}}
    p = port_ctx(t)
    assert p.sql("SELECT g, SUM(DISTINCT v) FROM f GROUP BY g ORDER BY g").result_str() == (
        "1\tNaN\n2\tinf\n3\t2.0\n")
    assert p.sql("SELECT g, AVG(DISTINCT v), COUNT(DISTINCT v) FROM f GROUP BY g ORDER BY g").result_str() == (
        "1\tNaN\t2\n2\tinf\t2\n3\t2.0\t1\n")


def test_count_distinct_counts_nan_once():
    """Reference fault 2 (ROADMAP Queue 3): the JAX package counts every
    NaN as its own value (5 here) while its SELECT DISTINCT returns one
    NaN row. SQL's answer, and the port's SELECT DISTINCT: 4 values (NaN,
    one zero, 1.0, 2.0)."""
    v = np.array([np.nan, np.nan, 1.0, -0.0, 0.0, 2.0, 2.0])
    t = {"f": {"g": np.array([1, 1, 1, 1, 1, 1, 1], np.int32), "v": v}}
    p = port_ctx(t)
    assert p.sql("SELECT COUNT(DISTINCT v) FROM f").result_str() == "4\n"
    assert p.sql("SELECT COUNT(*) FROM (SELECT DISTINCT v FROM f) q").result_str() == "4\n"
    assert p.sql("SELECT g, COUNT(DISTINCT v) FROM f GROUP BY g").result_str() == "1\t4\n"
    assert p.sql("SELECT SUM(DISTINCT v) FROM f WHERE v = v").result_str() == "3.0\n"


def test_sum_distinct_of_narrow_ints_wraps_as_sum():
    """SUM(DISTINCT) of a narrow integer column sums exactly in int64 and
    wraps to the column's type, as SUM over the distinct values does (the
    JAX package sums DISTINCT in f64 and saturates the cast: ROADMAP
    Queue 3)."""
    rng = np.random.default_rng(6)
    t = {"t": {"g": rng.integers(0, 3, 400).astype(np.int32), "u": rng.integers(0, 200, 400).astype(np.uint8),
               "i": rng.integers(-100, 100, 400).astype(np.int8)}}
    p = port_ctx(t)
    for c in ("u", "i"):
        got = p.sql(f"SELECT g, SUM(DISTINCT {c}) FROM t GROUP BY g ORDER BY g").result_str()
        want = p.sql(f"SELECT g, SUM(x) FROM (SELECT DISTINCT g, {c} AS x FROM t) q GROUP BY g ORDER BY g")
        assert got == want.result_str()
        assert p.sql(f"SELECT SUM(DISTINCT {c}) FROM t").result_str() == p.sql(
            f"SELECT SUM(x) FROM (SELECT DISTINCT {c} AS x FROM t) q").result_str()


def test_sum_distinct_fsum_oracle():
    """SUM(DISTINCT) of finite f64 values within n * max|v| * 2^-52 of
    `math.fsum` of each group's distinct values, and the JAX package's
    answer within rtol 1e-12."""
    rng = np.random.default_rng(5)
    n = 20000
    g = rng.integers(0, 37, n).astype(np.int32)
    v = np.round(rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 6, n), 2)
    t = {"s": {"g": g, "v": v}}
    sql = "SELECT g, SUM(DISTINCT v), COUNT(DISTINCT v) FROM s GROUP BY g ORDER BY g"
    both(t, [sql], exact=False)
    out = port_ctx(t).sql(sql).result_str().splitlines()
    for line, key in zip(out, np.unique(g)):
        u = np.unique(v[g == key])
        _, s_, c_ = line.split("\t")
        assert int(c_) == len(u)
        assert abs(float(s_) - math.fsum(u)) <= len(u) * np.abs(u).max() * 2.0**-52


# --------------------------------------------------------------- UDAFs
def geomean_meta(name="geomean"):
    return port.FunctionMeta(name, (port.Field("x", port.DataType.Float64, False),), port.DataType.Float64,
                             port.FunctionType.Aggregate)


def udaf_contexts():
    rng = np.random.default_rng(0)
    t = {"t": {"g": ["a", "a", "b", "b", "b", "a", "b", "a"] * 64, "v": rng.random(512) * 10 + 0.5}}
    r, p = contexts(t)
    D_ = ref.DataType
    for ctx, lib, Fm, Fd, UDAF in ((r, jnp, ref.FunctionMeta, ref.Field, ref.AggregateUDF),
                                   (p, torch, port.FunctionMeta, port.Field, port.AggregateUDF)):
        dt = D_.Float64 if ctx is r else port.DataType.Float64
        ft = (ref.FunctionType if ctx is r else port.FunctionType).Aggregate
        ctx.register_function(Fm("geomean", (Fd("x", dt, False),), dt, ft),
                              UDAF(map=lib.log, combine="sum", finalize=lambda s, n, lib=lib: lib.exp(s / n)))
        ctx.register_function(Fm("maxlog", (Fd("x", dt, False),), dt, ft), UDAF(map=lib.log, combine="max"))
        ctx.register_function(Fm("lo", (Fd("x", dt, False),), dt, ft), UDAF(combine="min"))
    return r, p, t["t"]


@pytest.mark.parametrize("sql", [
    "SELECT geomean(v) FROM t",
    "SELECT g, geomean(v) FROM t GROUP BY g ORDER BY g",
    "SELECT maxlog(v) FROM t",
    "SELECT g, maxlog(v), lo(v), geomean(v) * 2 FROM t GROUP BY g ORDER BY g",
    "SELECT g, geomean(v) FROM t WHERE v > 3 GROUP BY g HAVING COUNT(v) > 10 ORDER BY g",
])
def test_aggregate_udf_matches_jax(sql):
    r, p, _ = udaf_contexts()
    same(r.sql(sql).result_str(), p.sql(sql).result_str())


def test_aggregate_udf_goldens_and_routes():
    _, p, t = udaf_contexts()
    v, g = t["v"], np.array(t["g"])

    def gm(x):
        return float(np.exp(np.mean(np.log(x))))

    assert abs(float(p.sql("SELECT geomean(v) FROM t").result_str()) - gm(v)) < 1e-9
    out = p.sql("SELECT g, geomean(v) FROM t GROUP BY g ORDER BY g").result_str()
    for line, key in zip(out.splitlines(), ("a", "b")):
        assert abs(float(line.split("\t")[1]) - gm(v[g == key])) < 1e-9
    assert abs(float(p.sql("SELECT maxlog(v) FROM t").result_str()) - float(np.log(v).max())) < 1e-12
    # the desugared SUM + COUNT takes K2 dense over a small key
    assert "dense sort-free group-by (dict=2)" in explain(p, "SELECT g, geomean(v) FROM t GROUP BY g")


def test_aggregate_udf_plain_callable_rejected():
    p = port.ExecutionContext(device="cpu")
    with pytest.raises(PlanError, match="AggregateUDF"):
        p.register_function(geomean_meta("badagg"), lambda x: x)
    assert p.sql("SELECT 1 + 2").result_str() == "3\n"
    with pytest.raises(ValueError):
        port.AggregateUDF(combine="avg")


# ------------------------------------------ empty, all-NULL, NULL arguments
def test_empty_and_all_null_groups():
    g = np.array([1, 1, 2, 2, 2, 3, 3, 3, 3], np.int32)
    v = np.array([5.0, 7.0, 1.0, 4.0, 4.0, 2.0, 8.0, 3.0, 6.0])
    valid = np.array([False, False, True, False, True, True, True, False, True])
    tbl = nullable({"g": g, "v": v}, {"v": valid})
    every = ("MEDIAN(v), PERCENTILE(v, 0.7), PERCENTILE_DISC(v, 0.5), PERCENTILE_DISC_DESC(v, 0.5), "
             "COUNT(DISTINCT v), SUM(DISTINCT v), AVG(DISTINCT v), COUNT(v)")
    var = "STDDEV(v), STDDEV_POP(v), VAR_SAMP(v), VAR_POP(v)"
    t = {"n": tbl}
    both(t, [f"SELECT g, {every} FROM n GROUP BY g ORDER BY g", f"SELECT {every} FROM n",
             f"SELECT {every} FROM n WHERE g > 5", f"SELECT g, {every} FROM n WHERE g > 5 GROUP BY g"])
    both(t, [f"SELECT g, {var} FROM n GROUP BY g ORDER BY g", f"SELECT {var} FROM n",
             f"SELECT {var} FROM n WHERE g > 5", f"SELECT g, {var} FROM n WHERE g > 5 GROUP BY g"], exact=False)


def test_null_group_keys():
    """NULL keys form one group after the values, on every route."""
    k = np.array([1, 0, 2, 1, 0, 2, 0, 1], np.int32)
    kv = np.array([True, False, True, True, False, True, False, True])
    v = np.array([1.0, 2.0, 3.0, 4.0, 2.0, 6.0, 7.0, 1.0])
    t = {"n": nullable({"k": k, "v": v}, {"k": kv})}
    both(t, ["SELECT k, MEDIAN(v), COUNT(DISTINCT v), SUM(DISTINCT v), PERCENTILE_DISC(v, 0.9) FROM n "
             "GROUP BY k ORDER BY k"])
    both(t, ["SELECT k, STDDEV(v), VAR_POP(v) FROM n GROUP BY k ORDER BY k"], exact=False)


# ------------------------------------------------- routes, and random tables
def test_routes_and_decline_notes():
    r, p = contexts({"t": STATS})
    dense_var = explain(p, "SELECT g, STDDEV(v), VARIANCE(v) FROM t GROUP BY g")
    assert "aggregate: dense sort-free group-by (dict=2); VAR/STDDEV squared deviations in a second K2 dense pass" \
        in dense_var
    med = explain(p, "SELECT g, MEDIAN(v) FROM t GROUP BY g")
    assert "aggregate: dense sort-free declined (MEDIAN needs the sorted path)" in med
    assert "packed-gid co-sort (dict=2) + segmented reduce; the percentile argument rides the co-sort" in med
    dis = explain(p, "SELECT g, COUNT(DISTINCT v), SUM(DISTINCT v) FROM t GROUP BY g")
    assert "aggregate: dense sort-free declined (COUNT_DISTINCT needs the sorted path)" in dis
    assert "1 DISTINCT argument(s), one sort within the groups each" in dis
    # the sorted route is the JAX package's route for these functions too
    assert "packed-gid co-sort (dict=2)" in explain(r, "SELECT g, MEDIAN(v) FROM t GROUP BY g")


def test_bigdense_declines_the_family():
    rng = np.random.default_rng(3)
    n = 6000
    t = {"b": {"k": rng.integers(0, 3000, n).astype(np.int32), "v": rng.random(n)}}
    p = port_ctx(t, bigdense=True)
    for fn, name in (("MEDIAN(v)", "MEDIAN"), ("STDDEV(v)", "STDDEV_SAMP"), ("COUNT(DISTINCT v)", "COUNT_DISTINCT")):
        txt = explain(p, f"SELECT k, {fn} FROM b GROUP BY k")
        assert f"aggregate: bigdense declined ({name} is not on K3 + K4)" in txt
        assert "packed-gid co-sort (int[" in txt
    assert "bigdense radix-partition" in explain(p, "SELECT k, SUM(v) FROM b GROUP BY k")
    q = "SELECT k, MEDIAN(v), COUNT(DISTINCT v), STDDEV(v) FROM b GROUP BY k ORDER BY k"
    r = ref.ExecutionContext()
    r.register_table("b", ref.Table.from_pydict(t["b"]))
    same(r.sql(q).result_str(), p.sql(q).result_str())


def reduce_calls(monkeypatch, ctx, q):
    """The K2 calls (`segmented_reduce`) one run of `q` makes, by mode."""
    calls = []
    real = agg_ops.segmented_reduce

    def spy(*a, **kw):
        calls.append("dense" if kw.get("dense") else "sorted")
        return real(*a, **kw)

    monkeypatch.setattr(agg_ops, "segmented_reduce", spy)
    ctx.sql(q)
    monkeypatch.setattr(agg_ops, "segmented_reduce", real)
    return calls


def test_reduce_calls_per_route(monkeypatch):
    """Dense VAR/STDDEV: two K2 dense calls; a percentile or the DISTINCT
    family: one K2 sorted call; with VAR as well, two."""
    rng = np.random.default_rng(4)
    n = 5000
    t = {"r": {"d": rng.integers(0, 100, n).astype(np.int32), "g": rng.integers(1, 5000, n).astype(np.int32),
               "k": rng.integers(0, 300, n).astype(np.int32), "lat": rng.random(n) * 10 + 48}}
    p = port_ctx(t)
    assert reduce_calls(monkeypatch, p, "SELECT d, STDDEV(lat), VARIANCE(lat), COUNT(*) FROM r GROUP BY d") == [
        "dense", "dense"]
    assert reduce_calls(monkeypatch, p, "SELECT g, MEDIAN(lat), PERCENTILE(lat, 0.9), PERCENTILE_DISC(lat, 0.1), "
                                        "COUNT(lat) FROM r GROUP BY g") == ["sorted"]
    assert reduce_calls(monkeypatch, p, "SELECT d, COUNT(DISTINCT g), SUM(DISTINCT k), AVG(DISTINCT k) FROM r "
                                        "GROUP BY d") == ["sorted"]
    assert reduce_calls(monkeypatch, p, "SELECT g, MEDIAN(lat), STDDEV(lat) FROM r GROUP BY g") == ["sorted", "sorted"]


def random_table(seed, n=3000):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 9, n).astype(np.int32),  # dense domain
        "w": rng.integers(-40000, 40000, n).astype(np.int32),  # wide: packed co-sort
        "f": rng.integers(0, 25, n) / 4.0,  # float key: the generic co-sort
        "v": np.round(rng.normal(3, 100, n), 1),
        "i": rng.integers(-50, 50, n).astype(np.int64),
    }
    return nullable(cols, {"v": rng.random(n) > 0.15, "i": rng.random(n) > 0.1})


EXACT = ("MEDIAN(v), PERCENTILE(v, 0.9), PERCENTILE_DISC(v, 0.1), PERCENTILE_DISC_DESC(v, 0.35), "
         "COUNT(DISTINCT i), COUNT(DISTINCT v), MIN(v), MAX(i), COUNT(v)")
TOLERANT = "STDDEV(v), VAR_POP(v), SUM(DISTINCT i), AVG(DISTINCT i), AVG(v)"
DISTINCT_SUMS = "SUM(DISTINCT v), AVG(DISTINCT v)"


def jax_distinct_bound(table) -> float:
    """The JAX package's grouped SUM(DISTINCT) of floats is a difference of
    one global f64 prefix sum over every group's distinct values: n
    additions, each within half an ulp of a prefix of at most n * max|v|
    (ROADMAP Queue 3)."""
    v = np.asarray(table.columns[table.schema.names().index("v")].data)[:table.num_rows]
    return len(v) * len(v) * float(np.abs(v).max()) * 2.0**-53


@pytest.mark.parametrize("keys", ["k", "w", "f", "k, w", "f, k", "i"])
@pytest.mark.parametrize("where", ["", "WHERE w > -10000"])
def test_random_tables_match_jax(keys, where):
    t = {"r": random_table(len(keys) + len(where))}
    both(t, [f"SELECT {keys}, {EXACT} FROM r {where} GROUP BY {keys} ORDER BY {keys}"])
    both(t, [f"SELECT {keys}, {TOLERANT} FROM r {where} GROUP BY {keys} ORDER BY {keys}"], exact=False)
    r, p = contexts(t)
    q = f"SELECT {keys}, {DISTINCT_SUMS} FROM r {where} GROUP BY {keys} ORDER BY {keys}"
    same(r.sql(q).result_str(), p.sql(q).result_str(), jax_distinct_bound(t["r"]))


def test_random_distinct_sums_fsum_oracle():
    """The port's grouped SUM / AVG(DISTINCT) over the random table, NULLs
    skipped, within n * max|v| * 2^-52 of `math.fsum` of each group's
    distinct values."""
    tbl = random_table(11)
    w, v, ok = (np.asarray(a)[:tbl.num_rows] for a in (tbl.columns[1].data, tbl.columns[3].data,
                                                       tbl.columns[3].validity))
    out = port_ctx({"r": tbl}).sql("SELECT w, SUM(DISTINCT v), AVG(DISTINCT v) FROM r GROUP BY w ORDER BY w")
    keys, sums, avgs = (c for c, _ in out.cols)
    valid = out.cols[1][1]
    for j, key in enumerate(keys):
        u = np.unique(v[(w == key) & ok])
        assert (len(u) > 0) == (valid is None or bool(valid[j]))
        if len(u):
            tol = len(u) * np.abs(u).max() * 2.0**-52
            assert abs(sums[j] - math.fsum(u)) <= tol
            assert abs(avgs[j] - math.fsum(u) / len(u)) <= tol / len(u) + 1e-15 * abs(avgs[j])


def test_random_int_median_and_ride_packing():
    """An Int32 MEDIAN argument packs with the group id into one sort key;
    an f64 one takes a pass of its own: both match the JAX package."""
    t = {"r": random_table(9)}
    both(t, ["SELECT w, MEDIAN(k), PERCENTILE_DISC(k, 0.6) FROM r GROUP BY w ORDER BY w",
             "SELECT k, MEDIAN(w), PERCENTILE(w, 0.33), MEDIAN(w) FROM r GROUP BY k ORDER BY k",
             f"SELECT {EXACT} FROM r", f"SELECT {EXACT} FROM r WHERE k > 100"])
    both(t, [f"SELECT {TOLERANT} FROM r", f"SELECT {TOLERANT} FROM r WHERE k > 100"], exact=False)


# ---------------------------------------------------------------- TPC-H q16
@pytest.fixture(scope="module")
def q16_tables():
    bench = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
    sys.path.insert(0, bench)
    old = os.environ.get("DFTPU_X64")
    try:
        import tpch
    finally:
        sys.path.remove(bench)
        if old is None:
            os.environ.pop("DFTPU_X64", None)
        else:
            os.environ["DFTPU_X64"] = old
    lineitem, _, _, part = tpch.gen_tables(0.01)
    li = {c: lineitem[c] for c in ("l_partkey", "l_suppkey", "l_quantity", "l_extendedprice")}
    pa = {c: part[c] for c in ("p_partkey", "p_brand", "p_type", "p_size")}
    return {"lineitem": li, "part": pa}, tpch.Q16ish


def test_q16ish_matches_jax(q16_tables):
    """TPC-H q16's shape: a join, NOT IN, an IN list and COUNT(DISTINCT)."""
    tables, sql = q16_tables
    r, p = contexts(tables)
    want = r.sql(sql).result_str()
    assert p.sql(sql).result_str() == want
    assert len(want.splitlines()) == 20
    assert "COUNT_DISTINCT needs the sorted path" in explain(p, sql)
