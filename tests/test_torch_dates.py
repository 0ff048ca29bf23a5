"""The date and timestamp functions: the torch port against the JAX package.

Three parts, all exact (no tolerance: the functions are integer
arithmetic, and so is every result compared here):
  * every device function of `datafusion_tpu_torch/utils/dates.py`
    against its `datafusion_tpu/utils/dates.py` counterpart, values and
    dtypes, over seeded random int32 days and int64 seconds across their
    whole ranges plus the calendar's edges (chip_smoke.EDGE_DAYS /
    EDGE_SECONDS: INT_MIN / INT_MAX days, +-2^62 seconds, -1, leap days,
    ISO years of 53 weeks);
  * K1's plain version (`fused_stage.evaluate_plain`) on the date
    programs chip_smoke.py holds the kernel to (K1_DATES: every field,
    unit and INTERVAL function) against the JAX package's SQL over the
    same table of edges;
  * the SQL of tests/test_dates.py, tests/test_timestamps.py and
    test_nulls_extract_stats.py::test_extract_from_date through both
    packages, `result_str` byte for byte (errors: both raise PlanError);
    CURRENT_DATE / NOW by type and range; the fused stage in EXPLAIN
    VERBOSE; a mesh of 8 shards equal to one card.
"""

import datetime
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import PlanError as RefPlanError
from datafusion_tpu.utils import dates as J
from datafusion_tpu_torch.errors import PlanError
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.utils import dates as T


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()

# --------------------------------------------------------------- functions
rng = np.random.default_rng(2026)
DAYS = np.concatenate([
    np.asarray(smoke.EDGE_DAYS, np.int32),
    rng.integers(smoke.I32.min, smoke.I32.max, 4000, endpoint=True).astype(np.int32),
    rng.integers(-800_000, 800_000, 4000).astype(np.int32),
])
SECONDS = np.concatenate([
    np.asarray(smoke.EDGE_SECONDS, np.int64),
    rng.integers(smoke.I64.min, smoke.I64.max, 4000, dtype=np.int64, endpoint=True),
    rng.integers(-10**11, 10**11, 4000),
])


def same(a, b, what=""):
    """A JAX array and a torch tensor: equal values and dtypes."""
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    bad = np.flatnonzero(a != b)
    assert bad.size == 0, (what, bad[:5], a[bad[:5]], b[bad[:5]])


@pytest.mark.parametrize("field", ["year", "month", "day", "dow", "doy", "quarter", "week"])
def test_extract_matches_jax(field):
    same(getattr(J, f"extract_{field}")(jnp.asarray(DAYS)), getattr(T, f"extract_{field}")(torch.from_numpy(DAYS)))


@pytest.mark.parametrize("field", ["year", "month", "day", "hour", "minute", "second", "dow", "doy", "quarter",
                                   "week"])
def test_ts_extract_matches_jax(field):
    same(getattr(J, f"ts_extract_{field}")(jnp.asarray(SECONDS)),
         getattr(T, f"ts_extract_{field}")(torch.from_numpy(SECONDS)))


@pytest.mark.parametrize("unit", T.DATE_TRUNC_UNITS)
def test_date_trunc_matches_jax(unit):
    same(J.date_trunc_seconds(jnp.asarray(SECONDS), unit), T.date_trunc_seconds(torch.from_numpy(SECONDS), unit))
    if unit in ("year", "quarter", "month", "week", "day"):
        same(J.date_trunc_days(jnp.asarray(DAYS), unit), T.date_trunc_days(torch.from_numpy(DAYS), unit))


@pytest.mark.parametrize("n", [1, -1, 13, -25, 1200, 0, 2**31 - 1, -(2**31)])
def test_add_months_matches_jax(n):
    """Month ends clamp; n at the int32 extremes wraps as the JAX package's."""
    same(J.add_months_days(jnp.asarray(DAYS), n), T.add_months_days(torch.from_numpy(DAYS), n), n)
    same(J.add_months_seconds(jnp.asarray(SECONDS), n), T.add_months_seconds(torch.from_numpy(SECONDS), n), n)


def test_civil_conversions_match_jax():
    for a, b in zip(J._civil_from_days_dev(jnp.asarray(DAYS)), T._civil_from_days(torch.from_numpy(DAYS))):
        same(a, b, "civil_from_days")
    y = rng.integers(-3000, 3000, 5000).astype(np.int32)
    y[:4] = (smoke.I32.min, smoke.I32.max, 0, -1)
    m = rng.integers(1, 13, 5000).astype(np.int32)
    d = rng.integers(1, 32, 5000).astype(np.int32)
    same(J._days_from_civil_dev(jnp.asarray(y), jnp.asarray(m), jnp.asarray(d)),
         T._days_from_civil(torch.from_numpy(y), torch.from_numpy(m), torch.from_numpy(d)), "days_from_civil")
    same(J._days_in_month_dev(jnp.asarray(y), jnp.asarray(m)),
         T._days_in_month(torch.from_numpy(y), torch.from_numpy(m)), "days_in_month")
    same(J._days_of_seconds_dev(jnp.asarray(SECONDS)), T.ts_to_date(torch.from_numpy(SECONDS)), "ts_to_date")


# ------------------------------------------------ K1's plain version vs SQL
def _edge_tables(n=3001):
    """chip_smoke.date_edge_table in both packages, the same buffers."""
    t = smoke.date_edge_table(port, n, 13, "cpu")
    schema = ref.Schema([ref.Field("dt", ref.DataType.Date32, True), ref.Field("ts", ref.DataType.Timestamp, True)])
    jt = ref.Table.from_arrays(schema, [c.data.numpy() for c in t.columns],
                               validity=[c.validity.numpy() for c in t.columns])
    return t, jt


@pytest.mark.parametrize("i", range(len(smoke.K1_DATES)))
def test_k1_date_programs_match_jax(i):
    """evaluate_plain (K1's plain version) on each K1_DATES program over
    the edge table against the JAX package's SQL: the same rows, values
    and validity."""
    t, jt = _edge_tables()
    sql = smoke.K1_DATES[i]
    r = ref.ExecutionContext()
    r.register_table("t", jt)
    want = r.sql(sql)
    ctx = port.ExecutionContext(device="cpu")
    ctx.register_table("t", t)
    assert "fused CUDA stage (12 computed expr(s)" in ctx.sql(f"EXPLAIN VERBOSE {sql}").result_str()
    prog, ins = smoke.fused_program(ctx, "t", sql)
    sel, outs = fs.evaluate_plain(prog, *ins, t.num_rows)
    assert int(sel.sum()) == want.num_rows
    for (d, v), (wd, wv) in zip(outs, want.cols):
        live = np.ones(want.num_rows, bool) if wv is None else wv
        assert np.array_equal(v[sel].numpy(), live)
        assert d.numpy().dtype == wd.dtype
        assert np.array_equal(d[sel].numpy()[live], wd[live])


# ------------------------------------------------------------------ SQL
def _tables(mod, device=None):
    """The tables of the JAX package's date tests, built by `mod`."""
    kw = {} if device is None else {"device": device}

    def pydict(d):
        return mod.Table.from_pydict(d, **kw)

    return {
        "t": pydict({"d": np.array(["2024-01-15", "2023-06-30", "2024-03-01", "2023-06-30"], "datetime64[D]"),
                     "v": np.array([1.0, 2.0, 3.0, 4.0])}),
        "h": pydict({"d": np.array(["2023-06-30", "2024-03-01"], "datetime64[D]"), "name": ["summer", "spring"]}),
        "p": pydict({"d": [datetime.date(2020, 2, 29), datetime.date(1969, 12, 31)]}),
        "e": pydict({"k": np.array([1, 2, 3], np.int32),
                     "d": np.array(["2021-01-31", "2020-02-29", "2021-12-15"], "datetime64[D]"),
                     "ts": np.array(["2021-03-15T08:30:05", "2022-07-01T23:59:59", "2021-03-15T10:00:00"],
                                    "datetime64[s]")}),
        "x": pydict({"d": np.array(["2021-01-01", "2021-03-15", "2024-12-30", "2023-01-01"], "datetime64[D]")}),
        "y": pydict({"d": np.array(["2021-03-15", "2024-12-30"], "datetime64[D]"),
                     "ts": np.array(["2021-03-15T08:30:05", "2020-02-29T12:00:00"], "datetime64[s]")}),
        "xd": pydict({"k": np.array([1, 2, 3], np.int32),
                      "d": np.array(["2021-03-15", "2022-07-01", "2021-12-31"], "datetime64[D]")}),
        "pre": pydict({"k": np.array([1, 2, 3, 4], np.int32),
                       "d": np.array(["1969-12-31", "1900-03-01", "1904-02-29", "1969-01-01"], "datetime64[D]"),
                       "ts": [datetime.datetime(1969, 12, 31, 23, 59, 59), None,
                              datetime.datetime(1900, 1, 1, 0, 0, 1), datetime.datetime(1969, 12, 31, 0, 0, 0)]}),
    }


@pytest.fixture(scope="module")
def contexts():
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, t in _tables(ref).items():
        r.register_table(name, t)
    for name, t in _tables(port, "cpu").items():
        p.register_table(name, t)
    return r, p


SQL = [
    # tests/test_dates.py
    "SELECT d, v FROM t WHERE d > DATE '2023-12-31' ORDER BY d",
    "SELECT d, v FROM t WHERE d = '2023-06-30' ORDER BY v",
    "SELECT d FROM t WHERE d BETWEEN '2023-06-01' AND '2023-12-31'",
    "SELECT MIN(d), MAX(d), COUNT(d) FROM t",
    "SELECT d, COUNT(v) FROM t GROUP BY d ORDER BY d",
    "SELECT d, YEAR(d), MONTH(d), DAY(d) FROM t ORDER BY d LIMIT 1",
    "SELECT YEAR(d) AS y, COUNT(v) FROM t GROUP BY y ORDER BY y",
    "SELECT MIN(d) FROM t",
    "SELECT d FROM p ORDER BY d",
    "SELECT t.v, h.name FROM t JOIN h ON t.d = h.d ORDER BY v",
    "SELECT d, v, ROW_NUMBER() OVER (PARTITION BY d ORDER BY v) AS rn FROM t ORDER BY d, v",
    # tests/test_timestamps.py
    "SELECT k, ts FROM e ORDER BY ts",
    "SELECT k FROM e WHERE ts > TIMESTAMP '2021-03-15 09:00:00' ORDER BY k",
    "SELECT k FROM e WHERE ts = TIMESTAMP '2021-03-15'",
    "SELECT k, EXTRACT(HOUR FROM ts), EXTRACT(MINUTE FROM ts), EXTRACT(SECOND FROM ts) FROM e ORDER BY k",
    "SELECT k, YEAR(ts), MONTH(ts), DAY(ts) FROM e ORDER BY k",
    "SELECT k FROM e WHERE ts > DATE '2021-06-01' ORDER BY k",
    "SELECT k FROM e WHERE CAST(ts AS DATE) = DATE '2021-03-15' ORDER BY k",
    "SELECT CAST(DATE '2021-03-15' AS TIMESTAMP) FROM e LIMIT 1",
    "SELECT MIN(ts), MAX(ts) FROM e",
    "SELECT YEAR(ts), COUNT(k) FROM e GROUP BY YEAR(ts) ORDER BY 1",
    "SELECT ts FROM e ORDER BY ts LIMIT 1",
    "SELECT k, d + INTERVAL '1' MONTH FROM e ORDER BY k",
    "SELECT k, d + INTERVAL '1' YEAR FROM e ORDER BY k",
    "SELECT k, d - INTERVAL '2 weeks' FROM e ORDER BY k",
    "SELECT k, ts + INTERVAL '90' MINUTE FROM e ORDER BY k",
    "SELECT k, INTERVAL '3' DAY + d FROM e ORDER BY k",
    "SELECT k, d + INTERVAL '36' HOUR FROM e ORDER BY k",
    "SELECT k FROM e WHERE ts > TIMESTAMP '2021-03-15 08:00:00' + INTERVAL '1' HOUR ORDER BY k",
    "SELECT EXTRACT(DOW FROM d), EXTRACT(DOY FROM d), EXTRACT(QUARTER FROM d), EXTRACT(WEEK FROM d) FROM x",
    "SELECT DATE_TRUNC('month', d), DATE_TRUNC('year', d), DATE_TRUNC('week', d) FROM y",
    "SELECT DATE_TRUNC('hour', ts), DATE_TRUNC('quarter', ts) FROM y",
    "SELECT EXTRACT(EPOCH FROM ts) FROM y WHERE EXTRACT(YEAR FROM ts) = 2021",
    # test_nulls_extract_stats.py::test_extract_from_date
    "SELECT k, EXTRACT(YEAR FROM d) FROM xd ORDER BY k",
    "SELECT k FROM xd WHERE EXTRACT(MONTH FROM d) = 12",
    "SELECT EXTRACT(DAY FROM d) FROM xd ORDER BY 1",
    # before the epoch, NULL timestamps, every field and unit, over a scan (K1)
    "SELECT k, YEAR(d), MONTH(d), DAY(d), EXTRACT(DOW FROM d), EXTRACT(DOY FROM d), EXTRACT(WEEK FROM d), "
    "EXTRACT(EPOCH FROM d), HOUR(ts), MINUTE(ts), SECOND(ts), EXTRACT(EPOCH FROM ts) FROM pre",
    "SELECT k, DATE_TRUNC('quarter', d), DATE_TRUNC('week', ts), DATE_TRUNC('minute', ts), CAST(ts AS DATE), "
    "ts - INTERVAL '13' MONTH, d - INTERVAL '1' MONTH FROM pre WHERE d + INTERVAL '1' MONTH < DATE '1970-01-01'",
    "SELECT YEAR(d), QUARTER(d), COUNT(*) FROM pre GROUP BY YEAR(d), QUARTER(d) ORDER BY 1, 2",
]


@pytest.mark.parametrize("sql", SQL)
def test_date_sql_matches_jax(contexts, sql):
    r, p = contexts
    assert p.sql(sql).result_str() == r.sql(sql).result_str()


@pytest.mark.parametrize("sql", [
    "SELECT SUM(d) FROM t",
    "SELECT HOUR(k) FROM e",
    "SELECT SUM(ts) FROM e",
    "SELECT k + INTERVAL '1' DAY FROM e",
    "SELECT INTERVAL '1' DAY - d FROM e",
    "SELECT INTERVAL '1' DAY FROM e",
    "SELECT DATE_TRUNC('hour', d) FROM y",
])
def test_date_errors_match_jax(contexts, sql):
    r, p = contexts
    with pytest.raises(RefPlanError):
        r.sql(sql)
    with pytest.raises(PlanError):
        p.sql(sql)


def test_csv_dates_match_jax(tmp_path):
    """CREATE EXTERNAL TABLE over DATE and TIMESTAMP columns: fractions
    truncate, a bare date is midnight, an empty field is NULL."""
    path = tmp_path / "ts.csv"
    path.write_text("k,d,ts\n1,2024-01-15,2021-03-15 08:30:05\n2,,2022-07-01T23:59:59\n"
                    "3,1969-12-31,2021-03-15 10:00:00.25\n4,2020-02-29,2020-01-01\n5,1900-03-01,\n")
    ddl = f"CREATE EXTERNAL TABLE c (k INT, d DATE, ts TIMESTAMP) STORED AS CSV WITH HEADER ROW LOCATION '{path}'"
    sql = "SELECT k, d, ts, YEAR(d), HOUR(ts), d + INTERVAL '1' MONTH FROM c ORDER BY k"
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    r.sql(ddl)
    p.sql(ddl)
    assert p.sql(sql).result_str() == r.sql(sql).result_str()


def test_current_date_and_now(contexts):
    _, p = contexts
    assert p.sql("SELECT COUNT(d) FROM x WHERE d <= CURRENT_DATE").result_str() == "4\n"
    res = p.sql("SELECT CURRENT_DATE, NOW() FROM x LIMIT 1")
    assert [f.dtype for f in res.schema.fields] == [port.DataType.Date32, port.DataType.Timestamp]
    today, now = res.column_values(0)[0], res.column_values(1)[0]
    assert abs((today - datetime.date.today()).days) <= 1
    assert abs((now - datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)).total_seconds()) < 3600 * 24


def test_date_projection_runs_on_the_fused_stage(contexts):
    """A date projection over a scan is K1's program; a GROUP BY key over a
    date function runs as torch ops (the co-sort: no static domain)."""
    _, p = contexts
    txt = p.sql("EXPLAIN VERBOSE SELECT k, YEAR(d), DATE_TRUNC('month', ts), ts + INTERVAL '3' HOUR, "
                "CAST(ts AS DATE) FROM e WHERE d + INTERVAL '1' MONTH > DATE '2021-01-01'").result_str()
    assert "fused CUDA stage (4 computed expr(s), predicate" in txt
    txt = p.sql("EXPLAIN VERBOSE SELECT YEAR(ts), COUNT(k) FROM e GROUP BY YEAR(ts)").result_str()
    assert "co-sort + segmented reduce" in txt


def test_mesh_matches_one_card(contexts):
    _, p = contexts
    m = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    for name in ("t", "e", "pre"):
        m.register_table(name, p.table(name))
    for sql in ("SELECT k, YEAR(d), EXTRACT(WEEK FROM d), HOUR(ts), DATE_TRUNC('month', ts) FROM pre "
                "WHERE d < DATE '1969-06-01' OR ts IS NULL",
                "SELECT d, COUNT(v) FROM t GROUP BY d ORDER BY d",
                "SELECT YEAR(ts), COUNT(k) FROM e GROUP BY YEAR(ts) ORDER BY 1",
                "SELECT k, ts + INTERVAL '1' MONTH FROM e ORDER BY ts"):
        assert m.sql(sql).result_str() == p.sql(sql).result_str(), sql
