"""Catalog statements and DML through the torch port against the JAX package.

Each scenario is the statement sequence of a test in
tests/test_catalog_statements.py (and test_timestamps.py's CTAS round
trip): CREATE TABLE AS SELECT, INSERT INTO (VALUES, a column list,
SELECT), DROP TABLE [IF EXISTS], SHOW TABLES, DESCRIBE, VALUES. Every
statement runs through `datafusion_tpu.ExecutionContext` and through the
port (device="cpu", on one card and on a mesh of 8 shards) over the same
tables: `result_str` byte for byte after each statement, and where the
JAX package raises PlanError the port raises its PlanError.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import PlanError as RefPlanError
from datafusion_tpu_torch.errors import PlanError


def _tables(mod, device=None):
    kw = {} if device is None else {"device": device}
    D = mod.DataType
    return {
        "t": mod.Table.from_pydict({"g": ["a", "a", "b", "b"], "v": np.array([1.0, 2.0, 3.0, 4.0])}, **kw),
        "t2": mod.Table.from_arrays(
            mod.Schema([mod.Field("x", D.Float64, True), mod.Field("d", D.Date32)]),
            [np.array([1.0, 0.0, 3.0]), np.array(["2021-01-01", "2021-06-15", "2022-03-03"], "datetime64[D]")],
            validity=[np.array([True, False, True]), None], **kw),
        "e": mod.Table.from_pydict({"k": np.array([1, 2, 3], np.int32), "ts": np.array(
            ["2021-03-15T08:30:05", "2022-07-01T23:59:59", "2021-03-15T10:00:00"], "datetime64[s]")}, **kw),
        "a": mod.Table.from_pydict({"x": np.array([1.5, -0.0, 2.25, 9.0]), "i": np.array([1, 2, 3, 4], np.int32)},
                                   **kw),
        "b": mod.Table.from_pydict({"y": np.array([0.0, 2.25, 1.5]), "j": np.array([10, 20, 30], np.int32)}, **kw),
        "s": mod.Table.from_pydict({"g": ["x", "y"], "v": np.array([1.0, 2.0])}, **kw),
        "n": mod.Table.from_arrays(
            mod.Schema([mod.Field("x", D.Float64, True), mod.Field("d", D.Date32)]),
            [np.array([1.0, 0.0]), np.array(["2021-01-01", "2021-06-15"], "datetime64[D]")],
            validity=[np.array([True, False]), None], **kw),
    }


SCENARIOS = {
    "ctas_roundtrip": [
        "CREATE TABLE agg AS SELECT g, SUM(v) AS total FROM t GROUP BY g",
        "SELECT g, total FROM agg ORDER BY g",
        "SELECT t.g, v, total FROM t JOIN agg ON t.g = agg.g ORDER BY v",
    ],
    "ctas_nulls_and_dates": [
        "CREATE TABLE c2 AS SELECT x, d, YEAR(d) AS y FROM t2",
        "SELECT x, d, y FROM c2 ORDER BY d",
        "DESCRIBE c2",
    ],
    "ctas_timestamps": [
        "CREATE TABLE c AS SELECT k, ts FROM e WHERE k < 3",
        "SELECT k, ts FROM c ORDER BY k",
        "CREATE TABLE c3 AS SELECT k, ts + INTERVAL '1' MONTH AS m, CAST(ts AS DATE) AS day FROM e",
        "SELECT k, m, day, HOUR(m) FROM c3 ORDER BY k",
    ],
    "ctas_cte_and_setop": [
        "CREATE TABLE u AS WITH lo AS (SELECT v FROM t WHERE v < 3) SELECT v FROM t EXCEPT SELECT v FROM lo",
        "SELECT v FROM u ORDER BY v",
    ],
    "show_and_describe": [
        "CREATE TABLE agg AS SELECT g, SUM(v) AS total FROM t GROUP BY g",
        "SHOW TABLES",
        "DESCRIBE agg",
        "DESCRIBE t2",
        "DESCRIBE nope",
    ],
    "drop_table": [
        "CREATE TABLE c AS SELECT v FROM t",
        "DROP TABLE c",
        "SHOW TABLES",
        "DROP TABLE IF EXISTS c",
        "DROP TABLE c",
        "SELECT v FROM c",
    ],
    "ddl_has_no_plan": ["EXPLAIN DROP TABLE t", "EXPLAIN SHOW TABLES"],
    "join_on_float_keys": ["SELECT i, j FROM a JOIN b ON a.x = b.y ORDER BY i"],
    "insert_values_and_select": [
        "INSERT INTO s VALUES ('z', 3.5), ('w', 4)",
        "SELECT g, v FROM s ORDER BY v",
        "INSERT INTO s (v, g) VALUES (9, 'q')",
        "SELECT g, v FROM s ORDER BY v",
        "INSERT INTO s SELECT g, v * 10 FROM s WHERE v < 2",
        "SELECT COUNT(v) FROM s",
        "SELECT g, v FROM s ORDER BY v, g",
    ],
    "insert_nulls_and_temporals": [
        "INSERT INTO n VALUES (7.5, DATE '2022-02-02')",
        "SELECT x, d FROM n ORDER BY d",
        "INSERT INTO e VALUES (4, TIMESTAMP '1969-12-31 23:59:59')",
        "SELECT k, ts, YEAR(ts) FROM e ORDER BY ts",
    ],
    "insert_errors": [
        "INSERT INTO s VALUES ('only-one')",
        "INSERT INTO s (g) VALUES ('partial')",
        "INSERT INTO missing VALUES (1, 2)",
        "SELECT g, v FROM s ORDER BY v",
    ],
    "values_and_string_literals": [
        "VALUES (1, 'a'), (2, 'b')",
        "SELECT 'tag', v FROM t ORDER BY v",
    ],
}


def _run(ctx, sql, err):
    try:
        return ctx.sql(sql).result_str()
    except err as e:
        return ("PlanError", type(e).__name__)


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_statements_match_jax(scenario, mesh):
    r = ref.ExecutionContext()
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")) if mesh else port.ExecutionContext(device="cpu")
    for name, t in _tables(ref).items():
        r.register_table(name, t)
    for name, t in _tables(port, "cpu").items():
        p.register_table(name, t)
    for sql in SCENARIOS[scenario]:
        want = _run(r, sql, RefPlanError)
        got = _run(p, sql, PlanError)
        if isinstance(want, tuple):
            assert isinstance(got, tuple), (sql, got)
        else:
            assert got == want, sql


def test_plan_refuses_catalog_statements():
    p = port.ExecutionContext(device="cpu")
    for sql in ("SHOW TABLES", "DROP TABLE t", "CREATE TABLE c AS SELECT 1"):
        with pytest.raises(PlanError):
            p.plan(sql)


def test_ctas_and_insert_keep_the_device():
    """A CTAS or INSERT table lives on the context's device, as every
    registered table, and a mesh context partitions it per query."""
    p = port.ExecutionContext(device="cpu")
    for name, t in _tables(port, "cpu").items():
        p.register_table(name, t)
    p.sql("CREATE TABLE agg AS SELECT g, SUM(v) AS total FROM t GROUP BY g")
    p.sql("INSERT INTO t VALUES ('c', 5.0)")
    assert p.table("agg").device.type == "cpu" and p.table("t").device.type == "cpu"
    assert p.table("t").num_rows == 5
    assert p.sql("SELECT g, COUNT(v) FROM t GROUP BY g ORDER BY g").result_str() == '"a"\t2\n"b"\t2\n"c"\t1\n'
