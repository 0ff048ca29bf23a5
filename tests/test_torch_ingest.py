"""NDJSON and Parquet ingest, EXPLAIN and `last_stats` through the torch
port against the JAX package.

The SQL and files of tests/test_explain_ndjson.py, plus STORED AS NDJSON /
PARQUET DDL, both Parquet fixtures read with their inferred schema and a
declared one, the pyarrow reader against its pandas fallback, the error
when neither library imports, and DROP TABLE dropping a table's source.
Every statement runs through `datafusion_tpu.ExecutionContext` and the
port on the CPU; `result_str` must be equal byte for byte.
"""

import json
import sys

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.columnar.parquet import _read_parquet_pandas as ref_read_pandas
from datafusion_tpu.columnar.parquet import read_parquet as ref_read_parquet
from datafusion_tpu.errors import ExecutionError as RefExecutionError
from datafusion_tpu_torch.columnar.parquet import _read_parquet_pandas, read_parquet
from datafusion_tpu_torch.errors import ExecutionError


def _pair():
    return ref.ExecutionContext(), port.ExecutionContext(device="cpu")


def _same(r, p, statements):
    """Run each statement in both contexts; the last result_str of each
    statement must be equal."""
    for sql in statements:
        want, got = r.sql(sql).result_str(), p.sql(sql).result_str()
        assert got == want, sql


def _agg_schema(mod):
    return mod.Schema([mod.Field("a", mod.DataType.Int32, False), mod.Field("b", mod.DataType.Float64, False)])


def test_explain(data_dir):
    r, p = _pair()
    for c, mod in ((r, ref), (p, port)):
        c.register_csv("t1", str(data_dir / "aggregate_test_1.csv"), _agg_schema(mod))
    _same(r, p, ["EXPLAIN SELECT a, MIN(b) FROM t1 WHERE b > 1 GROUP BY a"])
    assert p.table("t1").materialized_columns() == []


def test_ndjson_source(data_dir):
    r, p = _pair()
    _same(r, p, [
        "CREATE EXTERNAL TABLE j (a INT NOT NULL, b VARCHAR(100) NOT NULL, c DOUBLE NOT NULL) "
        f"STORED AS NDJSON LOCATION '{data_dir}/example1.ndjson'",
        "SELECT a, b, c FROM j ORDER BY a",
        "SELECT b, c * 2 FROM j WHERE a > 1",
        "SELECT COUNT(a), SUM(c), MAX(b) FROM j",
        "DESCRIBE j",
    ])
    assert p.sql("SELECT a, b, c FROM j ORDER BY a").result_str() == (
        '1\t"this is a string"\t12.34\n'
        '2\t"this is also a string"\t43.21\n'
        '3\t"is this a string too?"\t0.0\n'
    )


def test_ndjson_missing_fields_and_nulls(tmp_path):
    path = tmp_path / "n.ndjson"
    rng = np.random.default_rng(5)
    with open(path, "w") as f:
        for i in range(400):
            rec = {"k": int(rng.integers(0, 9)), "v": float(rng.random()), "mode": ["AIR", "RAIL", "SHIP"][i % 3]}
            if i % 7 == 0:
                rec["mode"] = None
            if i % 11 == 0:
                del rec["v"]
            f.write(json.dumps(rec) + "\n")
    r, p = _pair()
    _same(r, p, [
        f"CREATE EXTERNAL TABLE n (k INT, v DOUBLE, mode VARCHAR(10)) STORED AS NDJSON LOCATION '{path}'",
        "SELECT mode, COUNT(v), MIN(v), MAX(k) FROM n GROUP BY mode ORDER BY mode",
        "SELECT k, v, mode FROM n WHERE v IS NULL OR mode IS NULL ORDER BY k, v",
    ])


def test_last_stats(data_dir):
    _, p = _pair()
    p.register_csv("t1", str(data_dir / "aggregate_test_1.csv"), _agg_schema(port))
    assert p.last_stats == {}
    p.sql("SELECT a FROM t1")
    stats = p.last_stats
    assert set(stats) == {"parse_s", "plan_s", "execute_s", "rows"}
    assert stats["rows"] == 7
    assert all(stats[k] >= 0 for k in ("parse_s", "plan_s", "execute_s"))
    p.sql("DROP TABLE t1")  # a statement leaves the last query's stats
    assert p.last_stats is stats


PARQUET_CASES = {
    "alltypes_inferred": [
        "CREATE EXTERNAL TABLE p STORED AS PARQUET LOCATION '{data}/alltypes_plain.parquet'",
        "SELECT id, bool_col, int_col, double_col FROM p ORDER BY id LIMIT 3",
        "SELECT COUNT(*), MAX(bigint_col) FROM p",
        "SELECT id, string_col, date_string_col, timestamp_col, float_col FROM p ORDER BY id",
        "DESCRIBE p",
    ],
    "alltypes_declared": [
        "CREATE EXTERNAL TABLE p2 (id INT NOT NULL, string_col VARCHAR(10) NOT NULL) "
        "STORED AS PARQUET LOCATION '{data}/alltypes_plain.parquet'",
        "SELECT id, string_col FROM p2 ORDER BY id LIMIT 2",
        "SELECT string_col, COUNT(id) FROM p2 GROUP BY string_col",
    ],
    "flat_inferred": [
        "CREATE EXTERNAL TABLE f STORED AS PARQUET LOCATION '{data}/all_types_flat.parquet'",
        "DESCRIBE f",
        "SELECT c_bool, MIN(c_int8), MAX(c_int64), MIN(c_float32), MAX(c_utf8) FROM f GROUP BY c_bool ORDER BY c_bool",
        "SELECT c_utf8, c_float64, c_uint32 FROM f WHERE c_float64 < 0.1 ORDER BY c_float64 LIMIT 10",
    ],
    "flat_declared": [
        "CREATE EXTERNAL TABLE f2 (c_int16 SMALLINT NOT NULL, c_float64 DOUBLE NOT NULL, c_utf8 VARCHAR(20)) "
        "STORED AS PARQUET LOCATION '{data}/all_types_flat.parquet'",
        "SELECT c_int16, c_float64, c_utf8 FROM f2 ORDER BY c_float64 LIMIT 5",
        "SELECT COUNT(c_utf8), SUM(c_int16) FROM f2",
    ],
}


@pytest.mark.parametrize("case", list(PARQUET_CASES))
def test_parquet_sources(case, data_dir):
    r, p = _pair()
    _same(r, p, [sql.format(data=data_dir) for sql in PARQUET_CASES[case]])


def test_register_parquet(data_dir):
    r, p = _pair()
    for c in (r, p):
        c.register_parquet("p", str(data_dir / "alltypes_plain.parquet"))
    _same(r, p, ["SELECT id, int_col FROM p ORDER BY id LIMIT 4", "SELECT tinyint_col, COUNT(id) FROM p GROUP BY tinyint_col"])


@pytest.fixture(scope="module")
def strings_parquet(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(3)
    n = 20_000
    t = pa.table({
        "s": pa.array([f"name_{i:04d}" for i in rng.integers(0, 700, n)]),
        "v": pa.array(rng.random(n)),
        "i": pa.array(rng.integers(0, 1000, n)),
    })
    path = str(tmp_path_factory.mktemp("pq") / "strings.parquet")
    pq.write_table(t, path)
    return path, n


def test_parquet_pyarrow_equals_pandas(strings_parquet):
    """The pyarrow reader and the pandas fallback give one table: equal
    schemas, decoded strings, sorted (order-preserving) vocabularies, and
    the JAX package's codes."""
    path, n = strings_parquet
    ta, tb = read_parquet(path, device="cpu"), _read_parquet_pandas(path, device="cpu")
    assert ta.schema.to_string() == tb.schema.to_string() == ref_read_parquet(path).schema.to_string()
    for j in range(len(ta.schema)):
        np.testing.assert_array_equal(ta.columns[j].to_numpy(n), tb.columns[j].to_numpy(n))
    va = ta.columns[0].dictionary
    assert list(va) == sorted(va) and tb.columns[0].dictionary == va
    for jt in (ref_read_parquet(path), ref_read_pandas(path)):
        assert jt.columns[0].dictionary == va
        np.testing.assert_array_equal(np.asarray(jt.columns[0].data)[:n], ta.columns[0].data.numpy())


def test_parquet_without_pyarrow_or_pandas(monkeypatch, data_dir):
    """Where neither library imports, both packages raise ExecutionError."""
    path = str(data_dir / "alltypes_plain.parquet")
    for name in ("pyarrow", "pyarrow.compute", "pyarrow.parquet", "pandas"):
        monkeypatch.setitem(sys.modules, name, None)  # `import name` raises ImportError
    with pytest.raises(RefExecutionError, match="requires pyarrow or pandas"):
        ref_read_parquet(path)
    with pytest.raises(ExecutionError, match="requires pyarrow or pandas"):
        read_parquet(path, device="cpu")
    with pytest.raises(ExecutionError):
        port.ExecutionContext(device="cpu").sql(f"CREATE EXTERNAL TABLE p STORED AS PARQUET LOCATION '{path}'")


def test_drop_table_drops_its_source(data_dir):
    """After DROP TABLE, a table registered again under the name from
    memory ships without the dropped file's source."""
    r, p = _pair()
    for c, mod in ((r, ref), (p, port)):
        c.sql(f"CREATE EXTERNAL TABLE j (a INT NOT NULL, b VARCHAR(100) NOT NULL, c DOUBLE NOT NULL) "
              f"STORED AS NDJSON LOCATION '{data_dir}/example1.ndjson'")
        c.sql("DROP TABLE j")
        kw = {} if mod is ref else {"device": "cpu"}
        c.register_table("j", mod.Table.from_pydict({"a": np.arange(3, dtype=np.int32)}, **kw))
    shipped = p.serialize_plan("SELECT a FROM j")
    assert shipped == r.serialize_plan("SELECT a FROM j")
    assert '"source": null' in shipped
    assert "j" not in p._table_sources
