"""Plan shipping in the torch port against the JAX package.

The cases of tests/test_plan_shipping.py: `serialize_plan` stamps each
scan of a file-backed table with its source ({file_type, path,
has_header}) and its JSON text equals the JAX package's for the same SQL
and paths; a plan shipped by either package runs in a fresh context of
the other and returns the same rows; an in-memory table still needs
registering. Plus `last_stats` after a shipped run's query.
"""

import json

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu_torch.columnar.csv import LazyCsvTable
from datafusion_tpu_torch.errors import ExecutionError


def _cities(mod):
    D = mod.DataType
    return mod.Schema([mod.Field("city", D.Utf8, False), mod.Field("lat", D.Float64, False),
                       mod.Field("lng", D.Float64, False)])


def _agg(mod):
    D = mod.DataType
    return mod.Schema([mod.Field("a", D.Int32, False), mod.Field("b", D.Float64, False)])


def _contexts(data_dir, tmp_path):
    """A JAX and a port context with the same CSV, Parquet and NDJSON
    tables registered."""
    nd = tmp_path / "j.ndjson"
    nd.write_text("".join(json.dumps({"k": i % 4, "v": i * 0.5}) + "\n" for i in range(40)))
    out = []
    for mod, kw in ((ref, {}), (port, {"device": "cpu"})):
        c = mod.ExecutionContext(**kw)
        c.register_csv("cities", str(data_dir / "uk_cities.csv"), _cities(mod), has_header=False)
        c.register_csv("t1", str(data_dir / "aggregate_test_1.csv"), _agg(mod))
        c.register_parquet("p", str(data_dir / "alltypes_plain.parquet"))
        c.sql(f"CREATE EXTERNAL TABLE j (k INT NOT NULL, v DOUBLE NOT NULL) STORED AS NDJSON LOCATION '{nd}'")
        out.append(c)
    return out


QUERIES = [
    "SELECT city, lat FROM cities WHERE lat > 52 ORDER BY lat LIMIT 5",
    "SELECT city FROM cities",
    "SELECT a, MIN(b), MAX(b) FROM t1 GROUP BY a ORDER BY a",
    "SELECT id, int_col FROM p ORDER BY id LIMIT 4",
    "SELECT k, SUM(v) FROM j GROUP BY k ORDER BY k",
    "SELECT t1.a, p.id FROM t1 JOIN p ON t1.a = p.id ORDER BY t1.a, p.id",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_serialized_plan_equals_jax_and_runs_across(sql, data_dir, tmp_path):
    r, p = _contexts(data_dir, tmp_path)
    shipped = p.serialize_plan(sql)
    assert shipped == r.serialize_plan(sql)
    want = r.sql(sql).result_str()
    assert p.sql(sql).result_str() == want
    # each package runs the other's plan in a fresh context
    fresh = port.ExecutionContext(device="cpu")
    assert fresh._tables == {}
    assert fresh.execute_plan_json(r.serialize_plan(sql)).result_str() == want
    assert ref.ExecutionContext().execute_plan_json(shipped).result_str() == want


def test_shipped_json_names_the_source(data_dir, tmp_path):
    _, p = _contexts(data_dir, tmp_path)

    def scans(d):
        (kind, body), = d.items()
        if kind == "TableScan":
            yield body
        for key in ("input", "left", "right"):
            if key in body:
                yield from scans(body[key])

    (scan,) = scans(json.loads(p.serialize_plan("SELECT city FROM cities")))
    assert scan["source"] == {"file_type": "csv", "path": str(data_dir / "uk_cities.csv"), "has_header": False}
    (scan,) = scans(json.loads(p.serialize_plan("SELECT v FROM j")))
    assert scan["source"]["file_type"] == "ndjson"


def test_fresh_context_loads_csv_lazily(data_dir, tmp_path):
    """A shipped CSV scan registers its file as a lazy table of the fresh
    context, which parses only the scanned columns."""
    _, p = _contexts(data_dir, tmp_path)
    fresh = port.ExecutionContext(device="cpu")
    res = fresh.execute_plan_json(p.serialize_plan("SELECT lat FROM cities WHERE lat > 57"))
    assert res.result_str() == "57.653484\n57.149651\n57.477772\n"
    t = fresh.table("cities")
    assert isinstance(t, LazyCsvTable) and t.materialized_columns() == [1]
    fresh.sql("SELECT COUNT(city) FROM cities")
    assert fresh.last_stats["rows"] == 1 and t.materialized_columns() == [0, 1]


def test_in_memory_table_plan_still_needs_registration():
    src = port.ExecutionContext(device="cpu")
    src.register_table("m", port.Table.from_pydict({"a": np.arange(4, dtype=np.int32)}, device="cpu"))
    shipped = src.serialize_plan("SELECT a FROM m")
    with pytest.raises(ExecutionError):
        port.ExecutionContext(device="cpu").execute_plan_json(shipped)


def test_unknown_source_type_is_refused(data_dir, tmp_path):
    _, p = _contexts(data_dir, tmp_path)
    shipped = p.serialize_plan("SELECT a FROM t1").replace('"file_type": "csv"', '"file_type": "orc"')
    with pytest.raises(ExecutionError, match="unknown source file_type 'orc'"):
        port.ExecutionContext(device="cpu").execute_plan_json(shipped)


def test_last_stats_keys(data_dir, tmp_path):
    r, p = _contexts(data_dir, tmp_path)
    for c in (r, p):
        c.sql("SELECT a, b FROM t1 WHERE b > 2")
    assert set(p.last_stats) == set(r.last_stats) == {"parse_s", "plan_s", "execute_s", "rows"}
    assert p.last_stats["rows"] == r.last_stats["rows"] == 4
