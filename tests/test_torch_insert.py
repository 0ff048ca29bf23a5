"""INSERT INTO in the torch port: the table is rebuilt on the device.

The port concatenates the table's columns with the new rows' (data,
validity, and Utf8 codes mapped onto the merged sorted vocabulary) and
decodes nothing. Wherever the JAX package's INSERT succeeds the rows must
equal its own (`result_str`, on one device and on a mesh of 8 shards);
where it fails on a value outside Python's `datetime` range (INT_MIN
days), the port keeps the value.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_make_mesh

INT_MIN, INT_MAX = -(2**31), 2**31 - 1


def _tables(mod, device=None):
    kw = {} if device is None else {"device": device}
    D = mod.DataType
    return {
        "s": mod.Table.from_pydict({"g": ["x", None, "y"], "v": np.array([1.0, 2.0, 3.0])}, **kw),
        "w": mod.Table.from_pydict({"g": ["a", "zz", "y"], "v": np.array([7.0, 8.0, 9.0])}, **kw),
        "dd": mod.Table.from_arrays(
            mod.Schema([mod.Field("k", D.Int32), mod.Field("d", D.Date32, True)]),
            [np.array([1, 2, 3, 4], np.int32), np.array([0, 18628, 7, -25567], np.int32)],
            validity=[None, np.array([True, True, False, True])], **kw),
    }


def _pair(mesh):
    r = ref.ExecutionContext(mesh=ref_make_mesh() if mesh else None)
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")) if mesh else port.ExecutionContext(device="cpu")
    for name, t in _tables(ref).items():
        r.register_table(name, t)
    for name, t in _tables(port, "cpu").items():
        p.register_table(name, t)
    return r, p


SCENARIOS = {
    "dictionaries_merge": [
        "INSERT INTO s SELECT g, v FROM w",
        "SELECT g, v FROM s ORDER BY g, v",
        "SELECT g, COUNT(v), MAX(v) FROM s GROUP BY g ORDER BY g",
        "SELECT g FROM s WHERE g > 'x' ORDER BY g",
    ],
    "nulls_and_values": [
        "INSERT INTO s VALUES ('b', 5.0), ('x', 6.5)",
        "INSERT INTO s SELECT g, v * 2 FROM s WHERE g IS NULL",
        "SELECT g, v FROM s ORDER BY v",
        "SELECT COUNT(g), COUNT(v), MIN(g) FROM s",
    ],
    "dates": [
        "CREATE TABLE e AS SELECT k, d FROM dd WHERE k < 3",
        "INSERT INTO e SELECT k, d FROM dd WHERE k > 2",
        "INSERT INTO e VALUES (CAST(9 AS INT), DATE '2000-02-29')",
        "SELECT k, d, YEAR(d) FROM e ORDER BY k",
    ],
    "into_itself": [
        "INSERT INTO dd SELECT k + CAST(10 AS INT), d FROM dd",
        "SELECT k, d FROM dd ORDER BY k",
    ],
}


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_insert_matches_jax(scenario, mesh):
    r, p = _pair(mesh)
    for sql in SCENARIOS[scenario]:
        assert p.sql(sql).result_str() == r.sql(sql).result_str(), sql


def test_insert_keeps_days_outside_datetime():
    """`INSERT INTO e SELECT d FROM dd` with INT_MIN / INT_MAX days: the
    JAX package decodes every cell to a `datetime.date` and raises
    OverflowError; the port keeps the days, as CTAS does."""
    edge = {"d": np.array([INT_MIN, 0, INT_MAX], np.int32)}
    r = ref.ExecutionContext()
    p = port.ExecutionContext(device="cpu")
    for c, mod, kw in ((r, ref, {}), (p, port, {"device": "cpu"})):
        schema = mod.Schema([mod.Field("d", mod.DataType.Date32)])
        c.register_table("dd", mod.Table.from_arrays(schema, [edge["d"]], **kw))
        c.sql("CREATE TABLE e AS SELECT d FROM dd WHERE d = DATE '1970-01-01'")
    with pytest.raises(OverflowError):
        r.sql("INSERT INTO e SELECT d FROM dd")
    p.sql("INSERT INTO e SELECT d FROM dd")
    t = p.table("e")
    assert t.num_rows == 4 and t.columns[0].data.tolist() == [0, INT_MIN, 0, INT_MAX]
    assert p.sql("SELECT COUNT(d) FROM e WHERE d > DATE '1970-01-01'").result_str() == "1\n"


def test_insert_into_a_lazy_csv_table(data_dir):
    """The target's columns parse on the insert; the rebuilt table is an
    ordinary table on the context's device."""
    r = ref.ExecutionContext()
    p = port.ExecutionContext(device="cpu")
    for c, mod in ((r, ref), (p, port)):
        D = mod.DataType
        c.register_csv("t2", str(data_dir / "aggregate_test_2.csv"),
                       mod.Schema([mod.Field("a", D.Utf8, False), mod.Field("b", D.Float64, False)]))
        c.sql("INSERT INTO t2 VALUES ('four', 9.5)")
    sql = "SELECT a, MIN(b), MAX(b), COUNT(b) FROM t2 GROUP BY a ORDER BY a"
    assert p.sql(sql).result_str() == r.sql(sql).result_str()
    assert p.table("t2").device.type == "cpu" and p.table("t2").num_rows == 8
