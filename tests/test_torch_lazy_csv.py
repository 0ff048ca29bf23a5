"""Lazy CSV scans in the torch port against the JAX package.

The cases of tests/test_lazy_csv.py: registration parses no column, a
query parses exactly the columns its narrowed scans read, a join narrows
each side, lazy equals eager byte for byte, Utf8 and NULLs, and a mesh
context stays eager. Every query also runs through the JAX package's
lazy table, and `result_str` must be equal.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu_torch.columnar.csv import LazyCsvTable

NCOLS = 10


def _wide_schema(mod):
    return mod.Schema([mod.Field(f"c{j}", mod.DataType.Float64, False) for j in range(NCOLS)])


@pytest.fixture()
def wide_csv(tmp_path):
    rng = np.random.default_rng(6)
    n = 500
    p = tmp_path / "wide.csv"
    cols = [rng.random(n) * 100 for _ in range(NCOLS)]
    with open(p, "w") as f:
        f.write(",".join(f"c{j}" for j in range(NCOLS)) + "\n")
        for i in range(n):
            f.write(",".join(f"{cols[j][i]:.6f}" for j in range(NCOLS)) + "\n")
    return str(p), cols


def _pair(name, path, schema_of, **kw):
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    r.register_csv(name, path, schema_of(ref), **kw)
    p.register_csv(name, path, schema_of(port), **kw)
    return r, p


def test_lazy_registration_parses_nothing(wide_csv):
    path, _ = wide_csv
    _, p = _pair("w", path, _wide_schema)
    t = p.table("w")
    assert isinstance(t, LazyCsvTable)
    assert t.materialized_columns() == []
    assert t.num_rows == 500
    # the device and a move to another device parse nothing either
    assert t.device.type == "cpu" and t.to("cpu") is t
    moved = t.to("meta")
    assert isinstance(moved, LazyCsvTable) and moved.device.type == "meta" and moved.num_rows == 500
    assert t.materialized_columns() == [] == moved.materialized_columns()


def test_query_parses_only_scanned_columns(wide_csv):
    path, cols = wide_csv
    r, p = _pair("w", path, _wide_schema)
    sql = "SELECT c2, c7 FROM w WHERE c2 > 50 ORDER BY c2 LIMIT 5"
    out = p.sql(sql)
    assert p.table("w").materialized_columns() == [2, 7]
    assert out.result_str() == r.sql(sql).result_str()
    want = sorted(float(f"{c:.6f}") for c in cols[2] if float(f"{c:.6f}") > 50)[:5]
    np.testing.assert_allclose([row["c2"] for row in out.to_pylist()], want, rtol=1e-12)
    # a second query parses only what it adds
    p.sql("SELECT SUM(c4) FROM w WHERE c7 < 10")
    assert p.table("w").materialized_columns() == [2, 4, 7]


def test_join_narrows_each_side(wide_csv, tmp_path):
    path, _ = wide_csv
    p2 = tmp_path / "dim.csv"
    with open(p2, "w") as f:
        f.write("k,x,y,z\n")
        for i in range(50):
            f.write(f"{i},{i * 1.5},{i * 2.5},{i * 3.5}\n")

    def dim_schema(mod):
        D = mod.DataType
        return mod.Schema([mod.Field("k", D.Int32, False)] + [mod.Field(c, D.Float64, False) for c in "xyz"])

    r, p = _pair("w", path, _wide_schema)
    r.register_csv("d", str(p2), dim_schema(ref))
    p.register_csv("d", str(p2), dim_schema(port))
    # c0 casts to an int join key: only c0 / c3 of w, k / y of d are read
    sql = "SELECT c3, y FROM w JOIN d ON CAST(c0 AS INT) = d.k WHERE c3 > 10 ORDER BY c3"
    assert p.sql(sql).result_str() == r.sql(sql).result_str()
    assert p.table("w").materialized_columns() == [0, 3]
    assert p.table("d").materialized_columns() == [0, 2]


@pytest.mark.parametrize("sql", [
    "SELECT c0, c5 + c6 FROM w WHERE c1 < 30 ORDER BY c0 LIMIT 20",
    "SELECT COUNT(c9), MIN(c4), MAX(c4) FROM w",
    "SELECT c8 FROM w WHERE c8 > 99",
])
def test_lazy_matches_eager_byte_exact(wide_csv, sql):
    path, _ = wide_csv
    r, lazy = _pair("w", path, _wide_schema)
    eager = port.ExecutionContext(device="cpu")
    eager.register_csv("w", path, _wide_schema(port), lazy=False)
    assert not isinstance(eager.table("w"), LazyCsvTable)
    got = lazy.sql(sql).result_str()
    assert got == eager.sql(sql).result_str() == r.sql(sql).result_str()


def test_lazy_utf8_and_nulls(tmp_path):
    p = tmp_path / "s.csv"
    with open(p, "w") as f:
        f.write("name,v,unused\nbeta,1,9\nalpha,,8\ngamma,3,7\n")

    def schema(mod):
        D = mod.DataType
        return mod.Schema([mod.Field("name", D.Utf8, False), mod.Field("v", D.Int32, True),
                           mod.Field("unused", D.Int32, False)])

    r, c = _pair("s", str(p), schema)
    sql = "SELECT name, v FROM s ORDER BY name"
    rows = c.sql(sql).to_pylist()
    assert [row["name"] for row in rows] == ["alpha", "beta", "gamma"]
    assert rows[0]["v"] is None and rows[1]["v"] == 1
    assert c.table("s").materialized_columns() == [0, 1]
    assert c.sql(sql).result_str() == r.sql(sql).result_str()
    assert c.sql("SELECT name FROM s WHERE name > 'b'").result_str() == '"beta"\n"gamma"\n'


def test_mesh_context_stays_eager(wide_csv):
    path, _ = wide_csv
    mesh = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    mesh.register_csv("w", path, _wide_schema(port))
    assert not isinstance(mesh.table("w"), LazyCsvTable)
    r, _ = _pair("w", path, _wide_schema)
    sql = "SELECT c0, c1 FROM w WHERE c2 < 20 ORDER BY c0"
    assert mesh.sql(sql).result_str() == r.sql(sql).result_str()
