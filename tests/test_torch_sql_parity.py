"""SQL parity: the JAX package (the reference) vs the torch port on the CPU.

Each SQL string runs through `datafusion_tpu.ExecutionContext` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
tables, and `result_str()` must match byte for byte. The exception is
float SUM/AVG columns, compared at rtol=1e-12: the port's ungrouped sums
are torch reductions and its grouped sums run through kernel K2's plain
version, whose accumulation order may differ from XLA's in the last bit.

Generated tables are built once by the JAX package and carried into the
port with `Table.from_reference_arrays`, so both engines see identical
buffers.
"""

import math

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port

D = ref.DataType


def _schema(mod, fields):
    return mod.Schema([mod.Field(n, mod.DataType[t.name], nl) for n, t, nl in fields])


CSV_TABLES = {
    "cities": ("uk_cities.csv", [("city", D.Utf8, False), ("lat", D.Float64, False), ("lng", D.Float64, False)]),
    "t1": ("aggregate_test_1.csv", [("a", D.Int32, False), ("b", D.Float64, False)]),
    "t2": ("aggregate_test_2.csv", [("a", D.Utf8, False), ("b", D.Float64, False)]),
    "nulls": ("null_test.csv", [("c1", D.Int32, True), ("c2", D.Float64, True), ("c3", D.Utf8, True)]),
}

GEN_FIELDS = [
    ("k", D.Int32, False), ("d", D.Int32, False), ("lat", D.Float64, False),
    ("lng", D.Float64, False), ("nv", D.Float64, True), ("nk", D.Int32, True),
    ("s", D.Utf8, False), ("i64", D.Int64, False), ("f", D.Float32, False),
    ("u8", D.UInt8, False), ("u16", D.UInt16, False), ("u32", D.UInt32, False),
    ("i8", D.Int8, False),
]


def generated_arrays(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.integers(0, 50, n).astype(np.int32),
        rng.integers(0, 100_000, n).astype(np.int32),  # wide domain: packed path
        rng.random(n) * 40 + 30,
        rng.random(n) * 360 - 180,
        rng.random(n) * 10,
        rng.integers(-3, 4, n).astype(np.int32),
        list(rng.choice(["apple", "b", "cherry", "date"], n)),
        rng.integers(-(10**12), 10**12, n).astype(np.int64),
        (rng.integers(0, 8, n) * 0.25).astype(np.float32),
        rng.integers(0, 256, n).astype(np.uint8),
        rng.integers(0, 65536, n).astype(np.uint16),
        rng.integers(0, 2**32, n).astype(np.uint32),
        rng.integers(-128, 128, n).astype(np.int8),
    ]
    validity = [None] * len(arrays)
    validity[4] = rng.random(n) > 0.2
    validity[5] = rng.random(n) > 0.1
    return arrays, validity


@pytest.fixture(scope="module")
def contexts(data_dir):
    r = ref.ExecutionContext()
    p = port.ExecutionContext(device="cpu")
    for name, (fname, fields) in CSV_TABLES.items():
        r.register_datasource(name, ref.CsvDataSource(str(data_dir / fname), _schema(ref, fields)))
        p.register_datasource(name, port.CsvDataSource(str(data_dir / fname), _schema(port, fields)))
    arrays, validity = generated_arrays()
    jt = ref.Table.from_arrays(_schema(ref, GEN_FIELDS), arrays, validity=validity)
    r.register_table("t", jt)
    p.register_table(
        "t",
        port.Table.from_reference_arrays(
            _schema(port, GEN_FIELDS).fields,
            [np.asarray(c.data) for c in jt.columns],
            [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
            [c.dictionary for c in jt.columns],
            device="cpu",
            num_rows=jt.num_rows,
        ),
    )
    return r, p


# (sql, indices of float SUM/AVG columns compared at rtol=1e-12)
CASES = [
    # uk_cities filter / project (tests/sql.rs:29-43, examples/csv_sql)
    ("SELECT city, lat, lng, lat + lng FROM cities WHERE lat > 51.0 AND lat < 53", ()),
    ("SELECT city, lat, lng FROM cities WHERE lat > 51.0 AND lat < 53", ()),
    ("SELECT CAST(lat AS int) FROM cities", ()),
    ("SELECT city FROM cities WHERE city = 'London, UK'", ()),
    ("SELECT city, lat FROM cities WHERE city > 'M' ORDER BY lat DESC LIMIT 5", ()),
    ("SELECT MIN(lat), MAX(lat), MIN(lng), MAX(lng) FROM cities", ()),
    # GROUP BY int / string MIN/MAX, SUM/COUNT/AVG, ungrouped, COUNT(*)
    ("SELECT a, MIN(b), MAX(b) FROM t1 GROUP BY a", ()),
    ("SELECT a, MIN(b), MAX(b) FROM t2 GROUP BY a", ()),
    ("SELECT a, SUM(b), COUNT(b), AVG(b) FROM t1 GROUP BY a ORDER BY a", (1, 3)),
    ("SELECT MIN(b), MAX(b), SUM(b), COUNT(b) FROM t1", (2,)),
    ("SELECT COUNT(*) FROM t1", ()),
    ("SELECT COUNT(1) FROM t1", ()),
    # ORDER BY ASC / DESC / multi-key, LIMIT
    ("SELECT a, b FROM t1 ORDER BY b", ()),
    ("SELECT a, b FROM t1 ORDER BY b DESC LIMIT 3", ()),
    ("SELECT a, b FROM t1 ORDER BY a DESC, b ASC", ()),
    ("SELECT a FROM t1 LIMIT 2", ()),
    # CAST, sqrt, string filters
    ("SELECT b, sqrt(b) FROM t1 ORDER BY b LIMIT 2", ()),
    ("SELECT b FROM t2 WHERE a = 'one' ORDER BY b", ()),
    ("SELECT a, COUNT(a) FROM t2 WHERE a > 'three' GROUP BY a", ()),
    ("SELECT b FROM t2 WHERE a = 'absent'", ()),
    ("SELECT 1", ()),
    ("SELECT 1 + 2", ()),
    # NULLs
    ("SELECT c1 FROM nulls WHERE c1 IS NOT NULL", ()),
    ("SELECT c1 FROM nulls WHERE c1 IS NULL", ()),
    ("SELECT COUNT(*) FROM nulls", ()),
    ("SELECT c1, c2 + 1, c2 IS NULL FROM nulls", ()),
    ("SELECT c3, COUNT(c2), SUM(c2), MIN(c2) FROM nulls GROUP BY c3", (2,)),
    # c1 and c2 shapes at a small size; k is a dense domain, d a wide one
    ("SELECT k, lat, lng, lat + lng FROM t WHERE lat > 51.0 AND lat < 53", ()),
    ("SELECT k, MIN(lat), MAX(lat), SUM(lng), COUNT(lat) FROM t GROUP BY k", (3,)),
    ("SELECT d, MIN(lat), MAX(lat), SUM(lng), COUNT(lat) FROM t GROUP BY d", (3,)),
    ("SELECT d, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM t GROUP BY d ORDER BY d LIMIT 10", (1, 2)),
    ("SELECT k, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM t GROUP BY k ORDER BY k LIMIT 10", (1, 2)),
    # the generic co-sort path (float key), a nullable key, multi-key
    ("SELECT f, COUNT(*), SUM(lat) FROM t GROUP BY f", (2,)),
    ("SELECT nk, COUNT(nk), AVG(lat), MAX(nv) FROM t GROUP BY nk", (2,)),
    ("SELECT s, k, SUM(i64), MAX(f), MIN(nv) FROM t GROUP BY s, k", ()),
    ("SELECT k, AVG(k), SUM(k), MIN(i8), MAX(i8) FROM t GROUP BY k", ()),
    ("SELECT u8, SUM(u8), MIN(u16), MAX(u32), COUNT(*) FROM t GROUP BY u8", ()),
    ("SELECT SUM(i64), AVG(k), MIN(s), MAX(s), COUNT(nv), SUM(lng) FROM t", (5,)),
    ("SELECT s, COUNT(*) FROM t WHERE nv > 5 GROUP BY s ORDER BY s DESC", ()),
    # fused-stage shapes
    ("SELECT k, nv * 2 FROM t WHERE nv IS NOT NULL AND lat > 55", ()),
    ("SELECT k, CASE WHEN lat > 50 THEN lat ELSE lng END, CAST(lat AS INT) FROM t WHERE lng < 0", ()),
    ("SELECT k, nv + lat FROM t WHERE lat > 65", ()),
    ("SELECT lat FROM t WHERE k IN (3, 7, 11)", ()),
    ("SELECT i64 / k, i64 % k, k / 0, (k - 25) / 7, (k - 25) % 7 FROM t WHERE d < 5000", ()),
    ("SELECT u16 + u16, u32 * u32, i8 + i8, f * f + f FROM t WHERE k = 3", ()),
    # ORDER BY ... LIMIT: packed multi-key rank, and a full sort + limit
    ("SELECT k, s FROM t ORDER BY s, k DESC LIMIT 7", ()),
    ("SELECT d, lat FROM t ORDER BY d DESC, lat LIMIT 10", ()),
    ("SELECT nk, lat FROM t ORDER BY nk LIMIT 12", ()),
    ("SELECT lat FROM t ORDER BY lat DESC", ()),
]


def _compare(a: str, b: str, tol_cols) -> None:
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


@pytest.mark.parametrize("sql,tol_cols", CASES, ids=[c[0] for c in CASES])
def test_sql_parity(contexts, sql, tol_cols):
    r, p = contexts
    _compare(p.sql(sql).result_str(), r.sql(sql).result_str(), tol_cols)


@pytest.mark.parametrize(
    "sql,note",
    [
        ("SELECT k, lat + lng FROM t WHERE lat > 51.0 AND lat < 53", "fused CUDA stage"),
        ("SELECT k, MIN(lat), MAX(lat), SUM(lng), COUNT(lat) FROM t GROUP BY k", "dense sort-free"),
        ("SELECT d, MIN(lat), MAX(lat), SUM(lng), COUNT(lat) FROM t GROUP BY d", "packed-gid co-sort"),
        ("SELECT f, COUNT(*) FROM t GROUP BY f", "aggregate: co-sort + segmented reduce"),
        ("SELECT lat FROM t ORDER BY lat LIMIT 3", "top-k selection"),
    ],
)
def test_plan_routes(contexts, sql, note):
    _, p = contexts
    assert note in p.sql(f"EXPLAIN VERBOSE {sql}").result_str()


@pytest.mark.xfail(
    strict=True,
    reason="reference fault (ROADMAP Queue 3, plan/planner.py:664-672): a grouped "
    "projection k+1 returns the raw key, and the port's copied planner inherits it",
)
def test_grouped_projection_reference_fault(contexts):
    _, p = contexts
    got = p.sql("SELECT k + 1, COUNT(*) FROM t GROUP BY k ORDER BY k").result_str()
    assert got.splitlines()[0].split("\t")[0] == "1"


# ---------------------------------------------------------------------------
# the reference goldens (tests/test_reference_goldens.py) through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_ctx(data_dir):
    from test_reference_goldens import ALL_TYPES_COLS

    from datafusion_tpu_torch.ops.functions import register_geospatial

    ctx = port.ExecutionContext(device="cpu")
    register_geospatial(ctx)
    P = port.DataType
    ctx.register_csv(
        "t", str(data_dir / "all_types_flat.csv"),
        port.Schema([port.Field(n, P[t.name], False) for n, t in ALL_TYPES_COLS]), has_header=False,
    )
    for name, it, ft in (("num", P.Int32, P.Float32), ("num64", P.Int64, P.Float64)):
        ctx.register_csv(
            name, str(data_dir / "numerics.csv"),
            port.Schema([port.Field("a", it, False), port.Field("b", it, False),
                         port.Field("a_f", ft, False), port.Field("b_f", ft, False)]),
        )
    ctx.register_csv(
        "people", str(data_dir / "people.csv"),
        port.Schema([port.Field("id", P.Int32, False), port.Field("first_name", P.Utf8, False)]),
    )
    ctx.register_csv(
        "null_test", str(data_dir / "null_test.csv"),
        port.Schema([port.Field("c_int", P.Int32, False), port.Field("c_float", P.Float64, True),
                     port.Field("c_string", P.Utf8, True), port.Field("c_bool", P.Boolean, False)]),
    )
    ctx.register_csv(
        "uk_cities", str(data_dir / "uk_cities.csv"),
        port.Schema([port.Field("city", P.Utf8, False), port.Field("lat", P.Float64, False),
                     port.Field("lng", P.Float64, False)]),
        has_header=False,
    )
    return ctx


def _golden_cases():
    from test_reference_goldens import CASES as GOLDEN

    # the Parquet goldens need the Parquet reader, not part of the port yet
    return [c for c in GOLDEN if " FROM p" not in c[1]]


@pytest.mark.parametrize("name,query,patches,float_tol", _golden_cases(), ids=[c[0] for c in _golden_cases()])
def test_reference_golden_through_port(golden_ctx, data_dir, name, query, patches, float_tol):
    from test_reference_goldens import _display

    res = golden_ctx.sql(query)
    cols = [res.column_values(j) for j in range(res.num_columns)]
    dts = [D[f.dtype.name] for f in res.schema.fields]
    got = "".join(
        ",".join(_display(dts[j], cols[j][i]) for j in range(res.num_columns)) + "\n"
        for i in range(res.num_rows)
    )
    expected = (data_dir / "expected" / f"{name}.csv").read_text()
    if not patches:
        assert got == expected
        return
    for el, gl in zip(expected.splitlines(), got.splitlines(), strict=True):
        for k, (e, g) in enumerate(zip(el.split(","), gl.split(","), strict=True)):
            assert g == patches.get(k, e), (name, k)
