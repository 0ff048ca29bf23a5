"""The port's distributed engine on the CPU: `ExecutionContext(mesh=
make_mesh(8, device="cpu"))` against the JAX package's
`ExecutionContext(mesh=make_mesh())` on its 8 virtual CPU devices, fed
the same numpy columns, compared as tests/test_distributed.py compares:
rows sorted when the query has no ORDER BY, floats to rel 1e-9 (the
merges add in another order), and to rel 1e-4 over the Float32 table of
tests/test_fold_aggregate.py, that file's tolerance (the JAX kernels
sum f32, the port f64). Where a sort has ties, the JAX mesh's
order across devices is unspecified (its sample sort's docstring), so
those queries compare the sort keys' sequence and the row multiset. The
JAX side runs with DFTPU_PALLAS=1, as tests/test_fold_aggregate.py does,
so that its fold engages where it can.

EXPLAIN VERBOSE must name the port's route of each shape: dense per
shard + merge, the K6 fold, partials + all_gather merge, the single- and
multi-key sample sorts (K5) and the per-shard top-k.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_mesh


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("DFTPU_PALLAS", "1")


def _port_table(jt):
    return port.Table.from_reference_arrays(
        [port.Field(f.name, port.DataType[f.dtype.name], f.nullable) for f in jt.schema.fields],
        [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
        [c.dictionary for c in jt.columns],
        device="cpu",
        num_rows=jt.num_rows,
    )


def _contexts(tables: dict):
    """(JAX mesh context, port mesh context, port single-card context)
    over the same columns; `tables` maps names to JAX Tables."""
    r = ref.ExecutionContext(mesh=ref_mesh())
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    s = port.ExecutionContext(device="cpu")
    for name, jt in tables.items():
        r.register_table(name, jt)
        pt = _port_table(jt)
        p.register_table(name, pt)
        s.register_table(name, pt)
    return r, p, s


def _random(n=5000, seed=0, kmax=37):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, kmax, n).astype(np.int32),
        "v": np.round(rng.random(n) * 100, 3),
        "w": rng.integers(-1000, 1000, n).astype(np.int64),
        "s": np.array([["x", "y", "z"][i] for i in rng.integers(0, 3, n)], dtype=object),
    }


def _fold_data(n=8192, kmax=5000, seed=3):
    """tests/test_fold_aggregate.py's table: f32 values, a 5000-slot key."""
    rng = np.random.default_rng(seed)
    nv = (rng.random(n) * 100 - 50).astype(np.float32)
    nv[rng.random(n) < 0.2] = np.nan  # from_pydict: NaN -> NULL
    return {
        "k": rng.integers(0, kmax, n).astype(np.int32),
        "v": (rng.random(n) * 10).astype(np.float32),
        "iv": rng.integers(-(2**28), 2**28, n).astype(np.int32),
        "nv": nv,
        "s": np.array([f"g{i}" for i in rng.integers(0, 6, n)], dtype=object),
    }


def _nulls_skew(n=3000, seed=9):
    """tests/test_distributed.py's NULL and skew table: 90% of `g` is 3."""
    rng = np.random.default_rng(seed)
    v = rng.random(n)
    valid = rng.random(n) > 0.3
    g = np.where(rng.random(n) < 0.9, 3, rng.integers(0, 8, n)).astype(np.int32)
    schema = ref.Schema([ref.Field("g", ref.DataType.Int32, False), ref.Field("v", ref.DataType.Float64, True),
                         ref.Field("u", ref.DataType.Int32, False)])
    return ref.Table.from_arrays(schema, [g, v, rng.permutation(n).astype(np.int32)], validity=[None, valid, None])


def _same(a: str, b: str, rel=1e-9) -> bool:
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return False
    for ra, rb in zip(la, lb):
        ca, cb = ra.split("\t"), rb.split("\t")
        if len(ca) != len(cb):
            return False
        for x, y in zip(ca, cb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                return False
            if not abs(fx - fy) <= rel * max(1.0, abs(fx), abs(fy)):
                return False
    return True


def _compare(a: str, b: str, how: str, rel=1e-9):
    if how == "ordered":
        assert _same(a, b, rel), f"\n{a[:600]}\n--- port ---\n{b[:600]}"
    elif how == "rows":
        assert _same("\n".join(sorted(a.splitlines())), "\n".join(sorted(b.splitlines())), rel)
    else:  # ties: the sort keys' sequence (the first `how` columns), and the rows
        n_keys = int(how)
        assert [ln.split("\t")[:n_keys] for ln in a.splitlines()] == [ln.split("\t")[:n_keys] for ln in b.splitlines()]
        assert sorted(a.splitlines()) == sorted(b.splitlines())


TABLES = {
    "random": lambda: {"t": ref.Table.from_pydict(_random())},
    "fold": lambda: {"t": ref.Table.from_pydict(_fold_data())},
    "nulls_skew": lambda: {"t": _nulls_skew()},
}

CASES = [
    # (table, sql, comparison, route named by EXPLAIN VERBOSE or None)
    ("random", "SELECT k, v, v * 2 FROM t WHERE v > 50 AND k < 10", "ordered", "fused CUDA stage"),
    ("random", "SELECT k, MIN(v), MAX(v), SUM(w), COUNT(v), AVG(v) FROM t GROUP BY k ORDER BY k", "ordered",
     "dense sort-free group-by per shard"),
    ("random", "SELECT s, SUM(v), MIN(w), COUNT(*) FROM t GROUP BY s", "rows", "dense sort-free group-by per shard"),
    ("random", "SELECT MIN(v), MAX(v), COUNT(v) FROM t", "ordered", None),
    ("random", "SELECT SUM(w), AVG(w), SUM(v), AVG(v) FROM t WHERE k > 30", "ordered", None),
    ("random", "SELECT k, MAX(v) - MIN(v) AS spread FROM t GROUP BY k HAVING COUNT(v) > 100 ORDER BY k", "ordered",
     None),
    ("random", "SELECT w, SUM(v), COUNT(*) FROM t GROUP BY w", "rows", "dense sort-free group-by per shard"),
    ("random", "SELECT v, COUNT(*), SUM(w) FROM t GROUP BY v", "rows", "partial aggregate (co-sort) + all_gather"),
    ("random", "SELECT s, w, COUNT(*), MAX(v) FROM t GROUP BY s, w", "rows", "fused ragged-exchange fold"),
    ("random", "SELECT s, w, k, COUNT(*), MAX(v) FROM t GROUP BY s, w, k", "rows", "partial aggregate (packed-gid co-sort"),
    ("random", "SELECT s FROM (SELECT k, s, SUM(w) AS x FROM t GROUP BY k, s) sub WHERE x > 0 ORDER BY s", "1", None),
    ("fold", "SELECT k, SUM(v), COUNT(v) FROM t GROUP BY k ORDER BY k", "ordered", "fused ragged-exchange fold"),
    ("fold", "SELECT k, MIN(iv), MAX(iv), AVG(v) FROM t GROUP BY k ORDER BY k LIMIT 500", "ordered",
     "fused ragged-exchange fold"),
    ("fold", "SELECT k, COUNT(nv), SUM(nv), MIN(v) FROM t GROUP BY k", "rows", "fused ragged-exchange fold"),
    ("fold", "SELECT k, MIN(s), MAX(s) FROM t GROUP BY k", "rows", "fused ragged-exchange fold"),
    ("fold", "SELECT s, k, COUNT(v), MAX(v) FROM t WHERE k < 900 GROUP BY s, k ORDER BY s, k", "ordered",
     "partial aggregate (packed-gid co-sort"),
    ("fold", "SELECT k, SUM(v) FROM t WHERE v > 5 GROUP BY k", "rows", "fused ragged-exchange fold"),
    ("random", "SELECT v FROM t ORDER BY v", "ordered", "distributed sample sort"),
    ("random", "SELECT v, k FROM t WHERE k < 20 ORDER BY v DESC", "1", "distributed sample sort"),
    ("random", "SELECT k, v FROM t ORDER BY v DESC, k LIMIT 17", "ordered", "per-shard top-k (first-key threshold"),
    ("random", "SELECT k, s, w FROM t ORDER BY k, s DESC, w", "3", "multi-key sample sort"),
    ("nulls_skew", "SELECT g, v, u FROM t ORDER BY g, v NULLS FIRST, u", "ordered", "multi-key sample sort"),
    ("nulls_skew", "SELECT g, v, u FROM t ORDER BY g DESC, v DESC, u", "ordered", "multi-key sample sort"),
    ("nulls_skew", "SELECT v, u FROM t ORDER BY v NULLS FIRST", "1", "distributed sample sort"),
    ("nulls_skew", "SELECT v, u FROM t ORDER BY v DESC NULLS FIRST", "1", "distributed sample sort"),
    ("nulls_skew", "SELECT g, u FROM t ORDER BY g", "1", "distributed sample sort"),
    ("random", "SELECT v FROM t ORDER BY v DESC LIMIT 100", "ordered", "per-shard top-k"),
    ("random", "SELECT v, k FROM t WHERE k < 20 ORDER BY v LIMIT 50", "ordered", "per-shard top-k"),
    ("random", "SELECT k, v FROM t ORDER BY v LIMIT 20 OFFSET 35", "ordered", "per-shard top-k"),
    ("random", "SELECT k FROM t LIMIT 100", "ordered", None),
    ("random", "SELECT k FROM t LIMIT 50 OFFSET 100", "ordered", None),
    ("random", "SELECT v FROM t ORDER BY v DESC OFFSET 4970", "ordered", "distributed sample sort"),
    ("random", "SELECT k, v FROM t ORDER BY v LIMIT 4500", "ordered", "distributed sample sort"),
]


@pytest.mark.parametrize("table,sql,how,route", CASES, ids=[f"{i}" for i in range(len(CASES))])
def test_mesh_matches_jax_mesh(table, sql, how, route):
    r, p, s = _contexts(TABLES[table]())
    got = p.sql(sql).result_str()
    _compare(r.sql(sql).result_str(), got, how, 1e-4 if table == "fold" else 1e-9)
    # the port's mesh keeps the single-card port's row order, ties included
    _compare(s.sql(sql).result_str(), got, "ordered" if how in ("ordered", "1", "3") else how)
    if route is not None:
        assert route in p.sql("EXPLAIN VERBOSE " + sql).result_str()


def test_string_group_by_golden(data_dir):
    schema = ref.Schema([ref.Field("a", ref.DataType.Utf8, False), ref.Field("b", ref.DataType.Float64, False)])
    r = ref.ExecutionContext(mesh=ref_mesh())
    r.register_datasource("t1", ref.CsvDataSource(str(data_dir / "aggregate_test_2.csv"), schema))
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    p.register_csv("t1", str(data_dir / "aggregate_test_2.csv"),
                   port.Schema([port.Field("a", port.DataType.Utf8, False), port.Field("b", port.DataType.Float64, False)]))
    sql = "SELECT a, MIN(b), MAX(b) FROM t1 GROUP BY a ORDER BY a"
    assert p.sql(sql).result_str() == r.sql(sql).result_str() == '"one"\t1.1\t2.2\n"three"\t1.0\t2.0\n"two"\t3.3\t5.5\n'


def test_literal_only_query():
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    assert p.sql("SELECT 1 + 2").result_str() == "3\n"


def test_fold_declines_with_a_reason():
    """Past 2048 slots per shard, or past K6's shared memory, the plan
    merges partials instead and says why."""
    _, p, _ = _contexts({"t": ref.Table.from_pydict(_fold_data(kmax=20_000))})
    text = p.sql("EXPLAIN VERBOSE SELECT k, COUNT(*) FROM t GROUP BY k").result_str()
    assert "exchange-fold declined (domain" in text and "slots/shard > 2048)" in text, text
    aggs = ", ".join(f"{f}(v + {i})" for i in range(4) for f in ("SUM", "MIN", "MAX"))
    _, p, _ = _contexts({"t": ref.Table.from_pydict(_fold_data())})
    text = p.sql(f"EXPLAIN VERBOSE SELECT k, {aggs} FROM t GROUP BY k").result_str()
    assert "K6's shared memory holds 14 windows" in text and "all_gather merge" in text, text


def test_mesh_partitions_and_device():
    t = port.Table.from_pydict({"a": np.arange(10, dtype=np.int32)}, device="cpu")
    mesh = port.make_mesh(4, device="cpu")
    from datafusion_tpu_torch.parallel.mesh import partition_table

    shards = partition_table(t, mesh)
    assert [s.num_rows for s in shards] == [3, 3, 3, 1]
    assert shards[1].columns[0].data.data_ptr() == t.columns[0].data[3:].data_ptr()  # views, no copy
    assert port.ExecutionContext(mesh=mesh, device="cpu").device.type == "cpu"
    with pytest.raises(port.ExecutionError, match="mesh"):
        port.ExecutionContext(mesh=mesh, device="meta")
    with pytest.raises(port.ExecutionError, match="bigdense"):
        port.ExecutionContext(mesh=mesh, bigdense=True)


def test_empty_shards():
    """Fewer rows than shards: most shards are empty."""
    data = {"k": np.array([3, 1, 2], dtype=np.int32), "v": np.array([0.5, 1.5, -2.0])}
    r, p, _ = _contexts({"t": ref.Table.from_pydict(data)})
    for sql in ("SELECT k, SUM(v), MIN(v) FROM t GROUP BY k ORDER BY k", "SELECT v FROM t ORDER BY v",
                "SELECT MIN(v), MAX(k), COUNT(*) FROM t", "SELECT k FROM t ORDER BY k LIMIT 2"):
        assert p.sql(sql).result_str() == r.sql(sql).result_str(), sql
