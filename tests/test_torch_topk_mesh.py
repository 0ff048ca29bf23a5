"""ORDER BY ... LIMIT over several keys of any type through the port's
top-k selection, on one device and on a mesh of 8 shards.

Where the keys do not pack into one rank (a float key), the selection
keeps every row whose first key is at or before the k-th first key and
orders those candidates by the full sort; on a mesh each shard does so
and one selection runs over the gathered candidates. The rows and their
order must be the full sort's: every `result_str` is compared byte for
byte with the JAX package's on one device and with the port's own full
sort (the same ORDER BY without LIMIT, its lines cut by the LIMIT). The
first keys hold NULLs, -0.0 and 0.0, NaN, heavy ties and a boolean; the
cases take DESC, OFFSET, k above the selected rows and shards with no
rows. The top-k's counters and its ceiling (`topk_fits`) are read too.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu_torch.exec.compiler import TOPK_FLOOR, TOPK_SHARE, PlanCompiler, topk_fits

N = 2000


def _columns(n=N, seed=21):
    """f: 10% NULL, 10% NaN, 10% -0.0, 10% 0.0, the rest in [1, 4) at one
    decimal (ties); g: a later float key with NULLs; a: 0-99; b: boolean;
    r: the row index."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 10, n)
    f = np.round(1.0 + np.abs(rng.normal(size=n)), 1).clip(1.0, 3.9)
    f[kind == 1] = np.nan
    f[kind == 2] = -0.0
    f[kind == 3] = 0.0
    g = np.round(rng.random(n) * 20, 0)
    a = rng.integers(0, 100, n).astype(np.int64)
    b = rng.random(n) < 0.5
    r = np.arange(n, dtype=np.int64)
    return [f, g, a, b, r], [kind != 0, rng.random(n) > 0.2, None, None, None]


_FIELDS = [("f", "Float64", True), ("g", "Float64", True), ("a", "Int64", False), ("b", "Boolean", False),
           ("r", "Int64", False)]


def _tables(cols, valid):
    rs = ref.Schema([ref.Field(nm, ref.DataType[t], nl) for nm, t, nl in _FIELDS])
    ps = port.Schema([port.Field(nm, port.DataType[t], nl) for nm, t, nl in _FIELDS])
    small = [c[:5] for c in cols], [None if v is None else v[:5] for v in valid]  # 5 rows over 8 shards
    return ((ref.Table.from_arrays(rs, cols, validity=valid), ref.Table.from_arrays(rs, small[0], validity=small[1])),
            (port.Table.from_arrays(ps, cols, validity=valid, device="cpu"),
             port.Table.from_arrays(ps, small[0], validity=small[1], device="cpu")))


@pytest.fixture(scope="module")
def contexts():
    (rt, rs), (pt, ps) = _tables(*_columns())
    r = ref.ExecutionContext()
    card = port.ExecutionContext(device="cpu")
    mesh = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    for ctx, t, s in ((r, rt, rs), (card, pt, ps), (mesh, pt, ps)):
        ctx.register_table("t", t)
        ctx.register_table("s", s)
    return r, {"card": card, "mesh": mesh}


CASES = [
    # (ORDER BY query without its LIMIT, limit, offset, route named by EXPLAIN VERBOSE on the mesh)
    ("SELECT f, g, a FROM t ORDER BY f, g", 40, 0, "first-key threshold, 2 keys"),  # -0.0 / 0.0 at the threshold
    ("SELECT f, g, a FROM t ORDER BY f DESC, g DESC, a", 40, 0, "first-key threshold, 3 keys"),
    ("SELECT f, g, r FROM t ORDER BY f, g", 1650, 0, "first-key threshold"),  # the threshold in the NaNs
    ("SELECT f, g, r FROM t ORDER BY f, g, r", 1850, 0, "first-key threshold"),  # into the NULLs
    ("SELECT g, f, a FROM t ORDER BY g, f, a", 35, 20, "first-key threshold, 3 keys"),  # NULLs in the first key
    ("SELECT f, a FROM t WHERE a > 96 ORDER BY f, a", 500, 0, "first-key threshold"),  # k above the selected rows
    ("SELECT r, f FROM t WHERE r >= 1500 ORDER BY f DESC, r", 30, 0, "first-key threshold"),  # 6 shards select none
    ("SELECT b, g, r FROM t ORDER BY b, g", 25, 0, "first-key threshold"),  # candidates: half of every shard
    ("SELECT f, g, r FROM s ORDER BY g, f", 10, 0, "first-key threshold"),  # 5 rows: shards without rows
    ("SELECT f, g, a FROM t ORDER BY g DESC, a", 4500, 0, "multi-key sample sort"),  # past the ceiling
]


def _sql(base: str, k: int, off: int) -> str:
    return f"{base} LIMIT {k}" + (f" OFFSET {off}" if off else "")


@pytest.mark.parametrize("where", ["card", "mesh"])
@pytest.mark.parametrize("base,k,off,route", CASES, ids=[str(i) for i in range(len(CASES))])
def test_multi_key_limit_is_the_full_sort(contexts, where, base, k, off, route):
    r, ports = contexts
    p = ports[where]
    sql = _sql(base, k, off)
    got = p.sql(sql).result_str()
    assert got == r.sql(sql).result_str(), sql
    assert got.splitlines() == p.sql(base).result_str().splitlines()[off:off + k], sql
    if where == "mesh":
        assert route in p.sql("EXPLAIN VERBOSE " + sql).result_str()


@pytest.mark.parametrize("where,calls", [("card", 1), ("mesh", 9)])
def test_counters_count_the_candidates(contexts, where, calls):
    p = contexts[1][where]
    for base, k, cand in (("SELECT b, g, r FROM t ORDER BY b, g", 25, 500),  # a boolean first key: ties
                          ("SELECT f, g, a FROM t ORDER BY f, g", 40, 40)):
        sql = _sql(base, k, 0)
        p.sql(sql)  # lowered and cached
        c0, n0 = PlanCompiler._topk_over.calls, PlanCompiler._topk_over.candidates
        p.sql(sql)
        assert PlanCompiler._topk_over.calls - c0 == calls
        assert PlanCompiler._topk_over.candidates - n0 >= cand


def test_ceiling_lifts_with_the_shard_capacity():
    assert not topk_fits(0, 1 << 24)
    assert topk_fits(TOPK_FLOOR, 0) and not topk_fits(TOPK_FLOOR + 1, TOPK_FLOOR * TOPK_SHARE)
    cap = (TOPK_FLOOR + 1000) * TOPK_SHARE
    assert topk_fits(TOPK_FLOOR + 1000, cap) and not topk_fits(TOPK_FLOOR + 1001, cap)
    # a single card's table large enough that k = 4,500 takes the top-k
    cols, valid = _columns(cap, seed=5)
    ps = port.Schema([port.Field(nm, port.DataType[t], nl) for nm, t, nl in _FIELDS])
    p = port.ExecutionContext(device="cpu")
    p.register_table("t", port.Table.from_arrays(ps, cols, validity=valid, device="cpu"))
    sql = "SELECT f, g, r FROM t ORDER BY f DESC, g LIMIT 4500"
    assert "top-k selection (first-key threshold, k=4500, 2 keys" in p.sql("EXPLAIN VERBOSE " + sql).result_str()
    assert p.sql(sql).result_str().splitlines() == p.sql(sql[:sql.index(" LIMIT")]).result_str().splitlines()[:4500]
