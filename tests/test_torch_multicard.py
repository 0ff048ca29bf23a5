"""A mesh over several cards of one process, on the CPU.

`make_mesh(8, devices=("cpu",) * 4)` and `("cpu",) * 2` lay the 8 shards
over 4 and 2 logical cards: every per-shard stage is lowered once per
card, each table's row blocks are placed at registration
(`ShardTable`), the collectives meet on the first card, and K5 / K6 run
one launch per card over that card's receivers with every shard as a
sender (here their plain versions, card by card). The queries are the
card's phase-14 set (chip_smoke.py): m1-m8 of the mesh's main path, m10
(the shuffle join), m11 (the repartitioned window) and m15 (the
repartition aggregate), with m6 both as the per-shard top-k and, under
NULLS FIRST as chip_smoke.py runs it, as the multi-key sample sort, over
a few thousand rows. Each result_str is
held byte for byte to the port's one-device 8-shard mesh and to the JAX
package's mesh on its 8 virtual CPU devices. The floats are multiples of
1/256 below 2^6 (lat's all distinct, so no sort has ties), so every sum
is exact in any order and the two
packages' float columns must agree to the bit, not to a tolerance; m15's
STDDEV / VARIANCE are held to one device's bits and to the JAX
package's at rel 1e-12 (tests/test_torch_aggregates.py's bound: the two
packages divide and take square roots alike but sum the squared
deviations in another order). Rows of a GROUP BY come shard by shard,
in an order the JAX mesh does not share, so those compare as sorted
lines. Beside them: make_mesh's refusals, and the per-card grouping of
K5's and K6's plain versions against one whole call.
"""

import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_mesh
from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
from datafusion_tpu_torch.parallel.mesh import ShardTable, partition_table

SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
N, N_ORDERS = 3000, 900


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("DFTPU_PALLAS", "1")  # the JAX mesh folds where it can (tests/test_torch_dist.py)


def _data(seed=14):
    rng = np.random.default_rng(seed)
    big = {
        "k": rng.integers(0, 20_000, N).astype(np.int32),  # past K6's 2048 slots a shard: m5 merges partials
        "d": rng.integers(0, 60, N).astype(np.int32),
        "lat": 48 + rng.permutation(N) / 256,  # distinct: no ties for the sorts and windows to order
        "lng": rng.integers(-144, 48, N) / 16,
        "g": rng.integers(1, 5001, N).astype(np.int32),
        "mode": np.array(SHIPMODES, dtype=object)[rng.integers(0, len(SHIPMODES), N)],
        "o": rng.integers(0, 2 * N_ORDERS, N).astype(np.int32),
    }
    orders = {
        "o_orderkey": rng.permutation(2 * N_ORDERS)[:N_ORDERS].astype(np.int32),
        "o_totalprice": rng.integers(0, 16000, N_ORDERS) / 16,
        "o_orderpriority": np.array(PRIORITIES, dtype=object)[rng.integers(0, len(PRIORITIES), N_ORDERS)],
    }
    return big, orders


def _port_table(jt):
    return port.Table.from_reference_arrays(
        [port.Field(f.name, port.DataType[f.dtype.name], f.nullable) for f in jt.schema.fields],
        [np.asarray(c.data) for c in jt.columns],
        [None if c.validity is None else np.asarray(c.validity) for c in jt.columns],
        [c.dictionary for c in jt.columns],
        device="cpu",
        num_rows=jt.num_rows,
    )


@pytest.fixture(scope="module")
def contexts():
    """{name: context} over the same tables: the JAX mesh, the port's
    one-device mesh, and the port's meshes over 4 and 2 cards; "want"
    keeps the first two's result_str per query, for both card counts."""
    big, orders = _data()
    jt = {"big": ref.Table.from_pydict(big), "orders": ref.Table.from_pydict(orders)}
    out = {"jax": ref.ExecutionContext(mesh=ref_mesh()), "one": port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")),
           "4 cards": port.ExecutionContext(mesh=port.make_mesh(8, devices=("cpu",) * 4)),
           "2 cards": port.ExecutionContext(mesh=port.make_mesh(8, devices=("cpu",) * 2))}
    for name, t in jt.items():
        out["jax"].register_table(name, t)
        pt = _port_table(t)
        for c in ("one", "4 cards", "2 cards"):
            out[c].register_table(name, pt)
    out["want"] = {}
    return out


QUERIES = {  # chip_smoke.py's phase-14 set: (SQL, ordered, the route EXPLAIN VERBOSE shows)
    "m1": ("SELECT k, lat, lng, lat + lng FROM big WHERE lat > 57.9", True, "fused CUDA stage"),
    "m2": ("SELECT mode, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM big GROUP BY mode", False,
           "dense sort-free group-by per shard"),
    "m3": ("SELECT g, SUM(lng), AVG(lat), MIN(lat), MAX(lng), COUNT(*) FROM big GROUP BY g", False,
           "fused ragged-exchange fold"),
    "m4": ("SELECT g, MIN(lat), COUNT(lat) FROM big WHERE lat > 51.0 GROUP BY g", False, "fused ragged-exchange fold"),
    "m5": ("SELECT k, SUM(lng), COUNT(*) FROM big GROUP BY k", False, "all_gather merge"),
    "m6": ("SELECT k, d, lat FROM big ORDER BY k, d, lat LIMIT 1000", True, "per-shard top-k (first-key threshold"),
    "m6n": ("SELECT k, d, lat FROM big ORDER BY k, d, lat NULLS FIRST LIMIT 1000", True, "multi-key sample sort"),
    "m7": ("SELECT lat, g FROM big ORDER BY lat LIMIT 5000", True, "distributed sample sort"),
    "m8": ("SELECT k, lat FROM big ORDER BY lat DESC LIMIT 10", True, "per-shard top-k"),
    "m10": ("SELECT o_orderpriority, COUNT(big.lat), SUM(big.lat) FROM orders LEFT JOIN big "
            "ON orders.o_orderkey = big.o GROUP BY o_orderpriority", False, "join: shuffle"),
    "m11": ("SELECT d, k, lat, rn FROM (SELECT d, k, lat, ROW_NUMBER() OVER (PARTITION BY d ORDER BY lat DESC) "
            "AS rn FROM big) q WHERE rn <= 3 ORDER BY d, rn", True, "hash-repartition by PARTITION BY keys over K5"),
    "m15": ("SELECT d, STDDEV(lat), VARIANCE(lng), COUNT(*) FROM big GROUP BY d", False,
            "hash-repartition by group keys over K5"),
}


def _close(a: str, b: str, rel: float) -> bool:
    """Equal lines, numbers within `rel`."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return False
    for ra, rb in zip(la, lb):
        for x, y in zip(ra.split("\t"), rb.split("\t")):
            if x != y and not abs(float(x) - float(y)) <= rel * max(1.0, abs(float(x))):
                return False
    return True


@pytest.mark.parametrize("cards", ["4 cards", "2 cards"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_mesh_over_cards_matches_one_device_and_the_jax_mesh(contexts, name, cards):
    sql, ordered, route = QUERIES[name]
    if name not in contexts["want"]:
        contexts["want"][name] = (contexts["one"].sql(sql).result_str(), contexts["jax"].sql(sql).result_str())
    one, want = contexts["want"][name]
    got = contexts[cards].sql(sql).result_str()
    assert got == one  # every shard's rows, in shard order, bit for bit

    def rows(text):
        return text if ordered else "\n".join(sorted(text.splitlines()))

    if name == "m15":
        assert _close(rows(want), rows(got), 1e-12)
    else:
        assert rows(got) == rows(want)
    assert route in contexts[cards].sql("EXPLAIN VERBOSE " + sql).result_str()


def test_tables_are_placed_once_and_dml_works():
    """register_table on a mesh of several cards places each shard's row
    block once (a ShardTable); partition_table hands those shards out
    as they are; CTAS, INSERT and DROP run over it."""
    mesh = port.make_mesh(8, devices=("cpu",) * 4)
    ctx = port.ExecutionContext(mesh=mesh)
    ctx.register_table("t", port.Table.from_pydict({"a": np.arange(21, dtype=np.int32)}, device="cpu"))
    t = ctx.table("t")
    assert isinstance(t, ShardTable) and [s.num_rows for s in t.shards] == [3] * 7 + [0]
    assert [s.columns[0].data.data_ptr() for s in partition_table(t, mesh)] == [
        s.columns[0].data.data_ptr() for s in t.shards]
    ctx.sql("INSERT INTO t VALUES (CAST(100 AS INT))")
    ctx.sql("CREATE TABLE u AS SELECT a FROM t WHERE a > 15")
    assert ctx.sql("SELECT COUNT(*), SUM(a) FROM t").result_str() == "22\t310\n"
    assert ctx.sql("SELECT a FROM u ORDER BY a").result_str() == "16\n17\n18\n19\n20\n100\n"
    ctx.sql("DROP TABLE u")
    assert ctx.sql("SHOW TABLES").result_str() == '"t"\n'
    assert port.ExecutionContext(mesh=port.make_mesh(4, devices=("cpu", "cpu")), device="cpu").device.type == "cpu"


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="split evenly over 3 cards"):
        port.make_mesh(8, devices=("cpu",) * 3)
    with pytest.raises(ValueError, match="no card"):
        port.make_mesh(8, devices=())
    with pytest.raises(ValueError, match="is not the first of devices"):
        port.make_mesh(8, device="meta", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="mix device types"):
        port.make_mesh(8, devices=("cpu", "meta"))
    with pytest.raises(ValueError, match="at least one shard"):
        port.make_mesh(0, devices=("cpu",))
    from datafusion_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    spanning = Mesh(16, cpu, rank=1, world=2, n_local=8, devices=(cpu,) * 4)  # several cards a process
    assert spanning.first == 8 and spanning.n_cards == 4 and spanning.spans
    assert [spanning.card_index(d) for d in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert spanning.card_of(7) == cpu and list(spanning.card_shards(3)) == [6, 7]
    with pytest.raises(ValueError, match="6 shards do not split evenly over 4 cards"):
        Mesh(12, cpu, rank=0, world=2, n_local=6, devices=(cpu,) * 4)
    with pytest.raises(ValueError, match="cards; this host has"):  # before any rendezvous: no group is made
        port.initialize_multihost("127.0.0.1:1", 2, 0, cards_per_process=2 + torch.cuda.device_count())
    with pytest.raises(ValueError, match="split evenly over 3 cards"):
        Mesh(16, cpu, rank=0, world=2, n_local=8, devices=(cpu,) * 3)
    mesh = port.make_mesh(8, devices=("cpu",) * 4)
    assert mesh.device == torch.device("cpu") and mesh.n_cards == 4
    assert [mesh.card_index(d) for d in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert list(mesh.card_shards(2)) == [4, 5]
    with pytest.raises(ValueError, match="partitions a ShardTable"):
        partition_table(port.Table.from_pydict({"a": np.arange(4, dtype=np.int32)}, device="cpu"), mesh)


def _regions(rng, n_send, n_recv, split_cap, dtypes):
    return [[torch.from_numpy(rng.integers(-1000, 1000, n_recv * split_cap)).to(dt) for dt in dtypes]
            for _ in range(n_send)]


@pytest.mark.parametrize("n_cards", [2, 4])
def test_plain_exchanges_per_card_equal_one_call(n_cards):
    """The wrappers' per-card grouping on the CPU (each card's receivers,
    every sender from that card's first region) gives what one whole
    call gives: K5's valid prefixes and K6's tables, bit for bit."""
    rng = np.random.default_rng(n_cards)
    n, split_cap, chunk = 8, 256, 128
    sizes = torch.from_numpy(rng.integers(0, split_cap + 1, (n, n)).astype(np.int32))
    sends = _regions(rng, n, n, split_cap, (torch.int32, torch.float64, torch.uint8))
    cards = ("cpu",) * n_cards
    whole = rs.ragged_exchange(sends, sizes, n_dev=n, split_cap=split_cap, chunk=chunk)
    split = rs.ragged_exchange(sends, sizes, n_dev=n, split_cap=split_cap, chunk=chunk, cards=cards)
    sz = sizes.tolist()
    for i in range(n):
        for a, b in zip(whole[i], split[i]):
            for j in range(n):
                span = slice(j * split_cap, j * split_cap + sz[j][i])
                assert torch.equal(a[span], b[span]), (i, j)
    gids = [torch.from_numpy(rng.integers(0, 70, n * split_cap).astype(np.int32)) for _ in range(n)]
    vals = [[torch.from_numpy(rng.random(n * split_cap)), None, s[0].long()] for s in sends]
    masks = [[torch.from_numpy(rng.random(n * split_cap) < 0.6)] for _ in range(n)]
    kw = dict(ops=("sum", "count", "max"), mask_map=(1, 0, 1), n_dev=n, split_cap=split_cap, num_groups=64)
    whole = rs.ragged_exchange_fold(gids, vals, masks, sizes, **kw)
    split = rs.ragged_exchange_fold(gids, vals, masks, sizes, cards=cards, **kw)
    for a, b in zip(whole, split):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="split evenly"):
        rs.ragged_exchange(sends, sizes, n_dev=n, split_cap=split_cap, chunk=chunk, cards=("cpu",) * 3)
