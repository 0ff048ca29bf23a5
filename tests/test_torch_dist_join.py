"""The port's distributed joins on the CPU: `ExecutionContext(mesh=
make_mesh(8, device="cpu"))` against the single-card port over the same
tables.

The broadcast join returns the single card's rows in the single card's
order; the hash-shuffle join returns them as a multiset (its order is
shard by shard, as the JAX mesh's is unspecified). The skewed case of
tests/test_shuffle_join.py (60% of the probe rows on one key) must pick a
skew salt above 1 and still return the single card's rows.
`hash_keys_to_device` must equal the JAX package's element for element.
Two cases run the JAX mesh itself.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.parallel.mesh import make_mesh as ref_mesh
from datafusion_tpu.parallel.shuffle import hash_keys_to_device as ref_hash
from datafusion_tpu_torch.parallel.shuffle import hash_keys_to_device
from test_torch_join import register_both


def _fact_dim(seed=0, n_fact=5000, n_dim=800, skew=False):
    """tests/test_shuffle_join.py's join_case: fact rows over a dim key."""
    rng = np.random.default_rng(seed)
    if skew:
        hot = np.full(int(n_fact * 0.6), 7, np.int32)
        fk = np.concatenate([hot, rng.integers(0, n_dim, n_fact - len(hot)).astype(np.int32)])
        rng.shuffle(fk)
    else:
        fk = rng.integers(0, n_dim * 2, n_fact).astype(np.int32)
    fact = {"fk": fk, "x": rng.integers(0, 1000, n_fact).astype(np.int64)}
    dim = {"pk": np.arange(n_dim, dtype=np.int32), "w": rng.random(n_dim)}
    return fact, dim


def _tables():
    fact, dim = _fact_dim()
    # the skewed case: 4,000 fact rows against 1,100 dim rows, so the
    # right side's capacity times 4 exceeds the left's (a shuffle)
    sfact, sdim = _fact_dim(n_fact=4000, n_dim=1100, skew=True)
    rng = np.random.default_rng(4)
    dup = {"pk": rng.integers(0, 800, 900).astype(np.int32), "y": rng.integers(0, 50, 900).astype(np.int32)}
    nk = rng.integers(0, 30, 600).astype(np.int32).astype(object)
    nk[rng.random(600) < 0.1] = None
    return {
        "fact": fact, "dim": dim, "sfact": sfact, "sdim": sdim, "dup": dup,
        "people": {"pid": np.array([1, 2, 3], np.int32), "name": ["ann", "bob", "cat"]},
        "orders": {"oid": np.array([10, 11, 12, 13], np.int32), "pid": np.array([3, 1, 3, 9], np.int32),
                   "amount": np.array([5.0, 7.5, 2.5, 99.0])},
        "sa": {"s": list(rng.choice(["x", "y", "z", "w"], 700)), "n": rng.integers(0, 5, 700).astype(np.int32),
               "v": rng.random(700)},
        "sb": {"s": ["y", "z", "q", "y"], "n": np.array([1, 2, 3, 4], np.int32), "u": np.arange(4, dtype=np.int32)},
        "na": {"k": list(nk), "v": np.arange(600, dtype=np.int32)},
        "nb": {"k": [1, None, 2, 5, None, 7], "s": ["a", "b", "c", "d", "e", "f"]},
        "e": {"k": np.array([], np.int32), "v": np.array([], np.float64)},
        "t2": {"k": np.array([1, 2], np.int32)},
    }


@pytest.fixture(scope="module")
def contexts():
    single = port.ExecutionContext(device="cpu")
    mesh = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    for name, data in _tables().items():
        t = port.Table.from_pydict(data, device="cpu")
        single.register_table(name, t)
        mesh.register_table(name, t)
    return single, mesh


BROADCAST = [
    "SELECT fact.fk, fact.x, dim.w FROM fact JOIN dim ON fact.fk = dim.pk",
    "SELECT fact.fk, dim.w FROM fact LEFT JOIN dim ON fact.fk = dim.pk",
    "SELECT fact.fk, dim.w FROM fact FULL JOIN dim ON fact.fk = dim.pk",
    "SELECT fact.x, dup.y FROM fact JOIN dup ON fact.fk = dup.pk",
    "SELECT fact.x, dup.y FROM fact LEFT JOIN dup ON fact.fk = dup.pk WHERE fact.x < 300",
    "SELECT fact.x, dup.y FROM fact FULL JOIN dup ON fact.fk = dup.pk",
    "SELECT fact.fk, COUNT(fact.x), SUM(fact.x) FROM fact JOIN dim ON fact.fk = dim.pk GROUP BY fk ORDER BY fk",
    "SELECT fact.x FROM fact WHERE fact.fk IN (SELECT pk FROM dup)",
    "SELECT fact.x FROM fact WHERE fact.fk NOT IN (SELECT pk FROM dup WHERE y > 10)",
    "SELECT fact.x, (SELECT MAX(w) FROM dim) FROM fact WHERE fact.x > 990",
    "SELECT people.name, orders.oid FROM people CROSS JOIN orders",
    "SELECT dim.w, fact.x FROM dim RIGHT JOIN fact ON fact.fk = dim.pk",
]
SHUFFLE = [
    "SELECT orders.oid, people.name FROM orders JOIN people ON orders.pid = people.pid",
    "SELECT orders.oid, people.name FROM orders LEFT JOIN people ON orders.pid = people.pid",
    "SELECT orders.oid, people.name FROM orders RIGHT JOIN people ON orders.pid = people.pid",
    "SELECT orders.oid, people.name FROM orders FULL JOIN people ON orders.pid = people.pid",
    "SELECT dim.pk, fact.x FROM dim JOIN fact ON fact.fk = dim.pk",
    "SELECT dim.pk, fact.x FROM dim LEFT JOIN fact ON fact.fk = dim.pk",
    "SELECT dim.pk, fact.x FROM dim FULL JOIN fact ON fact.fk = dim.pk",
    "SELECT sa.v, sb.u FROM sa JOIN sb ON sa.s = sb.s AND sa.n = sb.n",
    "SELECT sa.v, sb.u FROM sa FULL JOIN sb ON sa.s = sb.s",
    "SELECT na.v, nb.s FROM na LEFT JOIN nb ON na.k = nb.k",
    "SELECT na.v, nb.s FROM na FULL JOIN nb ON na.k = nb.k",
    "SELECT sfact.fk, COUNT(sfact.x), SUM(sfact.x) FROM sfact JOIN sdim ON sfact.fk = sdim.pk GROUP BY fk",
    "SELECT sfact.x, sdim.w FROM sfact LEFT JOIN sdim ON sfact.fk = sdim.pk",
    "SELECT sfact.x, sdim.pk FROM sfact FULL JOIN sdim ON sfact.fk = sdim.pk",
    "SELECT t2.k, e.v FROM t2 LEFT JOIN e ON t2.k = e.k",
    "SELECT t2.k, e.v FROM t2 FULL JOIN e ON t2.k = e.k",
    "SELECT e.v, t2.k FROM e FULL JOIN t2 ON e.k = t2.k",
    "SELECT t2.k FROM t2 JOIN e ON t2.k = e.k",
]


@pytest.mark.parametrize("sql", BROADCAST)
def test_broadcast_join_in_order(contexts, sql):
    single, mesh = contexts
    assert "join: broadcast" in mesh.sql("EXPLAIN VERBOSE " + sql).result_str()
    assert mesh.sql(sql).result_str() == single.sql(sql).result_str()


@pytest.mark.parametrize("sql", SHUFFLE)
def test_shuffle_join_multiset(contexts, sql):
    single, mesh = contexts
    assert "join: shuffle" in mesh.sql("EXPLAIN VERBOSE " + sql).result_str()
    got = mesh.sql(sql)
    want = single.sql(sql).result_str()
    assert Counter(got.result_str().splitlines()) == Counter(want.splitlines())
    assert any(r.startswith("join: shuffle") for r in got.routes)


@pytest.mark.parametrize(
    "sql,salt",
    [
        ("SELECT sfact.fk, COUNT(sfact.x), SUM(sfact.x) FROM sfact JOIN sdim ON sfact.fk = sdim.pk GROUP BY fk", 2),
        ("SELECT orders.oid, people.name FROM orders JOIN people ON orders.pid = people.pid", 1),
        ("SELECT dim.pk, fact.x FROM dim JOIN fact ON fact.fk = dim.pk", 1),
    ],
)
def test_shuffle_skew_salt(contexts, sql, salt):
    _, mesh = contexts
    assert f"join: shuffle, skew salt {salt}" in mesh.sql(sql).routes


def test_broadcast_dense_groupby_per_shard(contexts):
    """The broadcast direct join bounds the key, so GROUP BY k after it
    runs dense per shard (j1's route on the card)."""
    _, mesh = contexts
    txt = mesh.sql("EXPLAIN VERBOSE SELECT fact.fk, COUNT(fact.x) FROM fact JOIN dim ON fact.fk = dim.pk "
                   "GROUP BY fk").result_str()
    assert "local direct" in txt and "dense sort-free group-by per shard (int[0,799])" in txt


@pytest.mark.parametrize("salt_r", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hash_keys_equal_reference(dtype, salt_r):
    rng = np.random.default_rng(salt_r)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, 4096, dtype=dtype, endpoint=True)
    b = rng.integers(-50, 50, 4096).astype(dtype)
    salt = np.arange(4096, dtype=np.int32) % salt_r
    for keys in ([a], [a, b]):
        want = ref_hash([jnp.asarray(k) for k in keys], 8, salt_r=salt_r, salt=jnp.asarray(salt))
        got = hash_keys_to_device([torch.from_numpy(k) for k in keys], 8, salt_r=salt_r,
                                  salt=torch.from_numpy(salt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the JAX mesh itself, twice: the broadcast join in order, the shuffle as a multiset
@pytest.mark.parametrize(
    "sql,ordered",
    [
        ("SELECT orders.oid, people.name FROM orders LEFT JOIN people ON orders.pid = people.pid ORDER BY oid", True),
        ("SELECT fact.fk, COUNT(fact.x), SUM(fact.x) FROM fact JOIN dim ON fact.fk = dim.pk GROUP BY fk ORDER BY fk",
         True),
    ],
)
def test_against_the_jax_mesh(sql, ordered):
    r = ref.ExecutionContext(mesh=ref_mesh())
    p = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    tables = _tables()
    register_both(r, p, {n: tables[n] for n in ("orders", "people", "fact", "dim")})
    assert p.sql(sql).result_str() == r.sql(sql).result_str()
