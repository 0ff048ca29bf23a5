"""Kernel K2 (segmented reduce) on the CPU: the port's plain version
against the JAX package's `segmented_reduce_sorted(..., interpret=True)`
on the cases tests/test_pallas_segreduce.py uses, plus dense mode with
unsorted ids. Inputs are f32/i32, the JAX kernel's domain.

COUNT, MIN and MAX must match exactly. SUM is held to rtol=1e-6: the JAX
kernel sums in f32 in block order while the port sums in f64, so the two
differ by the f32 rounding of the JAX side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datafusion_tpu.ops.pallas.segreduce import BLOCK, segmented_reduce_sorted
from datafusion_tpu_torch.ops.pallas.segreduce import (
    DENSE_MAX_SLOTS,
    FOLD_SMEM_BYTES,
    MAX_REPLICAS,
    REPLICA_BUDGET,
    FOLD_MAX_OPS,
    fold_launches,
    fold_tables,
    segmented_reduce,
    segmented_reduce_plain,
    sorted_launch_ops,
)


def _both(gid, vals, masks, ops, num_groups, dense=False):
    jax_out = segmented_reduce_sorted(
        jnp.asarray(gid),
        tuple(None if v is None else jnp.asarray(v) for v in vals),
        tuple(None if m is None else jnp.asarray(m) for m in masks),
        ops=tuple(ops), num_groups=num_groups, interpret=True, dense=dense,
        **({"block": 1024} if dense else {}),
    )
    port_out = segmented_reduce(
        torch.from_numpy(gid),
        [None if v is None else torch.from_numpy(v) for v in vals],
        [None if m is None else torch.from_numpy(m) for m in masks],
        ops=ops, num_groups=num_groups, dense=dense,
    )
    return [np.asarray(o) for o in jax_out], [o.numpy() for o in port_out]


def _check(ops, jax_out, port_out):
    for op, j, p in zip(ops, jax_out, port_out):
        if op == "sum":
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-3)
        elif op == "count":
            np.testing.assert_array_equal(p, j.astype(np.int64))
        else:
            np.testing.assert_array_equal(p, j)


def make_case(n, g, seed=0, invalid_tail=0):
    rng = np.random.default_rng(seed)
    n_valid = n - invalid_tail
    gid = np.sort(rng.integers(0, g, n_valid).astype(np.int32))
    _, gid = np.unique(gid, return_inverse=True)
    num_groups = int(gid.max()) + 1 if n_valid else 0
    full = np.concatenate([gid.astype(np.int32), np.full(invalid_tail, num_groups, np.int32)])
    vals = rng.random(n).astype(np.float32) * 100
    mask = np.concatenate([np.ones(n_valid, np.bool_), np.zeros(invalid_tail, np.bool_)])
    return full, vals, mask, num_groups


@pytest.mark.parametrize("invalid_tail", [0, 700])
def test_invalid_tail(invalid_tail):
    gid, vals, mask, g = make_case(BLOCK * 8, 300, invalid_tail=invalid_tail)
    ops = ("sum", "count", "min", "max")
    _check(ops, *_both(gid, (vals, None, vals, vals), (mask,) * 4, ops, g))


def test_single_group():
    n = BLOCK * 2
    gid = np.zeros(n, np.int32)
    vals = np.ones(n, np.float32)
    ops = ("sum", "max")
    _check(ops, *_both(gid, (vals, vals), (np.ones(n, np.bool_),) * 2, ops, 1))


def test_every_row_its_own_group():
    n = BLOCK * 2
    gid = np.arange(n, dtype=np.int32)
    vals = np.arange(n, dtype=np.float32)
    ops = ("max", "min", "count")
    _check(ops, *_both(gid, (vals, vals, None), (None,) * 3, ops, n))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_with_masks(seed):
    """Random sorted ids + per-op masks; groups a mask empties read the
    ±inf identities on both sides."""
    rng = np.random.default_rng(seed)
    n = BLOCK * 4
    g = rng.integers(20, 400)
    gid = np.sort(rng.integers(0, g, n)).astype(np.int32)
    _, gid = np.unique(gid, return_inverse=True)
    gid = gid.astype(np.int32)
    num_groups = int(gid.max()) + 1
    vals = (rng.standard_normal(n) * 50).astype(np.float32)
    ivals = rng.integers(-1000, 1000, n).astype(np.int32)
    m1 = rng.random(n) < 0.8
    m2 = rng.random(n) < 0.05
    ops = ("min", "max", "sum", "count", "min", "max")
    _check(ops, *_both(gid, (vals, vals, vals, None, ivals, ivals), (m1, m1, m2, m2, m2, m1), ops, num_groups))


def test_run_spanning_blocks():
    n = BLOCK * 3
    gid = np.zeros(n, np.int32)
    gid[2 * BLOCK + 100:] = 1
    vals = np.arange(n, dtype=np.float32)
    vals[BLOCK + 7] = -99.0
    mask = np.ones(n, np.bool_)
    ops = ("min", "max", "sum")
    _check(ops, *_both(gid, (vals,) * 3, (mask,) * 3, ops, 2))


@pytest.mark.parametrize("seed", [4, 5])
def test_dense_unsorted_ids(seed):
    rng = np.random.default_rng(seed)
    n, g = BLOCK * 4, 900
    gid = rng.integers(0, g + 1, n).astype(np.int32)  # id g: dropped rows
    vals = (rng.standard_normal(n) * 10).astype(np.float32)
    ivals = rng.integers(-50, 50, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    ops = ("sum", "count", "min", "max", "max")
    _check(ops, *_both(gid, (vals, None, vals, vals, ivals), (mask, None, mask, None, mask), ops, g, dense=True))


# The cases the dense kernel's design must survive: a small table with
# most rows on one slot (replicas), the widest table the JAX dense mode
# takes at block 1024 (its window is ALIGN + block = 2048 slots), and an
# op list longer than one launch's shared memory holds at that width.
DENSE_EDGE_OPS = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum",
                  "min", "max")


@pytest.mark.parametrize("case,g,n_ops", [("skew", 8, 5), ("edge", DENSE_MAX_SLOTS, 5), ("split", 2048, 15)])
def test_dense_edge_cases(case, g, n_ops):
    rng = np.random.default_rng(len(case) + g)
    n = BLOCK * 4
    gid = rng.integers(0, g + 1, n).astype(np.int32)  # id g: dropped rows
    if case == "skew":
        gid[rng.random(n) < 0.8] = 3
    vals = (rng.standard_normal(n) * 10).astype(np.float32)
    ivals = rng.integers(-50, 50, n).astype(np.int32)
    m1, m2 = rng.random(n) < 0.7, rng.random(n) < 0.4
    ops = DENSE_EDGE_OPS[:n_ops]
    vs = tuple(None if op == "count" else (ivals if a % 3 == 2 else vals) for a, op in enumerate(ops))
    ms = tuple((m1, None, m2)[a % 3] for a in range(n_ops))
    assert len(fold_launches([1] * n_ops, g)) == (2 if case == "split" else 1)
    _check(ops, *_both(gid, vs, ms, ops, g, dense=True))


@pytest.mark.parametrize("n_ops,g,want", [
    (4, 1001, [(0, 4, 1)]),  # q3: 32 KB of tables, one copy
    (4, 8, [(0, 4, 32)]),  # m2: one replica per lane
    (5, 1251, [(0, 5, 1)]),  # m3's fold
    (1, 2048, [(0, 1, 2)]),
    (14, 2048, [(0, 14, 1)]),  # the most 2048-slot tables one launch holds
    (15, 2048, [(0, 7, 1), (7, 15, 1)]),  # split evenly into the fewest launches
    (40, 2048, [(0, 13, 1), (13, 26, 1), (26, 40, 1)]),
    (33, 1, [(0, 16, 32), (16, 33, 32)]),  # past the ops a launch's struct holds
])
def test_fold_launches(n_ops, g, want):
    got = fold_launches([1] * n_ops, g)
    assert got == want
    for lo, hi, reps in got:
        assert (hi - lo) * g * 8 <= FOLD_SMEM_BYTES and 1 <= reps <= MAX_REPLICAS and reps & (reps - 1) == 0
        assert reps == 1 or reps * (hi - lo) * g * 8 <= REPLICA_BUDGET


@pytest.mark.parametrize("n_ops,want", [
    (1, [(0, 1)]),
    (4, [(0, 4)]),  # q2: one launch
    (FOLD_MAX_OPS, [(0, 32)]),
    (33, [(0, 16), (16, 33)]),  # split evenly into the fewest launches
    (65, [(0, 21), (21, 43), (43, 65)]),
])
def test_sorted_launch_ops(n_ops, want):
    assert sorted_launch_ops(n_ops) == want


def test_sorted_op_list_past_one_launch():
    """33 ops, two sorted-mode launches on the card, with masks, f32 and
    i32 values and a dropped tail, against the JAX kernel."""
    gid, vals, mask, g = make_case(BLOCK * 2, 150, seed=9, invalid_tail=100)
    rng = np.random.default_rng(9)
    ivals = rng.integers(-1000, 1000, gid.shape[0]).astype(np.int32)
    m2 = mask & (rng.random(gid.shape[0]) < 0.5)
    ops = tuple(DENSE_EDGE_OPS[a % len(DENSE_EDGE_OPS)] for a in range(33))
    vs = tuple(None if op == "count" else (ivals if a % 3 == 2 else vals) for a, op in enumerate(ops))
    ms = tuple((mask, m2)[a % 2] for a in range(33))
    assert len(sorted_launch_ops(len(ops))) == 2
    _check(ops, *_both(gid, vs, ms, ops, g))


def test_fold_tables_layout():
    """The fold kernels' tables: one zeroed buffer, each op's table in its
    result dtype on an 8-byte boundary, then one counter per launch. In
    sorted mode a float SUM is one f64 table, with its edge slots after
    the counters; on the fold tile (`fixed`) it is four int64 tables (its
    f64 result in the first) and its scale word."""
    f32, i64 = torch.zeros(3, dtype=torch.float32), torch.zeros(3, dtype=torch.int64)
    ops = ("min", "count", "sum", "max", "sum")
    ft = fold_tables(ops, (f32, None, f32, i64, i64), 5, "cpu", lead=(3,), counters=2)
    tables, counters = ft.tables, ft.counters
    assert [t.dtype for t in tables] == [torch.float32, torch.int64, torch.float64, torch.int64, torch.int64]
    assert all(t.shape == (3, 5) and not t.any() for t in tables)
    base = tables[0].data_ptr()
    assert [t.data_ptr() - base for t in tables] == [0, 64, 184, 304, 424]  # 60 bytes of f32 round up to 64
    assert counters == [base + 544, base + 552]
    assert ft.outs == [t.data_ptr() for t in tables] and ft.aux == [0] * 5

    ft = fold_tables(ops, (f32, None, f32, i64, i64), 5, "cpu", lead=(3,), counters=2, edge_blocks=7)
    base = ft.tables[0].data_ptr()
    assert ft.counters == [base + 544, base + 552] and ft.aux == [0, 0, base + 560, 0, 0]  # 7 x 2 16-byte slots

    ft = fold_tables(ops, (f32, None, f32, i64, i64), 5, "cpu", lead=(3,), counters=2, fixed=True)
    base = ft.tables[0].data_ptr()
    assert [t.data_ptr() - base for t in ft.tables] == [0, 64, 184, 672, 792]  # four 120-byte tables + 8
    assert ft.tables[2].dtype == torch.float64 and ft.outs[2] == base + 184
    assert ft.aux == [0, 0, base + 664, 0, 0] and ft.counters == [base + 912, base + 920]


def test_nan_inf_and_wide_types():
    """f64 / i64 values (beyond the JAX kernel's domain) against numpy:
    IEEE sums with NaN and ±inf, NaN past +inf for MIN/MAX, -0.0 == 0.0,
    i64 sums in i64."""
    gid = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3], np.int32)
    f = np.array([1.0, np.nan, 2.0, np.inf, -np.inf, -0.0, 0.0, 5.0, np.nan])
    i = np.array([2**40, 2**40, -1, 7, 8, 9, -9, 1, 3], np.int64)
    ops = ("sum", "min", "max", "sum", "min", "max")
    out = segmented_reduce(
        torch.from_numpy(gid), [torch.from_numpy(x) for x in (f, f, f, i, i, i)], [None] * 6,
        ops=ops, num_groups=5,
    )
    s, mn, mx, si, mni, mxi = (o.numpy() for o in out)
    assert np.isnan(s[0]) and np.isnan(s[1]) and s[2] == 5.0 and np.isnan(s[3]) and s[4] == 0.0
    assert mn[0] == 1.0 and np.isnan(mx[0]) and mn[1] == -np.inf and mx[1] == np.inf
    assert mn[2] == 0.0 and mx[2] == 5.0 and np.isnan(mn[3]) and mn[4] == np.inf and mx[4] == -np.inf
    np.testing.assert_array_equal(si, [2**41 - 1, 15, 1, 3, 0])
    np.testing.assert_array_equal(mni[:4], [-1, 7, -9, 3])
    np.testing.assert_array_equal(mxi[:4], [2**40, 8, 9, 3])
    assert s.dtype == np.float64 and si.dtype == np.int64 and mn.dtype == np.float64


def test_contract_checks():
    gid = torch.zeros(4, dtype=torch.int32)
    v = torch.ones(4)
    with pytest.raises(ValueError):
        segmented_reduce(gid.long(), [v], [None], ops=("sum",), num_groups=1)
    with pytest.raises(ValueError):
        segmented_reduce(gid, [v.half()], [None], ops=("sum",), num_groups=1)
    with pytest.raises(ValueError):
        segmented_reduce(gid, [None], [None], ops=("sum",), num_groups=1)
    with pytest.raises(ValueError):
        segmented_reduce(gid, [None], [None], ops=("count",), num_groups=DENSE_MAX_SLOTS + 1, dense=True)
    # the plain version takes either mode's inputs
    out = segmented_reduce_plain(gid, [None], [None], ops=("count",), num_groups=2)
    assert out[0].tolist() == [4, 0]
