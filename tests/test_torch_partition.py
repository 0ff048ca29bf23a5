"""Kernels K3 (slab partition) and K4 (windowed reduce) on the CPU: the
port's plain versions against the JAX package's `slab_partition` and
`windowed_reduce` (ops/pallas/partition.py, interpret=True) on the cases
of tests/test_partition_kernels.py.

K3 is a stable permutation, so the gid and payload slabs must be equal
to the JAX slabs element for element. K4: counts, i32 MIN and f32 MAX
must be exact; sums are held to rtol=1e-5 against JAX, which sums in
f32, and to rtol=1e-12 against an f64 numpy oracle (the port sums in
f64). A ragged row count, which the JAX kernel cannot take, is held to
the slab's invariants instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datafusion_tpu.ops.pallas import partition as jp
from datafusion_tpu_torch.ops.aggregate import slab_reduce
from datafusion_tpu_torch.ops.pallas.partition import (
    MAX_OPS,
    SENTINEL,
    SLAB_CHUNK,
    WINDOW,
    slab_capacity,
    slab_partition,
    windowed_reduce,
)
from datafusion_tpu_torch.ops.pallas.segreduce import segmented_reduce_plain


def _layout(nslots):
    gcap = nslots + 1
    return 1 << (gcap - 1).bit_length(), -(-gcap // WINDOW)  # id_mod, n_buckets


def _gids(n, nslots, skew, seed=7):
    rng = np.random.default_rng(seed)
    if skew:
        return np.where(rng.random(n) < 0.8, 9999, rng.integers(0, nslots, n)).astype(np.int32)
    return rng.integers(0, nslots, n).astype(np.int32)


@pytest.mark.parametrize("n,nslots,skew", [(2048, 3000, False), (4096, 66000, False), (8192, 10000, True)])
def test_slab_equals_the_jax_slab(n, nslots, skew):
    gid = _gids(n, nslots, skew)
    v = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    id_mod, nb = _layout(nslots)
    pblock = jp.pick_pblock(n)
    jg, jv = jp.slab_partition(jnp.asarray(gid.astype(np.float32)), (jnp.asarray(v),), n_buckets=nb,
                               id_mod=id_mod, pblock=pblock, interpret=True)
    pg, pv = slab_partition(torch.from_numpy(gid), [torch.from_numpy(v)], n_buckets=nb, id_mod=id_mod, pblock=pblock)
    assert pg.dtype == torch.int32 and pv.dtype == torch.float32
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg).astype(np.int32))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,pblock", [(10_000, 4096), (5000, 8192)])
def test_ragged_slab_invariants(n, pblock):
    """Every row once with its payloads, one bucket per chunk, rows in
    input order within a bucket, gaps SENTINEL / 0; payloads of 1, 2, 4
    and 8 bytes (NaN and +-inf move bit for bit)."""
    nslots = 16_000
    rng = np.random.default_rng(3)
    gid = np.where(rng.random(n) < 0.5, 9999, rng.integers(0, nslots, n)).astype(np.int32)
    row = np.arange(n, dtype=np.int64)
    f = rng.standard_normal(n)
    f[::7], f[1::11], f[2::13] = np.nan, np.inf, -np.inf
    u8 = rng.integers(0, 256, n).astype(np.uint8)
    i16 = rng.integers(-(2**15), 2**15, n).astype(np.int16)
    f32 = rng.standard_normal(n).astype(np.float32)
    id_mod, nb = _layout(nslots)
    outs = slab_partition(torch.from_numpy(gid), [torch.from_numpy(a) for a in (row, f, u8, i16, f32)],
                          n_buckets=nb, id_mod=id_mod, pblock=pblock)
    og, orow, of, ou8, oi16, of32 = (o.numpy() for o in outs)
    scap = slab_capacity(pblock, nb)
    assert len(og) == -(-n // pblock) * scap
    live = og != SENTINEL
    assert live.sum() == n
    np.testing.assert_array_equal(np.sort(orow[live]), row)
    r = orow[live]
    np.testing.assert_array_equal(og[live], gid[r])
    np.testing.assert_array_equal(of[live].view(np.int64), f[r].view(np.int64))
    np.testing.assert_array_equal(ou8[live], u8[r])
    np.testing.assert_array_equal(oi16[live], i16[r])
    np.testing.assert_array_equal(of32[live], f32[r])
    for a in (orow, of, ou8, oi16, of32):
        assert not a[~live].any()
    for c in range(len(og) // SLAB_CHUNK):
        sl = slice(c * SLAB_CHUNK, (c + 1) * SLAB_CHUNK)
        g, rows = og[sl][live[sl]], orow[sl][live[sl]]
        if len(g):
            assert len(np.unique((g % id_mod) // WINDOW)) == 1, c
            assert (np.diff(rows) > 0).all(), c  # stable
            assert len(np.unique(rows // pblock)) == 1 and rows[0] // pblock == c * SLAB_CHUNK // scap


def test_windowed_reduce_matches_jax():
    rng = np.random.default_rng(3)
    nslots, n = 9000, 4096
    gid = rng.integers(0, nslots, n).astype(np.int32)
    f = (rng.random(n) * 100 - 50).astype(np.float32)
    iv = rng.integers(-(2**30), 2**30, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    id_mod, nb = _layout(nslots)
    og, of, oiv, om = (o.numpy() for o in slab_partition(
        torch.from_numpy(gid), [torch.from_numpy(a) for a in (f, iv, mask)], n_buckets=nb, id_mod=id_mod, pblock=4096
    ))
    live = og < SENTINEL
    gk = np.where(live, og % id_mod, SENTINEL).astype(np.int32)
    ops = ("count", "sum", "min", "max")
    j = jp.windowed_reduce(
        jnp.asarray(gk), (jnp.asarray(of), jnp.asarray(of), jnp.asarray(oiv), jnp.asarray(of)),
        (jnp.asarray(live), jnp.asarray(live & om), jnp.asarray(live), jnp.asarray(live & om)),
        ops=ops, num_groups=nslots + 1, interpret=True,
    )
    j = [np.asarray(o)[:nslots] for o in j]
    mk = torch.from_numpy(om)
    p = windowed_reduce(
        torch.from_numpy(gk), [None, torch.from_numpy(of), torch.from_numpy(oiv), torch.from_numpy(of)],
        [None, mk, None, mk], ops=ops, num_groups=nslots,
    )
    cnt, sm, mn, mx = (o.numpy() for o in p)
    assert sm.dtype == np.float64 and cnt.dtype == np.int64 and mn.dtype == np.int32 and mx.dtype == np.float32
    np.testing.assert_array_equal(cnt, j[0].astype(np.int64))
    np.testing.assert_allclose(sm, j[1], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(mn, j[2])
    np.testing.assert_array_equal(mx, j[3])
    ws = np.zeros(nslots)
    np.add.at(ws, gid[mask], f[mask].astype(np.float64))
    np.testing.assert_allclose(sm, ws, rtol=1e-12, atol=1e-12)
    wx = np.full(nslots, -np.inf, np.float32)
    np.maximum.at(wx, gid[mask], f[mask])
    np.testing.assert_array_equal(mx, wx)


@pytest.mark.parametrize("shuffled", [False, True])
def test_windowed_reduce_widest_op_list(shuffled):
    """K4's widest op list (MAX_OPS windows: one block's shared memory)
    over 16,383 slots, a ragged slab and, shuffled, rows in any order:
    f64 / i64 values beyond the JAX kernel's domain, against an f64 / i64
    numpy oracle (sums at rtol=1e-12, the rest exact)."""
    rng = np.random.default_rng(8)
    nslots, n = 16_383, 6001
    gid = rng.integers(0, nslots + 1, n).astype(np.int32)  # nslots: unselected rows
    f = rng.standard_normal(n) * 100
    iv = rng.integers(-(10**12), 10**12, n)
    m = rng.random(n) < 0.6
    id_mod, nb = _layout(nslots)
    og, of, oiv, om = slab_partition(torch.from_numpy(gid), [torch.from_numpy(a) for a in (f, iv, m)],
                                     n_buckets=nb, id_mod=id_mod, pblock=4096)
    if shuffled:
        perm = torch.from_numpy(rng.permutation(og.shape[0]))
        og, of, oiv, om = (t[perm].contiguous() for t in (og, of, oiv, om))
    ops = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum", "min")
    assert len(ops) == MAX_OPS
    vals = [None if op == "count" else (oiv if a % 3 == 2 else of) for a, op in enumerate(ops)]
    masks = [(om, None)[a % 2] for a in range(len(ops))]
    got = windowed_reduce(og, vals, masks, ops=ops, num_groups=nslots)
    for a, (op, out) in enumerate(zip(ops, got)):
        x = iv if a % 3 == 2 else f
        keep = (gid < nslots) & (m if a % 2 == 0 else True)
        g, x = gid[keep], x[keep]
        if op == "count":
            np.testing.assert_array_equal(out.numpy(), np.bincount(g, minlength=nslots))
        elif op == "sum":
            want = np.zeros(nslots, x.dtype)
            np.add.at(want, g, x)
            np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-9)
        else:
            if x.dtype == np.float64:
                empty = np.inf if op == "min" else -np.inf
            else:
                empty = np.iinfo(np.int64).max if op == "min" else np.iinfo(np.int64).min
            want = np.full(nslots, empty, x.dtype)
            (np.minimum if op == "min" else np.maximum).at(want, g, x)
            np.testing.assert_array_equal(out.numpy(), want)


def test_slab_reduce_matches_the_plain_reduce():
    """The bigdense reducer (masks packed into gid bits, payloads through
    K3, unpacked for K4) against K2's plain reduce on the unpartitioned
    rows: exact counts and MIN/MAX, sums at rtol=1e-12."""
    rng = np.random.default_rng(5)
    n, nslots = 7000, 12_000
    gid = torch.from_numpy(rng.integers(0, nslots + 1, n).astype(np.int32))  # nslots = unselected
    f = torch.from_numpy(rng.standard_normal(n))
    f[::97] = float("nan")
    i = torch.from_numpy(rng.integers(-(10**6), 10**6, n).astype(np.int32))
    m1, m2 = torch.from_numpy(rng.random(n) < 0.8), torch.from_numpy(rng.random(n) < 0.5)
    ops = ("count", "sum", "count", "min", "max", "sum", "count")
    vals, masks = [None, f, None, f, i, i, None], [None, m1, m1, m2, m2, None, m2]
    got = slab_reduce(gid, vals, masks, ops=ops, num_groups=nslots)
    want = segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=nslots)
    for op, a, b in zip(ops, got, want):
        if op == "sum" and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            assert torch.equal(a.nan_to_num(0.5), b.nan_to_num(0.5)), op


def test_wrappers_reject_what_the_kernels_cannot_take():
    g = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        slab_partition(g, [], n_buckets=1, id_mod=3000)
    with pytest.raises(ValueError, match="n_buckets"):
        slab_partition(g, [], n_buckets=65, id_mod=1 << 20)
    with pytest.raises(ValueError, match="bytes wide"):
        slab_partition(g, [torch.zeros(8, dtype=torch.complex128)], n_buckets=1, id_mod=2048)
    with pytest.raises(ValueError, match="at most"):
        windowed_reduce(g, [None] * (MAX_OPS + 1), [None] * (MAX_OPS + 1), ops=("count",) * (MAX_OPS + 1),
                        num_groups=4)
    with pytest.raises(ValueError, match="SENTINEL"):
        windowed_reduce(g, [None], [None], ops=("count",), num_groups=SENTINEL + 1)


def test_k4_launches_fit_the_kernel_entry():
    """K4's launch plan (`fold_launches` over `fold_widths`; K4 takes no replicas)
    keeps every launch within what csrc/partition.cu's C entry takes: at
    most FOLD_MAX_OPS ops and MAX_OPS shared windows, a float SUM taking
    FIX_TABLES of them. Every op list up to MAX_OPS ops, from no float SUM
    to all, in several orders."""
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    rng = np.random.default_rng(3)
    f, i = torch.zeros(1, dtype=torch.float64), torch.zeros(1, dtype=torch.int64)
    for n_ops in range(1, MAX_OPS + 1):
        for n_fix in range(n_ops + 1):
            for _ in range(3):
                fix = set(rng.permutation(n_ops)[:n_fix].tolist())
                ops = [("sum" if a in fix else ("count", "min", "sum")[a % 3]) for a in range(n_ops)]
                vals = [f if a in fix else None if op == "count" else i for a, op in enumerate(ops)]
                widths = sr.fold_widths(ops, vals)
                launches = sr.fold_launches(widths, WINDOW)
                stops = [hi for _, hi, _ in launches]
                assert [lo for lo, _, _ in launches] == [0] + stops[:-1] and stops[-1] == n_ops
                for lo, hi, reps in launches:
                    assert hi - lo <= sr.FOLD_MAX_OPS and sum(widths[lo:hi]) <= MAX_OPS
                if sum(widths) <= MAX_OPS:
                    assert len(launches) == 1
