"""K5 (ragged exchange) and K6 (ragged exchange + fold) of the port, in
their plain versions on the CPU, against the JAX package's
`ragged_exchange` and `ragged_exchange_fold` in Pallas interpret mode on
the 8 virtual CPU devices: the same numpy region-layout inputs (built as
tests/test_ragged_fold.py builds them) go to both.

  * K5: every receiver's valid prefixes bit-equal to JAX's and to the
    senders' rows, for uniform, skewed (most rows to one receiver) and
    empty regions
  * K6: COUNT / MIN / MAX exact, f32 sums at the JAX test's rel 1e-5 /
    atol 1e-4 (its kernel sums f32); the port's f64 / i64 values against
    a numpy f64 oracle at rtol 1e-12
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from datafusion_tpu.ops.pallas import ragged_shuffle as jrs
from datafusion_tpu.parallel.mesh import AXIS, make_mesh
from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

N_DEV = 8


def _sizes(rng, split_cap, layout):
    """[sender, receiver] counts: uniform; 80% of every sender's rows to
    receiver 3; or uniform with sender 5 empty."""
    sizes = rng.integers(0, split_cap + 1, (N_DEV, N_DEV))
    if layout == "skew":
        sizes = rng.integers(0, split_cap // 8 + 1, (N_DEV, N_DEV))
        sizes[:, 3] = split_cap
    elif layout == "empty":
        sizes[5, :] = 0
    return sizes.astype(np.int32)


def _jax_call(body, arrays, sizes, n_out):
    """Run `body(*per-device arrays, sizes[n, n])` under shard_map."""
    f = shard_map(
        lambda *a: body(*a[:-1], a[-1].reshape(N_DEV, N_DEV)),
        mesh=make_mesh(),
        in_specs=(P(AXIS),) * (len(arrays) + 1),
        out_specs=(P(AXIS),) * n_out,
        check_vma=False,
    )
    outs = jax.jit(f)(*[jnp.array(a.reshape(-1)) for a in arrays], jnp.array(np.tile(sizes.reshape(-1), N_DEV)))
    return [np.asarray(o).reshape(N_DEV, -1) for o in outs]


@pytest.mark.parametrize("layout", ["uniform", "skew", "empty"])
@pytest.mark.parametrize("split_cap", [128, 512, 2048])
def test_ragged_exchange_matches_jax(split_cap, layout):
    rng = np.random.default_rng(split_cap + len(layout))
    sizes = _sizes(rng, split_cap, layout)
    chunk = rs.pick_chunk(split_cap)
    assert chunk == jrs.pick_chunk(split_cap)
    width = N_DEV * split_cap
    arrays = [
        rng.integers(-(2**31), 2**31, (N_DEV, width)).astype(np.int32),
        (rng.standard_normal((N_DEV, width)) * 100).astype(np.float32),
        rng.integers(0, 2, (N_DEV, width)).astype(np.int8),
    ]
    jout = _jax_call(
        lambda *a: jrs.ragged_exchange(tuple(a[:-1]), a[-1], n_dev=N_DEV, split_cap=split_cap, chunk=chunk,
                                       interpret=True),
        arrays, sizes, len(arrays),
    )
    sends = [[torch.from_numpy(a[j].copy()) for a in arrays] for j in range(N_DEV)]
    recvs = rs.ragged_exchange(sends, torch.from_numpy(sizes), n_dev=N_DEV, split_cap=split_cap, chunk=chunk)
    for i in range(N_DEV):
        for a, arr in enumerate(arrays):
            got = recvs[i][a].numpy()
            for j in range(N_DEV):
                c = sizes[j, i]
                prefix = slice(j * split_cap, j * split_cap + c)
                want = arr[j][i * split_cap: i * split_cap + c]
                assert np.array_equal(got[prefix].view(np.uint8), want.view(np.uint8)), (i, a, j)
                assert np.array_equal(got[prefix].view(np.uint8), jout[a][i][prefix].view(np.uint8)), (i, a, j)


def test_ragged_exchange_moves_any_width():
    """1-, 2- and 8-byte arrays (bools ride as bytes) against the
    senders' rows: the JAX kernel is exercised on 32-bit words above."""
    rng = np.random.default_rng(5)
    split_cap = 256
    sizes = _sizes(rng, split_cap, "uniform")
    width = N_DEV * split_cap
    arrays = [rng.integers(0, 2, (N_DEV, width)).astype(np.bool_), rng.integers(-9, 9, (N_DEV, width)).astype(np.int16),
              rng.standard_normal((N_DEV, width))]
    sends = [[torch.from_numpy(a[j].copy()) for a in arrays] for j in range(N_DEV)]
    recvs = rs.ragged_exchange(sends, torch.from_numpy(sizes), n_dev=N_DEV, split_cap=split_cap, chunk=256)
    for i in range(N_DEV):
        for a, arr in enumerate(arrays):
            for j in range(N_DEV):
                c = sizes[j, i]
                got = recvs[i][a].numpy()[j * split_cap: j * split_cap + c]
                assert np.array_equal(got, arr[j][i * split_cap: i * split_cap + c])
    with pytest.raises(ValueError, match="exceeds split_cap"):
        rs.ragged_exchange(sends, torch.from_numpy(sizes) + split_cap, n_dev=N_DEV, split_cap=split_cap, chunk=256)


def _fold_inputs(rng, dom, split_cap, skew, dtype=np.float32):
    """Region-layout window ids, values and a mask per sender, and the
    count matrix (as tests/test_ragged_fold.py builds them)."""
    width = N_DEV * split_cap
    gid_r = np.zeros((N_DEV, width), np.int32)
    val_r = np.zeros((N_DEV, width), dtype)
    ival_r = np.zeros((N_DEV, width), np.int32)
    msk_r = np.zeros((N_DEV, width), np.int8)
    sizes = np.zeros((N_DEV, N_DEV), np.int32)
    for dev in range(N_DEV):
        n_rows = 0 if dev == 6 else int(rng.integers(100, 900))  # sender 6 sends nothing
        g = rng.integers(0, dom, n_rows).astype(np.int32)
        if skew:
            g[rng.random(n_rows) < 0.8] = 11 % dom  # one gid: 80% of the rows to one receiver
        v = (rng.random(n_rows) * 100 - 50).astype(dtype)
        iv = rng.integers(-(2**30), 2**30, n_rows).astype(np.int32)
        m = (rng.random(n_rows) < 0.8).astype(np.int8)
        dst = g % N_DEV
        for d in range(N_DEV):
            rows = np.flatnonzero(dst == d)
            assert len(rows) <= split_cap
            sizes[dev, d] = len(rows)
            s = d * split_cap
            gid_r[dev, s: s + len(rows)] = g[rows] // N_DEV
            val_r[dev, s: s + len(rows)] = v[rows]
            ival_r[dev, s: s + len(rows)] = iv[rows]
            msk_r[dev, s: s + len(rows)] = m[rows]
    return gid_r, val_r, ival_r, msk_r, sizes


def _port_fold(gid_r, vals_r, msk_r, sizes, ops, mask_map, num_groups, split_cap):
    return rs.ragged_exchange_fold(
        [torch.from_numpy(gid_r[j].copy()) for j in range(N_DEV)],
        [[None if v is None else torch.from_numpy(v[j].copy()) for v in vals_r] for j in range(N_DEV)],
        [[torch.from_numpy(msk_r[j] != 0)] for j in range(N_DEV)],
        torch.from_numpy(sizes),
        ops=ops, mask_map=mask_map, n_dev=N_DEV, split_cap=split_cap, num_groups=num_groups,
    )


@pytest.mark.parametrize("dom,ops,skew", [
    (40, ("sum", "count"), False),
    (300, ("sum", "count", "min", "max"), False),
    (300, ("sum", "count", "min", "max"), True),
    (2048 * 8, ("sum", "count"), False),  # the local window at its 2048 cap
])
def test_ragged_exchange_fold_matches_jax(dom, ops, skew):
    rng = np.random.default_rng(dom + skew)
    split_cap = 1024  # the JAX fold takes 1024-row chunks
    num_groups = -(-dom // N_DEV)
    gid_r, val_r, ival_r, msk_r, sizes = _fold_inputs(rng, dom, split_cap, skew)
    vals = (val_r, val_r, ival_r, ival_r)[: len(ops)]
    jout = _jax_call(
        lambda g, v, iv, m, sz: jrs.ragged_exchange_fold(
            g, (v, v, iv, iv)[: len(ops)], (m,), sz, ops=ops, mask_map=(1,) * len(ops), n_dev=N_DEV,
            split_cap=split_cap, chunk=1024, num_groups=num_groups, interpret=True),
        [gid_r, val_r, ival_r, msk_r], sizes, len(ops),
    )
    port = _port_fold(gid_r, [None if op == "count" else v for op, v in zip(ops, vals)], msk_r, sizes, ops,
                      (1,) * len(ops), num_groups, split_cap)
    for a, op in enumerate(ops):
        got = np.stack([port[i][a].numpy() for i in range(N_DEV)])
        want = jout[a]
        if op == "sum":
            assert np.allclose(got, want, rtol=1e-5, atol=1e-4), op
        else:
            assert np.array_equal(got, want.astype(got.dtype)), op


@pytest.mark.parametrize("skew", [False, True])
def test_ragged_exchange_fold_f64_i64(skew):
    """The port's f64 / i64 values, an op with the implicit mask (every
    routed row) and NaN / +-inf against a numpy f64 oracle."""
    rng = np.random.default_rng(7 + skew)
    dom, split_cap = 1000, 1024
    num_groups = -(-dom // N_DEV)
    gid_r, val_r, ival_r, msk_r, sizes = _fold_inputs(rng, dom, split_cap, skew, np.float64)
    val_r[0, 5], val_r[1, 3], val_r[2, 1030] = np.nan, np.inf, -np.inf
    big_r = ival_r.astype(np.int64) << 20
    ops = ("sum", "count", "min", "max", "sum", "count")
    port = _port_fold(gid_r, [val_r, None, val_r, big_r, big_r, None], msk_r, sizes, ops, (1, 1, 1, 0, 0, 0),
                      num_groups, split_cap)
    for i in range(N_DEV):
        for w in range(num_groups):
            vs, bs, ms = [], [], []
            for j in range(N_DEV):
                lo = i * split_cap
                rows = slice(lo, lo + sizes[j, i])
                hit = gid_r[j, rows] == w
                vs.append(val_r[j, rows][hit])
                bs.append(big_r[j, rows][hit])
                ms.append(msk_r[j, rows][hit] != 0)
            v, b, m = np.concatenate(vs), np.concatenate(bs), np.concatenate(ms)
            s, c, mn, mx, bsum, n_all = (t[w].item() for t in port[i])
            want = v[m].sum() if m.any() else 0.0
            assert (np.isnan(s) and np.isnan(want)) or s == pytest.approx(want, rel=1e-12, abs=1e-9), (i, w)
            assert c == m.sum() and n_all == len(v) and bsum == b.sum()
            assert mx == (b.max() if len(b) else np.iinfo(np.int64).min)
            vm = v[m]
            want_min = np.inf if not len(vm) else (vm[~np.isnan(vm)].min() if (~np.isnan(vm)).any() else np.nan)
            assert (np.isnan(mn) and np.isnan(want_min)) or mn == want_min, (i, w)


def _fold_oracle(gid_r, vals_r, masks_r, sizes, ops, mask_map, num_groups, split_cap):
    """Per receiver, per op, the fold in numpy: f64 sums, i64 counts and
    sums, MIN/MAX of the values (NaN past +inf), +-inf or the integer
    identity for an empty slot."""
    n_dev = sizes.shape[0]
    out = []
    for i in range(n_dev):
        spans = [slice(i * split_cap, i * split_cap + sizes[j, i]) for j in range(n_dev)]
        g = np.concatenate([gid_r[j][sp] for j, sp in enumerate(spans)])
        keep = (g >= 0) & (g < num_groups)
        tables = []
        for a, op in enumerate(ops):
            rows = keep.copy()
            if mask_map[a]:
                rows &= np.concatenate([masks_r[mask_map[a] - 1][j][sp] for j, sp in enumerate(spans)]) != 0
            idx = g[rows]
            if op == "count":
                tables.append(np.bincount(idx, minlength=num_groups))
                continue
            v = np.concatenate([vals_r[a][j][sp] for j, sp in enumerate(spans)])[rows]
            if op == "sum":
                acc = np.float64 if v.dtype.kind == "f" else np.int64
                t = np.zeros(num_groups, acc)
                with np.errstate(invalid="ignore"):  # +inf + -inf is NaN, as on the card
                    np.add.at(t, idx, v.astype(acc))
            else:
                big = op == "min"
                if v.dtype.kind == "f":
                    t = np.full(num_groups, np.inf if big else -np.inf)
                    nan = np.zeros(num_groups, bool)
                    nan[idx[np.isnan(v)]] = True
                    (np.fmin if big else np.fmax).at(t, idx, v)
                    hit = np.bincount(idx[~np.isnan(v)], minlength=num_groups) > 0
                    # NaN sorts past +inf: a NaN is the MAX of its slot, and the MIN where it is alone
                    t = np.where(nan & ~hit if big else nan, np.nan, t)
                    t = t.astype(v.dtype)
                else:
                    info = np.iinfo(v.dtype)
                    t = np.full(num_groups, info.max if big else info.min, v.dtype)
                    (np.minimum if big else np.maximum).at(t, idx, v)
            tables.append(t)
        out.append(tables)
    return out


def _assert_fold(port, want, ops):
    for i, (got_i, want_i) in enumerate(zip(port, want)):
        for a, op in enumerate(ops):
            got, w = got_i[a].numpy(), want_i[a]
            if op == "sum" and got.dtype.kind == "f":
                assert np.allclose(got, w, rtol=1e-12, atol=1e-9, equal_nan=True), (i, a)
            else:
                assert got.dtype == w.dtype and np.array_equal(got, w, equal_nan=got.dtype.kind == "f"), (i, a, op)


# K6's edge cases: a 2048-slot table per receiver with 14 ops (the most
# one launch's shared memory holds), and a mesh of one shard
FOLD_EDGE_OPS = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum", "min")


def test_ragged_exchange_fold_14_ops_matches_jax():
    """14 ops, the most one launch's shared memory holds at 2048 slots,
    against JAX at its narrowest window (the 2048-slot tables are held
    to the f64 numpy oracle below)."""
    rng = np.random.default_rng(2048)
    split_cap, dom = 1024, 300
    num_groups = -(-dom // N_DEV)
    gid_r, val_r, ival_r, msk_r, sizes = _fold_inputs(rng, dom, split_cap, False)
    ops = FOLD_EDGE_OPS
    ints = tuple(op in ("min", "max") and a % 3 == 2 for a, op in enumerate(ops))  # the JAX fold sums f32 only
    vals = tuple(ival_r if i else val_r for i in ints)
    jout = _jax_call(
        lambda g, v, iv, m, sz: jrs.ragged_exchange_fold(
            g, tuple(iv if i else v for i in ints), (m,), sz, ops=ops,
            mask_map=(1,) * len(ops), n_dev=N_DEV, split_cap=split_cap, chunk=1024, num_groups=num_groups,
            interpret=True),
        [gid_r, val_r, ival_r, msk_r], sizes, len(ops),
    )
    port = _port_fold(gid_r, [None if op == "count" else v for op, v in zip(ops, vals)], msk_r, sizes, ops,
                      (1,) * len(ops), num_groups, split_cap)
    assert len(rs.fold_launches([1] * len(ops), 2048)) == 1
    for a, op in enumerate(ops):
        got = np.stack([port[i][a].numpy() for i in range(N_DEV)])
        if op == "sum":
            assert np.allclose(got, jout[a], rtol=1e-5, atol=1e-4), a
        else:
            assert np.array_equal(got, jout[a].astype(got.dtype)), a


@pytest.mark.parametrize("n_dev,num_groups", [(1, 300), (1, 2048), (8, 2048)])
def test_ragged_exchange_fold_edges_f64_oracle(n_dev, num_groups):
    """One shard (every row stays home), and 2048 slots per receiver with
    14 ops, f64 / i64 values, two masks and the implicit one, NaN / +-inf,
    against the numpy f64 oracle."""
    rng = np.random.default_rng(n_dev * 10_000 + num_groups)
    split_cap = 1024
    width = n_dev * split_cap
    sizes = rng.integers(0, split_cap + 1, (n_dev, n_dev)).astype(np.int32)
    gid_r = rng.integers(-1, num_groups + 2, (n_dev, width)).astype(np.int32)  # some ids dropped
    f = rng.standard_normal((n_dev, width)) * 100
    f[:, 5::97], f[:, 7::89], f[:, 11::83] = np.nan, np.inf, -np.inf
    big = rng.integers(-(2**40), 2**40, (n_dev, width))
    m1, m2 = rng.random((n_dev, width)) < 0.8, rng.random((n_dev, width)) < 0.3
    ops = FOLD_EDGE_OPS
    vals_r = [None if op == "count" else (big if a % 3 == 2 else f) for a, op in enumerate(ops)]
    mask_map = tuple(a % 3 for a in range(len(ops)))  # 0: every routed row
    port = rs.ragged_exchange_fold(
        [torch.from_numpy(gid_r[j]) for j in range(n_dev)],
        [[None if v is None else torch.from_numpy(v[j]) for v in vals_r] for j in range(n_dev)],
        [[torch.from_numpy(m1[j]), torch.from_numpy(m2[j])] for j in range(n_dev)],
        torch.from_numpy(sizes), ops=ops, mask_map=mask_map, n_dev=n_dev, split_cap=split_cap,
        num_groups=num_groups,
    )
    want = _fold_oracle(gid_r, vals_r, [m1, m2], sizes, ops, mask_map, num_groups, split_cap)
    _assert_fold(port, want, ops)


def test_fold_pointer_table_layout():
    """K6's packed table: ids by sender, then each op's values by sender,
    then each op's masks by sender, 0 for a COUNT's value or no mask; a
    launch's table holds its own ops only."""
    n_dev = 3
    gids = [torch.zeros(4, dtype=torch.int32) for _ in range(n_dev)]
    vals = [[torch.zeros(4), None] for _ in range(n_dev)]
    masks = [[None, torch.zeros(4, dtype=torch.bool)] for _ in range(n_dev)]
    table = rs.fold_pointer_table(gids, vals, masks, range(2))
    assert len(table) == n_dev * (1 + 2 * 2)
    assert table[:3] == [g.data_ptr() for g in gids]
    assert table[3:6] == [v[0].data_ptr() for v in vals] and table[6:9] == [0, 0, 0]
    assert table[9:12] == [0, 0, 0] and table[12:15] == [m[1].data_ptr() for m in masks]
    table = rs.fold_pointer_table(gids, vals, masks, range(1, 2))
    assert len(table) == n_dev * (1 + 2) and table[:3] == [g.data_ptr() for g in gids]
    assert table[3:6] == [0, 0, 0] and table[6:9] == [m[1].data_ptr() for m in masks]


def test_fold_contract_checks():
    """The fold refuses what its kernel cannot take: a sender whose values
    differ in dtype from sender 0's (the kernel reads each op's kind from
    sender 0), ids that are not int32, a mask that is not bool, and a
    region of the wrong length."""
    n_dev, split_cap = 2, 128
    width = n_dev * split_cap

    def fold(gids=None, vals=None, masks=None):
        gids = gids or [torch.zeros(width, dtype=torch.int32) for _ in range(n_dev)]
        vals = vals or [[torch.zeros(width), None] for _ in range(n_dev)]
        masks = masks or [[torch.ones(width, dtype=torch.bool)] for _ in range(n_dev)]
        return rs.ragged_exchange_fold(gids, vals, masks, torch.zeros(n_dev, n_dev, dtype=torch.int32),
                                       ops=("sum", "count"), mask_map=(1, 0), n_dev=n_dev, split_cap=split_cap,
                                       num_groups=4)

    assert [t.tolist() for t in fold()[0]] == [[0.0] * 4, [0] * 4]
    with pytest.raises(ValueError, match="dtypes"):
        fold(vals=[[torch.zeros(width), None], [torch.zeros(width, dtype=torch.float64), None]])
    with pytest.raises(ValueError, match="int32"):
        fold(gids=[torch.zeros(width, dtype=torch.int32), torch.zeros(width, dtype=torch.int64)])
    with pytest.raises(ValueError, match="bool"):
        fold(masks=[[torch.ones(width, dtype=torch.bool)], [torch.ones(width, dtype=torch.uint8)]])
    with pytest.raises(ValueError, match="region-layout"):
        fold(vals=[[torch.zeros(width), None], [torch.zeros(width - 1), None]])
