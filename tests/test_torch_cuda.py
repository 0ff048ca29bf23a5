"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and skips without one; on the
card run them with `python -m pytest tests/test_torch_cuda.py -q`. The
file imports neither jax nor the JAX package (the card's machine has
no JAX)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as port
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.ops.pallas import segreduce as sr

ROOT = Path(__file__).resolve().parents[1]

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _table(n, seed, device):
    rng = np.random.default_rng(seed)
    P = port.DataType
    schema = port.Schema([
        port.Field("k", P.Int32, False), port.Field("lat", P.Float64, False),
        port.Field("lng", P.Float64, False), port.Field("nv", P.Float64, True),
        port.Field("j", P.Int32, True), port.Field("f", P.Float32, False),
    ])
    arrays = [
        rng.integers(0, 50, n).astype(np.int32), rng.random(n) * 40 + 30, rng.random(n) * 360 - 180,
        rng.random(n) * 10, rng.integers(-4, 5, n).astype(np.int32), rng.standard_normal(n).astype(np.float32),
    ]
    validity = [None, None, None, rng.random(n) > 0.2, rng.random(n) > 0.1, None]
    return port.Table.from_arrays(schema, arrays, validity=validity, device=device)


SQL = [
    "SELECT k, lat + lng FROM t WHERE lat > 51.0 AND lat < 53",
    "SELECT CASE WHEN j > 0 THEN k / j ELSE k % (j - j) END, CAST(nv AS INT), f * 2 + f FROM t WHERE nv < 5",
    "SELECT k, MIN(lat), MAX(lat), SUM(lng), COUNT(nv) FROM t GROUP BY k",
    "SELECT j, MIN(f), MAX(nv), COUNT(*) FROM t GROUP BY j ORDER BY j",
]


@pytest.mark.parametrize("sql", SQL)
def test_queries_match_the_cpu(cuda, sql):
    """The same query on the card (kernels) and on the CPU (plain
    versions): exact except float sums, at rtol=1e-12 (the card adds them
    in fixed point or span order, the same bits in every run; the CPU in
    row order)."""
    gpu, cpu = port.ExecutionContext(device=cuda), port.ExecutionContext(device="cpu")
    t = _table(20_000, 3, "cpu")
    gpu.register_table("t", t)
    cpu.register_table("t", t)
    a, b = gpu.sql(sql).result_str().splitlines(), cpu.sql(sql).result_str().splitlines()
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra.split("\t"), rb.split("\t")):
            if x != y:
                assert "SUM" in sql and abs(float(x) - float(y)) <= 1e-12 * abs(float(y)), (x, y)


@pytest.mark.parametrize("dense", [False, True])
def test_segreduce_kernel_matches_plain(cuda, dense):
    rng = np.random.default_rng(11)
    n, g = 1 << 20, 1000 if dense else 50_000
    ids = rng.integers(0, g, n)
    gid = torch.from_numpy((ids if dense else np.sort(ids)).astype(np.int32)).to(cuda)
    f = torch.from_numpy(rng.standard_normal(n)).to(cuda)
    f[::997] = float("nan")
    i = torch.from_numpy(rng.integers(-10**6, 10**6, n)).to(cuda)
    m = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    vals, masks = [f, None, f, f, i, i.int(), f.float()], [m, m, None, m, None, m, m]
    ops = ("sum", "count", "min", "max", "sum", "max", "min")
    k = sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g, dense=dense)
    p = sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0], p[0], rtol=1e-12, atol=1e-9, equal_nan=True)
    for a, b in zip(k[1:], p[1:]):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    if dense:  # the fold tile's float SUM equals the plain fixed-point function bit for bit
        for a, want in _chip_smoke().fixed_sums(gid, vals, masks, ops, g).items():
            assert torch.equal(k[a].view(torch.int64), want.view(torch.int64)), a


EDGE_OPS = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum", "min",
            "max")


def _edge_streams(rng, n, n_ops, cuda):
    """Op a's value (None for COUNT; i64 where a % 3 == 2, else f64 with
    NaN / +-inf) and mask (none where a % 3 == 1)."""
    f = torch.from_numpy(rng.standard_normal(n) * 100).to(cuda)
    f[::997], f[5::1999], f[9::2003] = float("nan"), float("inf"), float("-inf")
    i = torch.from_numpy(rng.integers(-10**12, 10**12, n)).to(cuda)
    m1, m2 = (torch.from_numpy(rng.random(n) < p).to(cuda) for p in (0.9, 0.4))
    ops = EDGE_OPS[:n_ops]
    vals = [None if op == "count" else (i if a % 3 == 2 else f) for a, op in enumerate(ops)]
    return ops, vals, [(m1, None, m2)[a % 3] for a in range(n_ops)]


def _assert_tables(ops, k, p):
    """Counts and MIN/MAX exact, f64 sums at rtol 1e-12 (the card's
    fixed-point or span-order sums against the CPU's row order)."""
    for op, a, b in zip(ops, k, p):
        if op == "sum" and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-9, equal_nan=True)
        else:
            assert a.dtype == b.dtype and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), op


@pytest.mark.parametrize("case,g,n_ops", [("skew", 8, 5), ("uniform", 1000, 5), ("edge", 2048, 5),
                                          ("split", 2048, 15), ("unaligned", 1000, 5)])
def test_segreduce_dense_edges_match_plain(cuda, case, g, n_ops):
    """K2 dense mode: 80% of the rows on one of 8 slots (replicas), the
    2048-slot edge, 15 ops (two launches), and views one row off the
    16-byte alignment (the tile's scalar loads); a ragged last tile."""
    rng = np.random.default_rng(len(case) + g)
    n = (1 << 20) + 3
    ids = rng.integers(0, g + 1, n)
    if case == "skew":
        ids[rng.random(n) < 0.8] = 3
    gid = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    ops, vals, masks = _edge_streams(rng, n, n_ops, cuda)
    if case == "unaligned":
        gid = gid[1:]
        vals = [None if v is None else v[1:] for v in vals]
        masks = [None if m is None else m[1:] for m in masks]
    before = sr.segmented_reduce.dense_launches
    k = sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g, dense=True)
    assert sr.segmented_reduce.dense_launches - before == (2 if case == "split" else 1)
    p = sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g)
    torch.cuda.synchronize()
    _assert_tables(ops, k, p)


def _value_streams(rng, n, n_ops, cuda):
    """Op a's value (None for COUNT; f64 with NaN / +-inf, i64, f32, i32
    by a % 4) and mask (none where a % 3 == 1)."""
    f = rng.standard_normal(n) * 100
    f[::997], f[5::1999], f[9::2003] = np.nan, np.inf, -np.inf
    pool = [torch.from_numpy(x).to(cuda) for x in (f, rng.integers(-10**12, 10**12, n),
                                                  f.astype(np.float32), rng.integers(-10**6, 10**6, n).astype(np.int32))]
    m1, m2 = (torch.from_numpy(rng.random(n) < p).to(cuda) for p in (0.9, 0.4))
    ops = tuple(EDGE_OPS[a % len(EDGE_OPS)] for a in range(n_ops))
    vals = [None if op == "count" else pool[a % 4] for a, op in enumerate(ops)]
    return ops, vals, [(m1, None, m2)[a % 3] for a in range(n_ops)]


@pytest.mark.parametrize("case,n_ops", [("own", 5), ("one", 5), ("long", 5), ("tail", 5), ("split", 15),
                                        ("split", 33), ("unaligned", 5)])
def test_segreduce_sorted_edges_match_plain(cuda, case, n_ops):
    """K2 sorted mode: every row its own group, one group, runs that span
    tiles and blocks, a tail of dropped ids, 15 and 33 ops (33: two
    launches), and views one row off the 16-byte alignment."""
    rng = np.random.default_rng(len(case) + n_ops)
    n = (1 << 20) + 5
    ids = {"own": np.arange(n), "one": np.zeros(n, np.int64), "long": np.sort(rng.integers(0, 7, n))}.get(
        case, np.sort(rng.integers(0, 50_000, n)))
    g = int(ids.max()) + 1
    if case == "tail":
        ids[-123_457:] = g
    gid = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    ops, vals, masks = _value_streams(rng, n, n_ops, cuda)
    if case == "unaligned":
        gid = gid[1:]
        vals = [None if v is None else v[1:] for v in vals]
        masks = [None if m is None else m[1:] for m in masks]
    before = sr.segmented_reduce.sorted_launches
    k = sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g)
    assert sr.segmented_reduce.sorted_launches - before == len(sr.sorted_launch_ops(n_ops)) == (1 if n_ops <= 32 else 2)
    p = sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g)
    torch.cuda.synchronize()
    _assert_tables(ops, k, p)


@pytest.mark.parametrize("case", ["slab", "shuffled", "widest", "skew", "ragged", "four float sums"])
def test_windowed_reduce_edges_match_plain(cuda, case):
    """K4 over K3's slab of 10,001 slots; the same slab shuffled (chunks
    mix buckets: any row order gives the same result); 14 ops over 16,383
    slots; 80% of the rows on one gid; a row count that ends inside a
    chunk; four f64 SUMs, a COUNT and a MAX over 5,000 slots (the 14
    windows a block holds). One launch each, two for the 14 ops (their four
    float SUMs take three windows each); float SUMs equal the plain
    fixed-point function bit for bit."""
    from datafusion_tpu_torch.ops.pallas import partition as pt

    rng = np.random.default_rng(len(case))
    nslots = {"widest": 16_383, "four float sums": 5000}.get(case, 10_001)
    ids = rng.integers(0, nslots + 1, 1 << 20)
    if case == "skew":
        ids[rng.random(ids.shape[0]) < 0.8] = 4321
    id_mod = 1 << nslots.bit_length()
    slab = pt.slab_partition(torch.from_numpy(ids.astype(np.int32)).to(cuda), [],
                             n_buckets=-(-(nslots + 1) // pt.WINDOW), id_mod=id_mod)[0]
    if case == "shuffled":
        slab = slab[torch.randperm(slab.shape[0], device=cuda)].contiguous()
    if case == "ragged":
        slab = slab[: slab.shape[0] - 1000 - 77]
    n_ops = pt.MAX_OPS if case == "widest" else 5
    ops, vals, masks = _value_streams(rng, slab.shape[0], n_ops, cuda)
    if case == "four float sums":
        ops, vals, masks = ("sum",) * 4 + ("count", "max"), [vals[0]] * 4 + [None, vals[0]], masks[:3] * 2
    before = pt.windowed_reduce.launches
    k = pt.windowed_reduce(slab, vals, masks, ops=ops, num_groups=nslots)
    assert pt.windowed_reduce.launches - before == (2 if case == "widest" else 1)
    p = pt.windowed_reduce_plain(slab, vals, masks, ops=ops, num_groups=nslots)
    torch.cuda.synchronize()
    _assert_tables(ops, k, p)
    for a, want in _chip_smoke().fixed_sums(slab, vals, masks, ops, nslots).items():
        assert torch.equal(k[a].view(torch.int64), want.view(torch.int64)), a


def _chip_smoke():
    """chip_smoke.py as a module: its K1 inputs and checks serve here too."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FIRST_LAUNCH_64KB = """
import numpy as np, torch
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
import chip_smoke
prog = chip_smoke.limits_program()
assert fs.tile_rows(prog.n_regs) * prog.n_regs * fs.THREADS * 8 > 48 * 1024
n = (1 << 16) + 3
ins = chip_smoke.limits_inputs(prog, n, torch.device("cuda"), np.random.default_rng(2))
chip_smoke.compare_k1(prog, ins, n, torch.device("cuda"))
assert fs.run_fused.launches == 1
print("ok")
"""


@pytest.mark.parametrize("case,n", [("sql", 1 << 20), ("sql", (1 << 20) - 777), ("sql", 100), ("all types", 1 << 20),
                                    ("all types", (1 << 20) + 5), ("limits", (1 << 20) - 3),
                                    ("first launch above 48 KB", None)])
def test_fused_stage_kernel_matches_plain(cuda, case, n):
    """K1 against its plain version, sel, validity and values bit for bit:
    a CASE / divide / CAST program, a program over every value type with
    its edges (NaN, +-inf, INT_MIN / -1, zero divisors), chip_smoke.limits_program()
    (64 instructions, 32 registers, 12 inputs and outputs: one row a
    thread, 64 KB of shared memory), row counts that end inside a tile and
    fill less than one; and in a fresh process whose first K1 launch holds
    64 KB of shared memory (the kernel's limit must be raised first)."""
    smoke = _chip_smoke()
    if case == "first launch above 48 KB":
        run = subprocess.run([sys.executable, "-c", FIRST_LAUNCH_64KB], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        assert run.returncode == 0 and run.stdout.strip().endswith("ok"), run.stdout + run.stderr
        return
    if case == "limits":
        prog = smoke.limits_program()
        ins = smoke.limits_inputs(prog, n, cuda, np.random.default_rng(9))
    else:
        ctx = port.ExecutionContext(device=cuda)
        if case == "sql":
            ctx.register_table("t", _table(n, 4, cuda))
            sql = ("SELECT CASE WHEN j > 0 THEN k / j ELSE -k END, lat * lng - nv, CAST(f AS DOUBLE) FROM t "
                   "WHERE lat > 40 AND (nv IS NULL OR nv < 7)")
        else:
            rng = np.random.default_rng(n)
            P = port.DataType
            schema = port.Schema([port.Field(c, P[t], c in ("nv", "j")) for c, t, _ in smoke.ALL_TYPES])
            ctx.register_table("t", port.Table.from_arrays(
                schema, [smoke.edge_column(rng, dt, n) for _, _, dt in smoke.ALL_TYPES],
                validity=[rng.random(n) > 0.2 if c in ("nv", "j") else None for c, _, _ in smoke.ALL_TYPES],
                device=cuda))
            sql = smoke.K1_ALL_TYPES
        prog, ins = smoke.fused_program(ctx, "t", sql)
    before = fs.run_fused.launches
    assert smoke.compare_k1(prog, ins, n, cuda) == 0.0
    assert fs.run_fused.launches - before == 1


@pytest.mark.parametrize("n", [1 << 20, (1 << 20) - 777])
def test_partition_kernels_match_plain(cuda, n):
    """K3's slabs equal the plain ones bit for bit (a ragged last block,
    80% of the rows on one gid, a mask bit in the gid); K4 over the
    kernel's slab: exact counts and MIN/MAX, f64 sums at rtol=1e-12."""
    from datafusion_tpu_torch.ops.pallas import partition as pt

    rng = np.random.default_rng(12)
    nslots = 16_001
    ids = rng.integers(0, nslots + 1, n)
    ids[rng.random(n) < 0.8] = 777
    b0 = nslots.bit_length()
    m = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    gid = torch.from_numpy(ids.astype(np.int32)).to(cuda) | (m.int() << b0)
    f = torch.from_numpy(rng.standard_normal(n)).to(cuda)
    f[::991] = float("nan")
    i = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32)).to(cuda)
    ks = pt.slab_partition(gid, [f, i], n_buckets=8, id_mod=1 << b0)
    ps = pt.slab_partition_plain(gid, [f, i], n_buckets=8, id_mod=1 << b0)
    torch.cuda.synchronize()
    for a, b in zip(ks, ps):
        bits = torch.int64 if a.element_size() == 8 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))
    pg = ks[0]
    gk = torch.where(pg >= pt.SENTINEL, pg, pg & ((1 << b0) - 1))
    mk = ((pg >> b0) & 1).bool()
    ops = ("count", "sum", "min", "max", "sum", "count")
    vals, masks = [None, ks[1], ks[1], ks[2], ks[2], None], [None, mk, mk, None, mk, mk]
    k = pt.windowed_reduce(gk, vals, masks, ops=ops, num_groups=nslots)
    p = pt.windowed_reduce_plain(gk, vals, masks, ops=ops, num_groups=nslots)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[1], p[1], rtol=1e-12, atol=1e-9, equal_nan=True)
    for a, b in zip(k[2:] + k[:1], p[2:] + p[:1]):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


def _regions(cuda, arrays, dst, sel, n_dev=8):
    """Shard j's `arrays[j]` laid out by destination, as the shuffle does."""
    from datafusion_tpu_torch.parallel import collectives as C
    from datafusion_tpu_torch.parallel import shuffle as sh

    routes = [sh.route(d, s, n_dev) for d, s in zip(dst, sel)]
    sizes = C.size_matrix([c for _, c in routes])
    split_cap, chunk = sh.region_capacity(sizes)
    sends = [sh.build_regions(a, rows, counts, n_dev, split_cap) for a, (rows, counts) in zip(arrays, routes)]
    return sends, sizes, split_cap, chunk


@pytest.mark.parametrize("layout", ["uniform", "skew", "empty", "batched"])
def test_ragged_exchange_kernel_matches_plain(cuda, layout):
    """K5's valid prefixes equal the plain version's bit for bit; 17
    arrays take two launches (16 a launch), every other call one. Each
    receiver's arrays are views of one buffer per array, and the wrapper
    makes no call that copies host memory to the device."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    rng = np.random.default_rng(13)
    n = 1 << 17
    dst, sel, arrays = [], [], []
    for j in range(8):
        d = rng.integers(0, 8, n)
        if layout == "skew":
            d[rng.random(n) < 0.8] = 3
        dst.append(torch.from_numpy(d).to(cuda))
        sel.append(torch.full((n,), not (layout == "empty" and j == 5), device=cuda))
        cols = [torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)).to(cuda),
                torch.from_numpy(rng.standard_normal(n)).to(cuda),
                torch.from_numpy(rng.integers(0, 255, n).astype(np.uint8)).to(cuda)]
        if layout == "batched":
            cols += [torch.from_numpy(rng.integers(-999, 999, n).astype(np.int16)).to(cuda),
                     torch.from_numpy(rng.integers(-2**40, 2**40, n)).to(cuda)]
            cols = (cols * 4)[:17]
        arrays.append(cols)
    sends, sizes, split_cap, chunk = _regions(cuda, arrays, dst, sel)
    before = rs.ragged_exchange.launches
    k = rs.ragged_exchange(sends, sizes, n_dev=8, split_cap=split_cap, chunk=chunk)
    assert rs.ragged_exchange.launches - before == (2 if layout == "batched" else 1)
    copies = _chip_smoke().host_copies(lambda: rs.ragged_exchange(sends, sizes, n_dev=8, split_cap=split_cap,
                                                                   chunk=chunk))
    assert not copies, copies
    p = rs.ragged_exchange_plain(sends, sizes, n_dev=8, split_cap=split_cap, chunk=chunk)
    torch.cuda.synchronize()
    sz = sizes.tolist()
    for a in range(len(arrays[0])):
        base = k[0][a]._base
        assert base is not None and base.numel() == 8 * 8 * split_cap
        assert all(k[i][a]._base is base and k[i][a].storage_offset() == i * 8 * split_cap for i in range(8))
    for i in range(8):
        for a in range(len(arrays[0])):
            for j in range(8):
                span = slice(j * split_cap, j * split_cap + sz[j][i])
                assert torch.equal(k[i][a][span], p[i][a][span]), (i, a, j)


@pytest.mark.parametrize("skew", [False, True])
def test_ragged_exchange_fold_kernel_matches_plain(cuda, skew):
    """K6: exact counts and MIN/MAX (two masks, NaN/+-inf), f64 sums at
    rtol=1e-12 against the plain version's row order and bit for bit
    against the plain fixed-point function."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    rng = np.random.default_rng(14)
    n, slots = 1 << 17, 10_001
    dst, sel, arrays = [], [], []
    for j in range(8):
        g = rng.integers(0, slots, n)
        if skew:
            g[rng.random(n) < 0.8] = 4321
        f = rng.standard_normal(n) * 100
        f[::997], f[5::1999], f[9::2003] = np.nan, np.inf, -np.inf
        dst.append(torch.from_numpy(g % 8).to(cuda))
        sel.append(torch.ones(n, dtype=torch.bool, device=cuda))
        arrays.append([torch.from_numpy((g // 8).astype(np.int32)).to(cuda), torch.from_numpy(f).to(cuda),
                       torch.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32)).to(cuda),
                       torch.from_numpy(rng.random(n) < 0.9).to(cuda), torch.from_numpy(rng.random(n) < 0.5).to(cuda)])
    sends, sizes, split_cap, _ = _regions(cuda, arrays, dst, sel)
    ops, mask_map = ("sum", "count", "min", "max", "count"), (1, 1, 2, 0, 0)
    args = ([s[0] for s in sends], [[s[1], None, s[1], s[2], None] for s in sends], [[s[3], s[4]] for s in sends],
            sizes)
    kw = dict(ops=ops, mask_map=mask_map, n_dev=8, split_cap=split_cap, num_groups=-(-slots // 8))
    k = rs.ragged_exchange_fold(*args, **kw)
    p = rs.ragged_exchange_fold_plain(*args, **kw)
    torch.cuda.synchronize()
    for ki, pi in zip(k, p):
        torch.testing.assert_close(ki[0], pi[0], rtol=1e-12, atol=1e-9, equal_nan=True)
        for a, b in zip(ki[1:], pi[1:]):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    want = _chip_smoke().k6_fixed_sums(args, kw)[0]
    assert torch.equal(torch.stack([ki[0] for ki in k]).view(torch.int64), want.view(torch.int64))


MESH_SQL = [
    "SELECT k, lat + lng FROM t WHERE lat > 51.0 AND lat < 53",
    "SELECT k, MIN(lat), MAX(lat), SUM(lng), COUNT(nv) FROM t GROUP BY k",
    "SELECT j, MIN(f), MAX(nv), COUNT(*) FROM t GROUP BY j ORDER BY j",
    "SELECT k, nv, lat FROM t ORDER BY nv NULLS FIRST, k, lat",
    "SELECT lat, k FROM t ORDER BY lat LIMIT 5000",
]


@pytest.mark.parametrize("sql", MESH_SQL)
def test_mesh_queries_match_the_cpu(cuda, sql):
    """A mesh of 8 shards on the card (K1, K2, K5, K6) against the same
    mesh on the CPU (plain versions)."""
    gpu = port.ExecutionContext(mesh=port.make_mesh(8))
    cpu = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    t = _table(20_000, 5, "cpu")
    gpu.register_table("t", t)
    cpu.register_table("t", t)
    a, b = gpu.sql(sql).result_str().splitlines(), cpu.sql(sql).result_str().splitlines()
    if "ORDER BY" not in sql:
        a, b = sorted(a), sorted(b)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra.split("\t"), rb.split("\t")):
            if x != y:
                assert "SUM" in sql and abs(float(x) - float(y)) <= 1e-12 * abs(float(y)), (x, y)


@pytest.fixture
def cards():
    """Up to four cards of this machine; skips below two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a mesh over several cards)")
    return tuple(torch.device("cuda", i) for i in range(min(torch.cuda.device_count(), 4)))


@pytest.mark.parametrize("sql", MESH_SQL)
def test_mesh_over_cards_matches_one_card(cards, sql):
    """The 8 shards over several cards (K5 / K6 reading peers' memory,
    every per-shard stage on its card) against the same 8 shards on one
    card: the same result_str, byte for byte, float sums included (one
    scale for the mesh's fold, merges in shard order)."""
    multi = port.ExecutionContext(mesh=port.make_mesh(8, devices=cards))
    one = port.ExecutionContext(mesh=port.make_mesh(8))
    t = _table(20_000, 5, "cpu")
    multi.register_table("t", t)
    one.register_table("t", t)
    assert multi.sql(sql).result_str() == one.sql(sql).result_str()


@pytest.mark.parametrize("name", ["j1", "j2"])
def test_join_queries_match_the_cpu(cuda, name):
    """chip_smoke.py's j1 (direct join, then K2 dense over the narrowed
    key) and j2 (sort join over repeated build keys, then K2 dense) at
    2^20 rows: the card against the CPU."""
    smoke = _chip_smoke()
    n = 1 << 20
    rng = np.random.default_rng(7)
    P = port.DataType
    big = port.Table.from_arrays(
        port.Schema([port.Field("k", P.Int32, False), port.Field("lat", P.Float64, False)]),
        [rng.integers(0, 65536, n).astype(np.int32), rng.random(n) * 10 + 48], device="cpu",
    )
    tables = smoke.join_tables(port, big, smoke.join_arrays(n), torch.device("cpu"))
    gpu, cpu = port.ExecutionContext(device=cuda), port.ExecutionContext(device="cpu")
    for t_name, t in tables.items():
        gpu.register_table(t_name, t)
        cpu.register_table(t_name, t)
    sql = {q[0]: q[1] for q in smoke.JOIN_QUERIES}[name]
    got = gpu.sql(sql)
    assert got.routes == cpu.sql(sql).routes
    a, b = got.result_str().splitlines(), cpu.sql(sql).result_str().splitlines()
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        for x, y in zip(ra.split("\t"), rb.split("\t")):
            if x != y:
                assert "SUM" in sql and abs(float(x) - float(y)) <= 1e-12 * abs(float(y)), (x, y)


@pytest.mark.parametrize("n_dev,slots,n_ops", [(8, 8 * 2048, 14), (1, 1251, 5), (8, 10_001, 5)])
def test_ragged_exchange_fold_edges_match_plain(cuda, n_dev, slots, n_ops):
    """K6 at 2048 slots per receiver with 14 ops, on a mesh of one shard,
    and 80% of the rows on one gid: one launch each, two for the 14 ops
    (their three float SUMs take three 2048-slot tables each), float SUMs
    bit-equal to the plain fixed-point function."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    rng = np.random.default_rng(15 + n_dev + n_ops)
    n = 1 << 17
    dst, sel, arrays = [], [], []
    for j in range(n_dev):
        g = rng.integers(0, slots, n)
        if slots == 10_001:
            g[rng.random(n) < 0.8] = 4321
        ops, vals, masks = _edge_streams(rng, n, n_ops, cuda)
        dst.append(torch.from_numpy(g % n_dev).to(cuda))
        sel.append(torch.ones(n, dtype=torch.bool, device=cuda))
        arrays.append([torch.from_numpy((g // n_dev).astype(np.int32)).to(cuda), vals[0], vals[2], masks[0], masks[2]])
    sends, sizes, split_cap, _ = _regions(cuda, arrays, dst, sel, n_dev)
    # each sender's regions: ids, the f64 and i64 values, the two masks
    args = ([s[0] for s in sends],
            [[None if op == "count" else s[2] if a % 3 == 2 else s[1] for a, op in enumerate(ops)] for s in sends],
            [[s[3], s[4]] for s in sends], sizes)
    kw = dict(ops=ops, mask_map=tuple((1, 0, 2)[a % 3] for a in range(n_ops)), n_dev=n_dev, split_cap=split_cap,
              num_groups=-(-slots // n_dev))
    before = rs.ragged_exchange_fold.launches
    k = rs.ragged_exchange_fold(*args, **kw)
    assert rs.ragged_exchange_fold.launches - before == (2 if n_ops == 14 else 1)
    p = rs.ragged_exchange_fold_plain(*args, **kw)
    torch.cuda.synchronize()
    for ki, pi in zip(k, p):
        _assert_tables(ops, ki, pi)
    for a, want in _chip_smoke().k6_fixed_sums(args, kw).items():
        assert torch.equal(torch.stack([ki[a] for ki in k]).view(torch.int64), want.view(torch.int64)), a


@pytest.mark.parametrize("name", ["w1", "w3"])
def test_window_queries_match_the_cpu(cuda, name):
    """chip_smoke.py's w1 (top 3 per partition: the spec sort) and w3
    (whole-partition AVG and MAX on K2 sorted) at 2^20 rows: the card
    against the CPU. w1 is exact; w3's SUM(lat - a) is 0 but for rounding,
    within 1e-6 (its terms sum in another order on the card)."""
    smoke = _chip_smoke()
    n = 1 << 20
    rng = np.random.default_rng(8)
    P = port.DataType
    big = port.Table.from_arrays(
        port.Schema([port.Field(c, t, False) for c, t in (("k", P.Int32), ("d", P.Int32), ("lat", P.Float64),
                                                           ("lng", P.Float64), ("g", P.Int32))]),
        [rng.integers(0, 65536, n).astype(np.int32), rng.integers(0, 1000, n).astype(np.int32),
         rng.random(n) * 10 + 48, rng.random(n) * 12 - 9, rng.integers(1, 10_001, n).astype(np.int32)],
        device="cpu",
    )
    gpu, cpu = port.ExecutionContext(device=cuda), port.ExecutionContext(device="cpu")
    gpu.register_table("big", big)
    cpu.register_table("big", big)
    sql = {q[0]: q[1] for q in smoke.WINDOW_QUERIES}[name]
    before = sr.segmented_reduce.sorted_launches
    a, b = gpu.sql(sql).result_str().splitlines(), cpu.sql(sql).result_str().splitlines()
    if name == "w3":
        assert sr.segmented_reduce.sorted_launches - before == 1
        (ca, sa, ma), (cb, sb, mb) = a[0].split("\t"), b[0].split("\t")
        assert ca == cb and ma == mb and abs(float(sa) - float(sb)) <= 1e-6, (a, b)
    else:
        assert a == b and len(a) == 3000


@pytest.mark.parametrize("name", ["a1", "a2", "a3"])
def test_aggregate_family_matches_the_cpu(cuda, name):
    """chip_smoke.py's a1 (dense STDDEV / VARIANCE: two K2 dense launches),
    a2 (MEDIAN and percentiles riding the co-sort: one K2 sorted launch)
    and a3 (COUNT / SUM / AVG(DISTINCT): one K2 sorted launch) at 2^20
    rows: the card against the CPU, keys and counts exact, floats within
    rel 1e-9 (sums in atomic order)."""
    smoke = _chip_smoke()
    n = 1 << 20
    rng = np.random.default_rng(9)
    P = port.DataType
    big = port.Table.from_arrays(
        port.Schema([port.Field(c, t, False) for c, t in (("k", P.Int32), ("d", P.Int32), ("lat", P.Float64),
                                                           ("lng", P.Float64), ("g", P.Int32))]),
        [rng.integers(0, 65536, n).astype(np.int32), rng.integers(0, 1000, n).astype(np.int32),
         rng.random(n) * 10 + 48, rng.random(n) * 12 - 9, rng.integers(1, 10_001, n).astype(np.int32)],
        device="cpu",
    )
    gpu, cpu = port.ExecutionContext(device=cuda), port.ExecutionContext(device="cpu")
    gpu.register_table("big", big)
    cpu.register_table("big", big)
    sql = {q[0]: q[1] for q in smoke.AGG_QUERIES}[name]
    sorted0, dense0 = sr.segmented_reduce.sorted_launches, sr.segmented_reduce.dense_launches
    a, b = gpu.sql(sql), cpu.sql(sql)
    made = (sr.segmented_reduce.sorted_launches - sorted0, sr.segmented_reduce.dense_launches - dense0)
    assert made == {"a1": (0, 2), "a2": (1, 0), "a3": (1, 0)}[name], made
    assert a.num_rows == b.num_rows
    for (ca, va), (cb, vb) in zip(a.cols, b.cols):
        assert (va is None) == (vb is None) and (va is None or np.array_equal(va, vb))
        if ca.dtype.kind == "f":
            assert np.allclose(ca, cb, rtol=1e-9, atol=0), name
        else:
            assert np.array_equal(ca, cb), name


@pytest.mark.parametrize("name", ["d1", "d2", "d2t", "edges"])
def test_dates_match_the_cpu(cuda, name):
    """chip_smoke.py's d1 (every EXTRACT field of a Date32 and a
    Timestamp), d2 / d2t (DATE_TRUNC of every unit, INTERVAL months and
    hours, CAST(ts AS DATE), a WHERE on dt + 1 MONTH) at 2^20 rows, each one
    K1 launch: the card against the CPU, exact; and its K1_DATES programs
    over the calendar's edges (INT_MIN / INT_MAX days, +-2^62 seconds) bit
    for bit against the plain version."""
    smoke = _chip_smoke()
    n = 1 << 20
    if name == "edges":
        ctx = port.ExecutionContext(device=cuda)
        ctx.register_table("t", smoke.date_edge_table(port, n, 21, cuda))
        for sql in smoke.K1_DATES:
            prog, ins = smoke.fused_program(ctx, "t", sql)
            assert smoke.compare_k1(prog, ins, n, cuda) == 0.0
        return
    rng = np.random.default_rng(10)
    P = port.DataType
    bigd = port.Table.from_arrays(
        port.Schema([port.Field("lat", P.Float64, False), port.Field("dt", P.Date32, False),
                     port.Field("ts", P.Timestamp, True)]),
        [rng.random(n), rng.integers(smoke.DAY_1900, smoke.DAY_2100, n).astype(np.int32),
         rng.integers(smoke.DAY_1900 * 86400, smoke.DAY_2100 * 86400, n)],
        validity=[None, None, rng.random(n) > 0.05], device="cpu")
    gpu, cpu = port.ExecutionContext(device=cuda), port.ExecutionContext(device="cpu")
    gpu.register_table("bigd", bigd)
    cpu.register_table("bigd", bigd)
    sql = {q[0]: q[1] for q in smoke.DATE_QUERIES}[name]
    before = fs.run_fused.launches
    got = gpu.sql(sql)
    assert fs.run_fused.launches - before == 1
    smoke.same_result(name, got, cpu.sql(sql), rtol=0.0)


@pytest.fixture(scope="module")
def tpch_contexts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import tpch

    gpu, cpu = port.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, cols in zip(("lineitem", "orders", "customer", "part"), tpch.gen_tables(0.05)):
        t = port.Table.from_pydict(cols, device="cpu")
        gpu.register_table(name, t)
        cpu.register_table(name, t)
    return tpch.QUERIES, gpu, cpu


@pytest.mark.parametrize("name", ["q1", "q2ish", "q3", "q4ish", "q5ish", "q6", "q7ish", "q8ish", "q9ish", "q10ish",
                                  "q11ish", "q12ish", "q13ish", "q14ish", "q15ish", "q16ish", "q17ish", "q18ish",
                                  "q19ish", "q20ish", "q21ish", "q22ish"])
def test_tpch_matches_the_cpu(tpch_contexts, name):
    """benchmarks/tpch.py's 22 shapes at scale 0.05 (300K lineitem rows):
    the card against the CPU, row count and order, strings, integers and
    dates exact, floats at rtol 1e-9 (the card's sums are in fixed point
    or span order, the CPU's in row order). q15ish compares its revenue
    view with that view's own MAX, two evaluations of one float SUM: it
    holds only because the card gives the same bits in every run."""
    queries, gpu, cpu = tpch_contexts
    _chip_smoke().same_result(name, gpu.sql(queries[name]), cpu.sql(queries[name]))


def test_to_host_reads_through_pinned_memory(cuda):
    """`to_host` on the card: the arrays are views of pinned host tensors
    and equal a mask index and `.cpu()` bit for bit."""
    from datafusion_tpu_torch.parallel.multihost import to_host

    rng = np.random.default_rng(12)
    n = 1 << 20
    xs = [torch.from_numpy(rng.normal(size=n)).to(cuda), torch.from_numpy(rng.random(n) > 0.1).to(cuda),
          torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).to(cuda)]
    sel = torch.from_numpy(rng.random(n) > 0.4).to(cuda)
    got = to_host(xs, sel)
    for g, x in zip(got, xs):
        assert isinstance(g.base, torch.Tensor) and g.base.is_pinned()
        want = x[sel].cpu().numpy()
        assert g.dtype == want.dtype and g.view(np.uint8).tobytes() == want.view(np.uint8).tobytes()


def test_time_pipeline_times_the_card_with_events(cuda, monkeypatch):
    """A pipeline whose output lies on the card is timed by CUDA events."""
    from datafusion_tpu_torch.utils import benchtime

    made = []
    real = torch.cuda.Event

    def event(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", event)
    x = torch.ones(1 << 22, device=cuda)
    t = benchtime.time_pipeline(lambda e: e * 2.0, x, depths=(4,), trials=2)
    assert t > 0 and made
    assert benchtime.time_queued(lambda e: e * 2.0, x, reps=5) > 0
