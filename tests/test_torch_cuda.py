"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and skips without one; on the
card run them with `python -m pytest tests/test_torch_cuda.py -q`. The
file imports neither jax nor the JAX package (the card's machine has
no JAX)."""

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as port
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.ops.pallas import segreduce as sr


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
    versions): exact except float sums (atomic order), at rtol=1e-12."""
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


def test_fused_stage_kernel_matches_plain(cuda):
    t = _table(1 << 20, 4, cuda)
    ctx = port.ExecutionContext(device=cuda)
    ctx.register_table("t", t)
    plan = ctx.plan("SELECT CASE WHEN j > 0 THEN k / j ELSE -k END, lat * lng - nv, CAST(f AS DOUBLE) FROM t "
                    "WHERE lat > 40 AND (nv IS NULL OR nv < 7)")
    sel_node = plan.input
    cols = [(c.data, c.validity) for c in t.columns]
    prog = fs.compile_program(sel_node.input.schema, [None] * 6, [c.validity is not None for c in t.columns],
                              sel_node.expr, list(plan.exprs))
    ins = ([cols[i][0] for i in prog.inputs], [cols[i][1] for i in prog.inputs])
    ks, ko = fs.run_fused(prog, *ins, t.num_rows, cuda)
    ps, po = fs.evaluate_plain(prog, *ins, t.num_rows)
    torch.cuda.synchronize()
    assert torch.equal(ks, ps)
    for (kd, kv), (pd, pv) in zip(ko, po):
        assert (kv is None) == (pv is None)
        valid = torch.ones_like(ks) if kv is None else kv
        assert kv is None or torch.equal(kv, pv)
        assert torch.equal(kd[valid], pd[valid])


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
