"""The port over two processes: one mesh of 2 x 4 CPU shards, joined by
torch.distributed over Gloo (parallel/multihost.py).

The file is its own worker: `python tests/test_torch_multihost.py PORT
RANK WORLD OUTDIR` joins the group, runs every query of QUERIES in
`ExecutionContext(mesh=global_mesh(4, device="cpu"))`, and writes each
result (`result_str`, rows, `routes`, EXPLAIN VERBOSE's physical lines)
to OUTDIR/rank<RANK>.json. The data are those of tests/multiproc_driver.py,
the JAX package's two-process driver: the same table `t` on every process
(each keeps its shards' row blocks), its build table `b`, and per-process
CSV files with disjoint Utf8 vocabularies read by `register_csv_shards`;
plus a wider table `t2` for the shuffle joins, `b2` with keys `t` lacks
for a broadcast FULL join, and a key domain past K2 dense's for the fold. The parent test holds each result to the JAX
package's single-device result on the same data, byte for byte (floats
of FLOAT_QUERIES to rtol 1e-9: the mesh adds in another order), and to
the port on one device, and both ranks' routes and EXPLAIN to each other.
"""

import csv
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

NPROC, N_LOCAL, ROWS, SHARD_ROWS = 2, 4, 8192, 600


def tables():
    """{name: columns} of the tables every process registers whole, from
    tests/multiproc_driver.py's seed; t2 and g come from a second seed."""
    rng = np.random.default_rng(7)
    t = {
        "k": rng.integers(0, 40, ROWS).astype(np.int64),
        "v": rng.normal(size=ROWS),
        "tag": np.array(["ab", "cd", "ef", "gh"], dtype=object)[rng.integers(0, 4, ROWS)],
    }
    b = {"k": np.arange(40, dtype=np.int64), "w": rng.normal(size=40)}
    rng3 = np.random.default_rng(13)
    t["g"] = rng3.integers(0, 5000, ROWS).astype(np.int32)
    t2 = {"k": rng3.integers(0, 4000, 4096).astype(np.int64), "w": rng3.integers(0, 1000, 4096).astype(np.int32)}
    b2 = {"k": np.arange(30, 70, dtype=np.int64), "w": rng3.integers(0, 100, 40).astype(np.int32)}
    return {"t": t, "b": b, "t2": t2, "b2": b2}


def shard_rows():
    """Each process's CSV rows (tag, k, v) and dim rows (tag, w), as the
    JAX driver makes them: tags host<p>_<i>, disjoint between processes."""
    rng2 = np.random.default_rng(11)
    shards = []
    for p in range(NPROC):
        tags = [f"host{p}_{int(i)}" for i in rng2.integers(0, 7, SHARD_ROWS)]
        ks = rng2.integers(0, 25, SHARD_ROWS).astype(np.int64)
        vs = np.round(rng2.normal(size=SHARD_ROWS), 6)
        shards.append((tags, ks, vs))
    dims = [([f"host{p}_{i}" for i in range(7)], [p * 100 + i for i in range(7)]) for p in range(NPROC)]
    return shards, dims


QUERIES = {  # the JAX driver's queries, then the exchanges of this slice
    "scan": "SELECT k, v FROM t WHERE v > 1.5 AND k < 10",
    "group": "SELECT k, COUNT(k), MIN(v), MAX(v) FROM t GROUP BY k ORDER BY k",
    "group_utf8": "SELECT tag, COUNT(tag) FROM t GROUP BY tag ORDER BY tag",
    "ungrouped": "SELECT COUNT(k), MIN(v), MAX(v) FROM t",
    "broadcast_join": "SELECT t.k, COUNT(w) FROM t JOIN b ON t.k = b.k GROUP BY t.k ORDER BY 1",
    "sort_limit": "SELECT k, v FROM t ORDER BY v DESC LIMIT 5",
    "float_sums": "SELECT k, SUM(v), AVG(v) FROM t GROUP BY k ORDER BY k",
    "shard_group": "SELECT tag, COUNT(v) FROM s GROUP BY tag ORDER BY tag",
    "shard_sort": "SELECT tag, k FROM s ORDER BY tag, k, v LIMIT 20",
    "shard_minmax": "SELECT MIN(tag), MAX(tag) FROM s",
    "shard_literal": "SELECT COUNT(tag) FROM s WHERE tag = 'host1_3'",
    "shard_join": "SELECT s.tag, w, COUNT(v) FROM s JOIN d ON s.tag = d.tag GROUP BY s.tag, w ORDER BY 1",
    "sample_sort": "SELECT k, v, tag FROM t WHERE k < 6 ORDER BY k, v",
    "shuffle_join": "SELECT t.k, t2.w, t.v FROM t JOIN t2 ON t.k = t2.k ORDER BY t.k, t2.w, t.v",
    "window": "SELECT k, v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) FROM t WHERE k < 8 ORDER BY k, v",
    "fold": "SELECT g, SUM(v), COUNT(v), MIN(v), MAX(k) FROM t GROUP BY g ORDER BY g",
    "full_broadcast": "SELECT t.k, b2.w FROM t FULL JOIN b2 ON t.k = b2.k ORDER BY t.k, b2.w",
    "full_shuffle": "SELECT t.k, t2.w FROM t FULL JOIN t2 ON t.k = t2.k ORDER BY t.k, t2.w",
}
FLOAT_QUERIES = {"float_sums", "fold"}
ROUTES = {  # a physical line each query's EXPLAIN VERBOSE must hold on both ranks
    "sample_sort": "multi-key sample sort",
    "shuffle_join": "join: shuffle",
    "window": "window: hash-repartition by PARTITION BY keys over K5",
    "fold": "fused ragged-exchange fold, K6",
    "full_broadcast": "join: broadcast",
    "full_shuffle": "join: shuffle",
    "group": "dense sort-free group-by per shard",
    "float_sums": "dense sort-free group-by per shard",
}


def repartition_inputs(shard: int):
    """(destinations, selection) of global shard `shard`'s rows for a
    repartition that moves no arrays, only selections."""
    import torch

    rng = np.random.default_rng(100 + shard)
    n = 100 + 17 * shard
    return (torch.from_numpy(rng.integers(0, NPROC * N_LOCAL, n).astype(np.int64)),
            torch.from_numpy(rng.random(n) > 0.25))


def repartition_counts(mesh, shards) -> list[list[int]]:
    """Each of `shards`' receivers' live rows per sender region after a
    repartition with no columns over `mesh`."""
    from datafusion_tpu_torch.parallel.shuffle import repartition

    inputs = [repartition_inputs(g) for g in shards]
    recv, sels = repartition([[] for _ in shards], [d for d, _ in inputs], [s for _, s in inputs], mesh.n_dev,
                             mesh=mesh)
    assert recv == [[] for _ in shards]
    return [s.reshape(mesh.n_dev, -1).sum(1).tolist() for s in sels]


def register_shard_csvs(dft, ctx, outdir: str, rank: int) -> None:
    """Write this rank's CSV files (`shard_rows`) into `outdir` and
    register them as the tables `s` and `d` (register_csv_shards)."""
    shards, dims = shard_rows()
    paths = [os.path.join(outdir, f"s{rank}.csv"), os.path.join(outdir, f"d{rank}.csv")]
    for path, rows in zip(paths, (zip(*shards[rank]), zip(*dims[rank]))):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows((r[0], *[float(x) if isinstance(x, float) else int(x) for x in r[1:]])
                                    for r in rows)
    D = dft.DataType
    dft.register_csv_shards(ctx, "s", paths[0], dft.Schema([dft.Field("tag", D.Utf8, False),
                                                            dft.Field("k", D.Int64, False),
                                                            dft.Field("v", D.Float64, False)]), has_header=False)
    dft.register_csv_shards(ctx, "d", paths[1], dft.Schema([dft.Field("tag", D.Utf8, False),
                                                            dft.Field("w", D.Int64, False)]), has_header=False)


def _worker(port: str, rank: int, world: int, outdir: str) -> None:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import datafusion_tpu_torch as dft

    backend = dft.initialize_multihost(f"127.0.0.1:{port}", world, rank)
    assert backend == "gloo"
    mesh = dft.global_mesh(N_LOCAL, device="cpu")
    assert (mesh.n_dev, mesh.rank, mesh.world) == (N_LOCAL * world, rank, world)
    ctx = dft.ExecutionContext(mesh=mesh)
    for name, cols in tables().items():
        ctx.register_table(name, dft.Table.from_pydict(dict(cols), device="cpu"))
        assert ctx.table(name).local_rows < len(next(iter(cols.values())))  # only this rank's blocks
    register_shard_csvs(dft, ctx, outdir, rank)
    from datafusion_tpu_torch.parallel import collectives as C
    from datafusion_tpu_torch.parallel.mesh import partition_table

    try:
        partition_table(dft.Table.from_pydict(dict(tables()["b"]), device="cpu"), mesh)
        whole_refused = False
    except ValueError:
        whole_refused = True
    out = {"empty_repartition": repartition_counts(mesh, range(mesh.first, mesh.first + N_LOCAL)),
           "whole_table_refused": whole_refused}
    for name, q in QUERIES.items():
        res = ctx.sql(q)
        explain = ctx.sql(f"EXPLAIN VERBOSE {q}").result_str()
        rows = [[x.item() if isinstance(x, np.generic) else x for x in r.values()] for r in res.to_pylist()]
        out[name] = {"result": res.result_str(), "rows": rows,
                     "routes": list(res.routes),
                     "explain": [ln for ln in explain.splitlines() if ln.startswith("physical: ")]}
    out["transport"] = {"bytes": C.transport.bytes, "live_bytes": C.transport.live_bytes}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: two worker processes, each given 90 s; a rank
    that fails or times out fails every test of the file."""
    outdir = tmp_path_factory.mktemp("multihost")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, __file__, port, str(r), str(NPROC), str(outdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(NPROC)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(NPROC)]


@pytest.fixture(scope="module")
def references():
    """(JAX package on one device, port on one CPU device), each over the
    whole tables and the concatenated CSV shards."""
    import datafusion_tpu as ref
    import datafusion_tpu_torch as dft

    shards, dims = shard_rows()
    s = {"tag": np.array(sum([list(x[0]) for x in shards], []), dtype=object),
         "k": np.concatenate([x[1] for x in shards]), "v": np.concatenate([x[2] for x in shards])}
    d = {"tag": np.array(sum([x[0] for x in dims], []), dtype=object),
         "w": np.array(sum([x[1] for x in dims], []), dtype=np.int64)}
    jax_ctx, port_ctx = ref.ExecutionContext(), dft.ExecutionContext(device="cpu")
    for name, cols in {**tables(), "s": s, "d": d}.items():
        jax_ctx.register_table(name, ref.Table.from_pydict(dict(cols)))
        port_ctx.register_table(name, dft.Table.from_pydict(dict(cols), device="cpu"))
    return jax_ctx, port_ctx


def _same_rows(got, want, name):
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert [x for x in g if not isinstance(x, float)] == [x for x in w if not isinstance(x, float)], name
        np.testing.assert_allclose([x for x in g if isinstance(x, float)], [x for x in w if isinstance(x, float)],
                                   rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("name", list(QUERIES))
def test_two_ranks_match_one_device(ranks, references, name):
    jax_ctx, port_ctx = references
    want_jax, want_port = jax_ctx.sql(QUERIES[name]), port_ctx.sql(QUERIES[name])
    for r, got in enumerate(ranks):
        g = got[name]
        if name in FLOAT_QUERIES:
            _same_rows(g["rows"], [list(x.values()) for x in want_jax.to_pylist()], f"{name} rank {r} vs JAX")
            _same_rows(g["rows"], [list(x.values()) for x in want_port.to_pylist()], f"{name} rank {r} vs port")
        else:
            assert g["result"] == want_jax.result_str(), f"{name}: rank {r} differs from the JAX package"
            assert g["result"] == want_port.result_str(), f"{name}: rank {r} differs from the port on one device"
    assert ranks[0][name]["result"] == ranks[1][name]["result"]
    assert ranks[0][name]["routes"] == ranks[1][name]["routes"]
    assert ranks[0][name]["explain"] == ranks[1][name]["explain"]
    if name in ROUTES:
        assert any(ROUTES[name] in ln for ln in ranks[0][name]["explain"]), ranks[0][name]["explain"]


def test_two_ranks_repartition_without_arrays(ranks):
    """A repartition that moves only selections gives each rank's
    receivers what the same shards receive on one process."""
    import datafusion_tpu_torch as dft

    want = repartition_counts(dft.make_mesh(NPROC * N_LOCAL, device="cpu"), range(NPROC * N_LOCAL))
    for r, got in enumerate(ranks):
        assert got["empty_repartition"] == want[r * N_LOCAL:(r + 1) * N_LOCAL], f"rank {r}"


def test_two_ranks_partition_only_rank_tables(ranks):
    """A whole table reaches a spanning mesh's shards only through
    register_table, which keeps this rank's blocks."""
    assert all(got["whole_table_refused"] for got in ranks)


def test_two_ranks_count_live_bytes(ranks):
    """Of the bytes each rank sent the other, those that carry rows are a
    part: the exchanges pad every region to the largest pair's count."""
    for r, got in enumerate(ranks):
        t = got["transport"]
        assert 0 < t["live_bytes"] < t["bytes"], f"rank {r}: {t}"


def test_merge_string_dictionaries_one_process():
    from datafusion_tpu_torch.parallel.multihost import merge_string_dictionaries

    vocab, remap = merge_string_dictionaries(["a", "b", "zz"])
    assert vocab == ("a", "b", "zz")
    assert remap.dtype == np.int32 and remap.tolist() == [0, 1, 2]


def _bits(a):
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


def test_to_host_equals_cpu_bit_for_bit():
    """Selected rows of f64 (NaN payloads, -0.0, +-inf), int64 edges,
    bool validity and Utf8 codes, against a mask index and `.cpu()`."""
    import torch

    from datafusion_tpu_torch.parallel.multihost import to_host

    rng = np.random.default_rng(3)
    n = 1000
    f = rng.normal(size=n)
    f[:6] = [np.nan, -0.0, np.inf, -np.inf, 0.0, np.nan]
    fb = f.view(np.uint64)
    fb[5] |= 0x7FF8_0000_0000_0123  # a NaN with a payload
    xs = [torch.from_numpy(f), torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
          torch.from_numpy(rng.random(n) > 0.3), None, torch.from_numpy(rng.integers(0, 7, n).astype(np.int32))]
    sel = torch.from_numpy(rng.random(n) > 0.5)
    got = to_host(xs, sel)
    assert got[3] is None
    for g, x in zip(got, xs):
        if x is not None:
            assert _bits(g) == _bits(x[sel].cpu().numpy())
    assert _bits(to_host(xs[0])) == _bits(xs[0].cpu().numpy())


def test_result_columns_through_to_host():
    """A query's materialization (`CompiledQuery.host_columns`) equals the
    per-column mask and `.cpu()` of its device result, NULLs and Utf8
    included."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.exec.compiler import compile_plan
    from datafusion_tpu_torch.ops.expr_eval import broadcast_col
    from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection

    ctx = dft.ExecutionContext(device="cpu")
    ctx.register_table("t", dft.Table.from_pydict({"k": np.arange(50, dtype=np.int64) % 7,
                                                   "s": [None if i % 5 == 0 else f"w{i % 3}" for i in range(50)],
                                                   "v": [None if i % 4 == 0 else i * 0.5 for i in range(50)]},
                                                  device="cpu"))
    q = "SELECT k, s, v, v / k FROM t WHERE k > 1"
    cq = compile_plan(push_down_projection(push_down_filters(ctx.plan(q))), {"t": ctx.table("t")}, device="cpu")
    out = cq.device_result()
    got = cq.host_columns(out)
    for (gd, gv), c in zip(got, out.cols):
        d, v = broadcast_col(c, out.capacity)
        assert _bits(gd) == _bits(d[out.sel].cpu().numpy())
        assert (gv is None) == (v is None) and (v is None or np.array_equal(gv, v[out.sel].cpu().numpy()))
    res = ctx.sql(q)
    assert [_bits(d) for d, _ in res.cols] == [_bits(d) for d, _ in got]


def test_full_broadcast_join_under_a_sort_on_one_process():
    """A broadcast FULL join's shards hold the same columns (its tail's
    NULL probe columns gave only the last shard a validity, and the
    sample sort above it then sent different arrays per shard)."""
    import datafusion_tpu_torch as dft

    cols = tables()
    q = QUERIES["full_broadcast"]
    got = []
    for mesh in (None, dft.make_mesh(8, device="cpu")):
        ctx = dft.ExecutionContext(device="cpu") if mesh is None else dft.ExecutionContext(mesh=mesh)
        for name in ("t", "b2"):
            ctx.register_table(name, dft.Table.from_pydict(dict(cols[name]), device="cpu"))
        got.append(ctx.sql(q).result_str())
    assert got[0] == got[1]


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
