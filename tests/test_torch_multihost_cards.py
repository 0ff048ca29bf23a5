"""The port over two processes of two logical cards each: one mesh of
2 x 4 CPU shards, two shards a card, joined by torch.distributed over
Gloo (parallel/multihost.py `global_mesh(4, devices=...)`).

The file is its own worker: `python tests/test_torch_multihost_cards.py
PORT RANK WORLD OUTDIR` joins the group and runs everything twice, over
`global_mesh(4, device="cpu", devices=("cpu", "cpu"))` (each process's
shards placed on its two logical cards) and over `global_mesh(4,
device="cpu")` (one card a process): every query of
tests/test_torch_multihost.py's QUERIES and of EXTRA (UNION, the
repartition aggregate, the gather to replicated) over that file's data,
then tests/test_torch_insert.py's INSERT scenarios and a CTAS / INSERT /
DROP scenario, each statement in a context of its own tables. It writes
each result (`result_str`, rows, `routes`, EXPLAIN VERBOSE's physical
lines) to OUTDIR/rank<RANK>.json. The parent test holds every result of
the two-card layout to the JAX package's single-device result (byte for
byte; floats of FLOAT_QUERIES to rtol 1e-9, as there), to the port on one
device and to the same ranks with one card each, and both ranks' routes
and EXPLAIN to each other; every INSERT scenario's statements on both
layouts to the JAX package's single-device INSERT and to the port's.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # as a worker, too: this file's tests and the packages
from test_torch_multihost import (  # noqa: E402
    FLOAT_QUERIES,
    N_LOCAL,
    NPROC,
    QUERIES,
    ROUTES,
    _free_port,
    _same_rows,
    register_shard_csvs,
    shard_rows,
    tables,
)

EXTRA = {  # the distributed operators QUERIES does not reach
    "union": "SELECT tag, k FROM s WHERE k < 3 UNION ALL SELECT tag, w FROM d ORDER BY tag, k",
    "repartition_aggregate": "SELECT k, COUNT(DISTINCT tag), MEDIAN(v) FROM t GROUP BY k ORDER BY k",
    "gather_window": "SELECT k, v, RANK() OVER (ORDER BY v) FROM t WHERE k < 4 ORDER BY v",
}
ALL = {**QUERIES, **EXTRA}
ALL_ROUTES = {
    **ROUTES,
    "sort_limit": "per-shard top-k",
    "repartition_aggregate": "aggregate: hash-repartition by group keys over K5",
    "gather_window": "window: gather to replicated",
}
LAYOUTS = {"cards": ("cpu", "cpu"), "one": None}  # two logical cards a process, one card a process
DML = {  # CTAS, INSERT into the new table and DROP on the spanning mesh
    "ctas_drop": [
        "CREATE TABLE c AS SELECT k, v, tag FROM t WHERE k < 5",
        "INSERT INTO c SELECT k, v * 2, tag FROM t WHERE k > 37",
        "SELECT tag, COUNT(k), SUM(k), MIN(v), MAX(v) FROM c GROUP BY tag ORDER BY tag",
        "SELECT k, v FROM c ORDER BY v LIMIT 7",
        "DROP TABLE c",
        "SHOW TABLES",
    ],
}


def insert_scenarios() -> dict:
    """tests/test_torch_insert.py's scenarios, then DML."""
    from test_torch_insert import SCENARIOS

    return {**SCENARIOS, **DML}


def _register(ctx, mod, device=None):
    """The tables of one scenario: test_torch_insert.py's and
    test_torch_multihost.py's `t`, registered whole."""
    from test_torch_insert import _tables

    kw = {} if device is None else {"device": device}
    for name, t in _tables(mod, device).items():
        ctx.register_table(name, t)
    ctx.register_table("t", mod.Table.from_pydict(dict(tables()["t"]), **kw))


def _result(res, explain: str) -> dict:
    rows = [[x.item() if isinstance(x, np.generic) else x for x in r.values()] for r in res.to_pylist()]
    return {"result": res.result_str(), "rows": rows, "routes": list(res.routes),
            "explain": [ln for ln in explain.splitlines() if ln.startswith("physical: ")]}


def _run_layout(dft, devices, outdir: str, rank: int) -> dict:
    from datafusion_tpu_torch.parallel.mesh import RankTable, ShardTable

    mesh = dft.global_mesh(N_LOCAL, device="cpu", devices=devices)
    ctx = dft.ExecutionContext(mesh=mesh)
    for name, cols in tables().items():
        ctx.register_table(name, dft.Table.from_pydict(dict(cols), device="cpu"))
    register_shard_csvs(dft, ctx, outdir, rank)
    t = ctx.table("t")
    out = {"cards": [str(d) for d in mesh.devices], "first": mesh.first,
           "table": type(t).__name__,
           "shard_rows": [s.num_rows for s in t.shards] if isinstance(t, ShardTable) else list(t.shard_rows),
           "rank_table": isinstance(t, RankTable), "s_vocab": list(ctx.table("s").columns[0].dictionary),
           "queries": {}, "dml": {}}
    for name, q in ALL.items():
        out["queries"][name] = _result(ctx.sql(q), ctx.sql(f"EXPLAIN VERBOSE {q}").result_str())
    for scenario, stmts in insert_scenarios().items():
        sctx = dft.ExecutionContext(mesh=mesh)
        _register(sctx, dft, "cpu")
        out["dml"][scenario] = [sctx.sql(sql).result_str() for sql in stmts]
        out["dml"][scenario + ":types"] = sorted({type(v).__name__ for v in sctx._tables.values()})
    return out


def _worker(port: str, rank: int, world: int, outdir: str) -> None:
    import datafusion_tpu_torch as dft

    assert dft.initialize_multihost(f"127.0.0.1:{port}", world, rank) == "gloo"
    out = {layout: _run_layout(dft, devices, outdir, rank) for layout, devices in LAYOUTS.items()}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def _references():
    """(JAX package on one device, port on one CPU device) over the whole
    tables and the concatenated CSV shards, and each one's statements of
    every INSERT scenario, each scenario in contexts of its own."""
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
    queries = {name: (jax_ctx.sql(q), port_ctx.sql(q)) for name, q in ALL.items()}
    dml = {}
    for scenario, stmts in insert_scenarios().items():
        r, p = ref.ExecutionContext(), dft.ExecutionContext(device="cpu")
        _register(r, ref)
        _register(p, dft, "cpu")
        dml[scenario] = [(r.sql(sql).result_str(), p.sql(sql).result_str()) for sql in stmts]
    return queries, dml, sorted(set(s["tag"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results and the references. The two worker processes
    run while this process computes the references; each is given 120 s,
    and a rank that fails or times out fails every test of the file."""
    outdir = tmp_path_factory.mktemp("multihost_cards")
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, __file__, port, str(r), str(NPROC), str(outdir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(NPROC)]
    logs = []
    try:
        refs = _references()
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in range(NPROC)], refs


@pytest.mark.parametrize("name", list(ALL))
def test_two_cards_a_rank_match_one_device(run, name):
    """Every distributed operator over two ranks of two logical cards each
    equals the JAX package on one device, the port on one device and the
    same ranks with one card each; routes and EXPLAIN are equal on both
    ranks and on both layouts."""
    ranks, (queries, _, _) = run
    want_jax, want_port = queries[name]
    for r, got in enumerate(ranks):
        g, one = got["cards"]["queries"][name], got["one"]["queries"][name]
        if name in FLOAT_QUERIES:
            _same_rows(g["rows"], [list(x.values()) for x in want_jax.to_pylist()], f"{name} rank {r} vs JAX")
            _same_rows(g["rows"], [list(x.values()) for x in want_port.to_pylist()], f"{name} rank {r} vs port")
        else:
            assert g["result"] == want_jax.result_str(), f"{name}: rank {r} differs from the JAX package"
            assert g["result"] == want_port.result_str(), f"{name}: rank {r} differs from the port on one device"
        assert g["result"] == one["result"], f"{name}: rank {r}'s two cards differ from its one card"
        assert g["routes"] == one["routes"] and g["explain"] == one["explain"], name
    for layout in LAYOUTS:
        a, b = (got[layout]["queries"][name] for got in ranks)
        assert a["result"] == b["result"] and a["routes"] == b["routes"] and a["explain"] == b["explain"], layout
    if name in ALL_ROUTES:
        lines = ranks[0]["cards"]["queries"][name]["explain"]
        assert any(ALL_ROUTES[name] in ln for ln in lines), lines


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scenario", list(insert_scenarios()))
def test_insert_on_a_spanning_mesh(run, scenario, layout):
    """INSERT (and CTAS, DROP) on a mesh of two processes: after each
    statement a query over the table equals the JAX package's and the
    port's single-device INSERT, on both ranks; the rebuilt tables keep
    each process's blocks (RankTable, or ShardTable on two cards)."""
    ranks, (_, dml, _) = run
    for r, got in enumerate(ranks):
        for sql, g, (want_jax, want_port) in zip(insert_scenarios()[scenario], got[layout]["dml"][scenario],
                                                 dml[scenario]):
            assert g == want_jax, f"{sql}: rank {r} ({layout}) differs from the JAX package"
            assert g == want_port, f"{sql}: rank {r} ({layout}) differs from the port on one device"
        kinds = got[layout]["dml"][scenario + ":types"]
        assert kinds == (["ShardTable"] if layout == "cards" else ["RankTable"]), kinds


def test_layout_places_each_rank_blocks_on_its_cards(run):
    """register_table keeps this rank's row blocks, placed on its two
    cards (a ShardTable of 4 shards), or one card's RankTable; the CSV
    shards' disjoint vocabularies merge into one on every rank."""
    ranks, (_, _, vocab) = run
    rows = len(tables()["t"]["k"])
    per = -(-rows // (NPROC * N_LOCAL))
    for r, got in enumerate(ranks):
        cards, one = got["cards"], got["one"]
        assert cards["table"] == "ShardTable" and one["rank_table"], r
        assert cards["first"] == one["first"] == r * N_LOCAL
        want = [min(per, rows - (r * N_LOCAL + d) * per) for d in range(N_LOCAL)]
        assert cards["shard_rows"] == one["shard_rows"] == want, r
        assert cards["s_vocab"] == one["s_vocab"] == vocab, r


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
