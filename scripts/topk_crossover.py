"""Where ORDER BY ... LIMIT k stops gaining from the per-shard top-k over
the sample sort, on a benchmark cell's tables.

    python3 scripts/topk_crossover.py --workload cities_2e27_mesh4.exchange --seed 7 \
        [--ks 4096,16384,65536,262144,1048576] [--reps 5] [--out chiprun_out/topk_crossover.jsonl]

Makes the cell's tables and session as `portbench/run.py` does. First,
for each ORDER BY ... LIMIT template of the cell's mix: its EXPLAIN
VERBOSE sort lines, and per query the top-k selections run and the
candidate rows they kept (`PlanCompiler._topk_over`) and the K5
launches. Then, for each k of `--ks`, one key (`ORDER BY lat`) and three
(`ORDER BY k, d, lat`), both routes of the same SQL, each in a session of
its own: the top-k, and the sort's stage with the global LIMIT, each
chosen by replacing the ceiling (`topk_fits`) of this process for that
session's lowering. Every query is run once to warm, then `--reps`
times, in turns (top-k, sort, sort, top-k, ...); the host clock around
`ExecutionContext.sql`, which ends in a synchronize. The two routes'
rows are compared column by column. Prints one JSON line a measurement,
with the card's name and power limit. `--device cpu` runs a tiny-scale
check on the CPU (the configuration's rows cut to 50,000, k cut to fit)."""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from portbench.core import harness, traffic  # noqa: E402

QUERIES = {
    "one_key": "SELECT lat, g FROM cities ORDER BY lat LIMIT {k}",
    "three_keys": "SELECT k, d, lat FROM cities ORDER BY k, d, lat LIMIT {k}",
}


def card_name(devices) -> str:
    if devices[0].type != "cuda":
        return "cpu"
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return " | ".join(q.stdout.strip().splitlines())


def counters() -> dict:
    from datafusion_tpu_torch.exec.compiler import PlanCompiler
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    f = PlanCompiler._topk_over
    return {"topk_over.calls": f.calls, "topk_over.candidates": f.candidates,
            "k5_launches": rs.ragged_exchange.launches}


def set_ceiling(fits) -> None:
    """`fits` in place of the ceiling (`topk_fits`) of this process, for
    the lowerings that follow."""
    from datafusion_tpu_torch.exec import compiler
    from datafusion_tpu_torch.parallel import dist

    compiler.topk_fits = dist.topk_fits = fits


def same_rows(a, b) -> bool:
    if a.num_rows != b.num_rows or a.num_columns != b.num_columns:
        return False
    for (da, va), (db, vb) in zip(a.cols, b.cols):
        if not np.array_equal(da, db, equal_nan=da.dtype.kind == "f"):
            return False
        if (va is None) != (vb is None) or (va is not None and not np.array_equal(va, vb)):
            return False
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ks", default="4096,16384,65536,262144,1048576")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="one device for every card (cpu: a tiny-scale check)")
    args = ap.parse_args()

    cell = harness.Cell(REPO, args.workload)
    devices = cell.devices(args.device)
    if devices is None:
        sys.exit(2)
    ks = [int(x) for x in args.ks.split(",")]
    if devices[0].type == "cpu":
        cell.cfg["rows"] = {t: min(r, 50000) for t, r in cell.cfg["rows"].items()}
        ks = [k // 256 for k in ks]
    from datafusion_tpu_torch.exec import compiler
    from portbench.core import port

    real_fits = compiler.topk_fits
    mesh = port.mesh(cell.cfg.get("shards"), devices)
    tables = cell.maker.make(cell.cfg, args.seed, port.homes(mesh, devices[0]))
    card = card_name(devices)
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict):
        rec = {"workload": args.workload, "seed": args.seed, "card": card, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    def timed(ctx, sql: str):
        harness.sync(devices)
        t0 = time.perf_counter()
        res = ctx.sql(sql)
        return res, time.perf_counter() - t0

    ctx = port.session(tables, devices[0], mesh)
    for tname, pool in traffic.instances(cell.mix, cell.cfg, args.seed).items():
        sql = pool[0].sql
        if "LIMIT" not in sql or "ORDER BY" not in sql:
            continue
        notes = [ln.strip() for ln in ctx.sql("EXPLAIN VERBOSE " + sql).result_str().splitlines() if "sort" in ln]
        ctx.sql(sql)
        c0 = counters()
        _, wall = timed(ctx, sql)
        c1 = counters()
        emit({"template": tname, "sql": sql, "explain": notes, "ms": wall * 1e3,
              "per_query": {k: c1[k] - c0[k] for k in c0}})
    del ctx

    for k in ks:
        for kind, text in QUERIES.items():
            sql = text.format(k=k)
            ctxs, res = {}, {}
            for route in ("topk", "sort"):
                set_ceiling((lambda k, capacity: k > 0) if route == "topk" else (lambda k, capacity: False))
                try:
                    ctxs[route] = port.session(tables, devices[0], mesh)
                    notes = [ln.strip() for ln in ctxs[route].sql("EXPLAIN VERBOSE " + sql).result_str().splitlines()
                             if "sort" in ln]
                    res[route], _ = timed(ctxs[route], sql)  # lowers and warms
                finally:
                    set_ceiling(real_fits)
                emit({"k": k, "query": kind, "route": route, "explain": notes})
            walls = {"topk": [], "sort": []}
            for r in range(args.reps):
                for route in (("topk", "sort") if r % 2 == 0 else ("sort", "topk")):
                    _, w = timed(ctxs[route], sql)
                    walls[route].append(w * 1e3)
            med = {r: statistics.median(v) for r, v in walls.items()}
            emit({"k": k, "query": kind, "rows_equal": same_rows(res["topk"], res["sort"]),
                  "topk_ms": walls["topk"], "sort_ms": walls["sort"], "median_ms": med,
                  "topk_over_sort": med["topk"] / med["sort"]})
            del ctxs, res
    if out is not None:
        out.close()


if __name__ == "__main__":
    main()
