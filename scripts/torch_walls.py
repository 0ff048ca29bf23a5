"""Warm walls of the port's main-path queries on the card, for one checkout.

    python3 scripts/torch_walls.py [--root DIR] [--reps 5] [--cards N] [--wrappers]

Runs chip_smoke.py's phase-4 queries (q1-q5 on one card, in a context made
with bigdense on) and phase-6 queries (m1-m8 over 8 logical shards; with
`--cards N`, over `make_mesh(8, devices=<the first N cards>)`, each
shard's rows placed on its card) over the same seeded table, and prints
one JSON line: the median warm wall of each query in ms (host clock
around `ctx.sql` plus a synchronize), with the card's name and power
limit. `--wrappers` adds K5's and K6's wrappers at m6's and m3's shapes on
that mesh, called on the arguments those queries gave them: each one's
CUDA-event time and host time (chip_smoke.py `time_ms`, `host_only_ms`). The queries and data come from this
checkout's chip_smoke.py; the engine comes from DIR (default: this
checkout), which goes first on sys.path. A wall is mostly host time, and
host time differs between machines by more than a kernel's time, so two
checkouts are compared by running this script for each on the same
machine and card, in turns (parent, change, change, parent).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose datafusion_tpu_torch runs the queries")
    ap.add_argument("--reps", type=int, default=5, help="warm runs per query (the median is kept)")
    ap.add_argument("--cards", type=int, default=1, help="cards the 8-shard mesh spreads over (a divisor of 8)")
    ap.add_argument("--wrappers", action="store_true", help="also time K5's and K6's wrappers at m6's and m3's shapes")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_walls: no CUDA device; the walls are measured on the card only")
    import datafusion_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(root):
        sys.exit(f"torch_walls: imported {port.__file__}, not the checkout at {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    arrays = smoke.main_arrays()
    ctx = port.ExecutionContext(bigdense=True)
    ctx.register_table("big", smoke.main_table(port, arrays))
    devices = [torch.device("cuda", i) for i in range(args.cards)]
    mesh = port.ExecutionContext(mesh=port.make_mesh(8) if args.cards == 1 else port.make_mesh(8, devices=devices))
    mesh.register_table("big", smoke.mesh_table(port, ctx.table("big"), arrays[5]))
    walls = {}
    for c, queries in ((ctx, smoke.MAIN_QUERIES), (mesh, smoke.MESH_QUERIES)):
        for name, q, _ in queries:
            walls[name] = smoke.warm_wall_ms(c, q, reps=args.reps)
    out = {"root": root, "card": card, "cards": args.cards, "reps": args.reps, "warm_wall_ms": walls}
    if args.wrappers:
        out["wrappers"] = wrapper_ms(smoke, mesh)
    print(json.dumps(out), flush=True)


def wrapper_ms(smoke, ctx):
    """{K5, K6: {event ms, host ms}} of the wrappers called on the
    arguments m6 and m3 gave them in `ctx`."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.parallel import shuffle as sh

    out = {}
    for name, (qname, q, _) in (("ragged_exchange", smoke.MESH_QUERIES[5]),
                                ("ragged_exchange_fold", smoke.MESH_QUERIES[2])):
        ((a, kw),) = smoke.capture(sh, name, lambda: ctx.sql(q))[-1:]
        call = lambda: getattr(rs, name)(*a, **kw)  # noqa: E731
        out[name] = {"query": qname, "ms": smoke.time_ms(call), "host_ms": smoke.host_only_ms(call)}
    return out


if __name__ == "__main__":
    main()
