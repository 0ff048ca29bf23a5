"""Readings that the limits of `correct` are set from, for one cell over
many seeds in one process: for each seed, every instance of the mix runs
once through the port (the window's own entry, `ExecutionContext.sql`,
at the cell's size) and is compared with the float64 reference; the
control, the reference computed in float32 put in the port's place, is
compared the same way.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--no-control]

Prints one JSON line per seed; the benchmark's own runs never run this."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, tables, ctx, pools, control: bool, device="cpu") -> dict:
    import torch

    from portbench.core import compare

    out = {"program": {"exact_mismatch": 0, "float_err": 0.0, "worst": None}}
    if control:
        out["control"] = {"exact_mismatch": 0, "float_err": 0.0, "worst": None}
    for tname, pool in pools.items():
        t = cell.mix["templates"][tname]
        fn = getattr(cell.reference, tname)
        for inst in pool:
            want = fn(tables, inst.params, torch.float64)
            sides = {"program": compare.port_columns(ctx.sql(inst.sql))}
            if control:
                sides["control"] = fn(tables, inst.params, torch.float32)
            for side, got in sides.items():
                e, f = compare.compare(got, want, t["ordered"], device)
                r = out[side]
                r["exact_mismatch"] += e
                if f >= r["float_err"]:
                    r["float_err"], r["worst"] = f, f"{tname}#{inst.index}"
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench.core import port, traffic
    from portbench.core.harness import Cell

    cell = Cell(ROOT, args.workload)
    devices = cell.devices(device)
    if devices is None:
        return 2
    mesh = port.mesh(cell.cfg.get("shards"), devices)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        tables = cell.maker.make(cell.cfg, seed, port.homes(mesh, devices[0]))
        ctx = port.session(tables, devices[0], mesh)
        pools = traffic.instances(cell.mix, cell.cfg, seed)
        r = readings(cell, tables.joined(devices[0]), ctx, pools, not args.no_control, devices[0])
        r.update(seed=seed, workload=cell.name, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
        del ctx, tables
        gc.collect()
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
