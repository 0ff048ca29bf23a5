"""Repeat one TPC-H shape on the card and count how often it gives the CPU's rows.

    python3 scripts/tpch_repeat.py [--root DIR] [--query q15ish] [--runs 30]

Registers benchmarks/tpch.py's tables at scale 0.05 (300K lineitem rows)
in a context on the card and one on the CPU, runs the query `--runs`
times on the card, and prints one JSON line: the CPU's row count, the
card's row count in each run, how many runs gave the CPU's rows (row
count and order, every non-float value exact, floats within rtol 1e-9,
as tests/test_torch_cuda.py holds them), how many gave its result_str
byte for byte, how many distinct result_str the runs gave, and, for
q15ish, whether its revenue view's per-supplier f64 sums
(a GROUP BY with SUM, the view the query compares against its own MAX)
came out bit for bit the same in 5 runs, with the largest difference.
The engine comes from DIR (default: this checkout), first on sys.path,
so a parent checkout can be run beside this one in the same call.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REVENUE = ("SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) AS r FROM lineitem "
           "WHERE l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-04-01' "
           "GROUP BY l_suppkey ORDER BY l_suppkey")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose datafusion_tpu_torch runs the query")
    ap.add_argument("--query", default="q15ish", help="a name in benchmarks/tpch.py QUERIES")
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("tpch_repeat: no CUDA device; the query is repeated on the card only")
    import datafusion_tpu_torch as port  # before tpch, which puts this checkout first on sys.path

    if not os.path.abspath(port.__file__).startswith(root + os.sep):
        sys.exit(f"tpch_repeat: imported {port.__file__}, not the checkout at {root}")
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    import tpch

    gpu, cpu = port.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, cols in zip(("lineitem", "orders", "customer", "part"), tpch.gen_tables(0.05)):
        t = port.Table.from_pydict(cols, device="cpu")
        gpu.register_table(name, t)
        cpu.register_table(name, t)
    q = tpch.QUERIES[args.query]
    want = cpu.sql(q)
    got = [gpu.sql(q) for _ in range(args.runs)]

    def same_rows(r):
        if r.num_rows != want.num_rows:
            return False
        for j, ((a, _), (b, _)) in enumerate(zip(r.cols, want.cols)):
            if np.asarray(a).dtype.kind == "f":
                if not np.allclose(a, b, rtol=1e-9, atol=0, equal_nan=True):
                    return False
            elif r.column_values(j) != want.column_values(j):
                return False
        return True

    out = {"root": root, "query": args.query, "cpu_rows": want.num_rows,
           "card_rows": [r.num_rows for r in got], "runs_with_cpu_rows": sum(same_rows(r) for r in got),
           "runs_equal_to_cpu": sum(r.result_str() == want.result_str() for r in got),
           "distinct_results": len({r.result_str() for r in got})}
    if args.query == "q15ish":
        sums = [gpu.sql(REVENUE).cols[1][0].copy() for _ in range(5)]
        out["revenue_bit_equal"] = [bool(np.array_equal(s.view(np.uint64), sums[0].view(np.uint64))) for s in sums]
        out["revenue_max_abs_diff"] = max(float(np.abs(s - sums[0]).max()) for s in sums)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out["card"] = limit
    print(json.dumps(out))


if __name__ == "__main__":
    main()
