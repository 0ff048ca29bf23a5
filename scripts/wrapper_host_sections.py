"""Where K5's and K6's wrappers spend their host time, for one checkout.

    python3 scripts/wrapper_host_sections.py [--root DIR]

Calls `ragged_exchange` and `ragged_exchange_fold` (ops/pallas/
ragged_shuffle.py) of the checkout at DIR (default: this one) on one card
at about phase 6's shapes: 8 senders and 8 receivers, 2^19-row regions
90% full, K6 with m3's ops (COUNT, two f64 SUMs, MIN, MAX) over 1250
windows, K5 with three arrays. It prints one line per wrapper: the host
time of one call started with the card idle (median of 20), the mean of
20 calls enqueued back to back (chip_smoke.py `host_only_ms`), and the
host time inside each helper, C entry and torch call the wrapper makes
(each wrapped in a timer; the timers add a little to every section).
Host speed drifts within one machine by more than a wrapper's own
change, so two checkouts are compared by running this script for each in
turns (parent, change, change, parent) and reading the sections side by
side.
"""

import argparse
import collections
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPERS = ("_check_fold", "_check_exchange", "_check_devices", "card_groups", "_sizes_block", "fold_tables",
           "fold_pointer_table", "c_entries", "check_fixed_rows", "fold_launches", "fold_widths", "exchange_args",
           "receivers")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="checkout whose datafusion_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("wrapper_host_sections: no CUDA device; the wrappers' card path is timed on the card only")
    from datafusion_tpu_torch.ops.pallas import cuda_lib
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    if not os.path.abspath(rs.__file__).startswith(root):
        sys.exit(f"wrapper_host_sections: imported {rs.__file__}, not the checkout at {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    spent = collections.defaultdict(float)

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    for name in HELPERS:
        if hasattr(rs, name):  # a checkout may lack a helper
            setattr(rs, name, timed(name, getattr(rs, name)))
    lib = cuda_lib.load_library()

    class Lib:
        def __getattr__(self, name):
            return timed(f"C {name}", getattr(lib, name))

    timed_lib = Lib()
    cuda_lib.load_library = lambda: timed_lib
    for name in ("pin_memory", "to"):
        setattr(torch.Tensor, name, timed(name, getattr(torch.Tensor, name)))
    for name in ("tensor", "empty", "zeros"):
        setattr(torch, name, timed(f"torch.{name}", getattr(torch, name)))

    dev = torch.device("cuda")
    n_dev, split_cap, num_groups = 8, 1 << 19, 1250
    gen = torch.Generator(device=dev).manual_seed(0)
    gids = [torch.randint(0, num_groups, (n_dev * split_cap,), dtype=torch.int32, device=dev, generator=gen)
            for _ in range(n_dev)]
    vals = []
    for _ in range(n_dev):
        a, b = (torch.randn(n_dev * split_cap, dtype=torch.float64, device=dev, generator=gen) for _ in range(2))
        vals.append([None, a, b, b, a])
    sizes = torch.full((n_dev, n_dev), split_cap * 9 // 10, dtype=torch.int32, device=dev)
    fold_kw = dict(ops=("count", "sum", "sum", "min", "max"), mask_map=(0,) * 5, n_dev=n_dev, split_cap=split_cap,
                   num_groups=num_groups)
    sends = [[gids[j], vals[j][1], vals[j][2]] for j in range(n_dev)]
    calls = {"ragged_exchange_fold": lambda: rs.ragged_exchange_fold(gids, vals, [[]] * n_dev, sizes, **fold_kw),
             "ragged_exchange": lambda: rs.ragged_exchange(sends, sizes, n_dev=n_dev, split_cap=split_cap, chunk=1024)}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        idle = []
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            idle.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        spent.clear()
        t = time.perf_counter()
        for _ in range(20):
            fn()
        queued = (time.perf_counter() - t) / 20
        torch.cuda.synchronize()
        print(f"{root} {card} {name}: idle median {statistics.median(idle) * 1e6:.1f} us, back to back "
              f"{queued * 1e6:.1f} us; sections (us a call) "
              + ", ".join(f"{k} {v / 20 * 1e6:.1f}" for k, v in sorted(spent.items(), key=lambda kv: -kv[1])),
              flush=True)


if __name__ == "__main__":
    main()
