"""One run of one cell: make the configuration's tables from the seed,
register them with the port, warm every instance of the mix, drive the
measured window through `ExecutionContext.sql`, check a sample of its
results against the plain reference, and print the result line.

The window is a closed loop with one client: streams of the mix's
templates, one query after another. `qps` counts every query completed in
the window over the window's seconds (from its first query's start to the
end of the last query started before the deadline); `p95_ms` is the 95th
percentile of every query's latency; `setup_s` runs from the first
statement of `run.py` to the window's first query. With `--trace 1` the
profiler records whole streams, at most `TRACE_SECONDS` of them, with a
span around each query, and the line carries the per-layer metrics."""

from __future__ import annotations

import collections
import gc
import hashlib
import importlib
import json
import math
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.core import compare, traffic
from portbench.core.peaks import hbm_bytes_per_s
from portbench.core.trace import SPAN, TraceSummary, read_profile

PKG = Path(__file__).resolve().parent.parent  # portbench/
TRACE_SECONDS = 10.0  # the longest traced window: whole streams, its parse kept well inside a run's time
FORBIDDEN = ("jax", "jaxlib", "flax", "datafusion_tpu")
DOUBLE_MAX = 1.7976931348623157e308


class Cell:
    """A workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, root: Path, name: str):
        with open(root / "BENCHMARK.json") as f:
            spec = json.load(f)
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.work = work[name]
        self.name = name
        self.chips = int(self.work["chips"])
        entry = next(c for c in spec["configs"] if c["name"] == self.work["config"])
        with open(root / entry["file"]) as f:
            self.cfg = json.load(f)
        self.mix = traffic.load_mix(PKG / "mixes" / f"{self.work['traffic']}.json")
        self.maker = importlib.import_module(f"portbench.makers.{self.cfg['maker']}")
        self.reference = importlib.import_module(f"portbench.reference.{self.mix['reference']}")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
        with open(PKG / "limits" / f"{name}.json") as f:
            self.limits = json.load(f)
        self.readers = {m["name"]: importlib.import_module(f"portbench.metrics.{m['name']}") for m in self.per_layer}

    def devices(self, device) -> list | None:
        """The cell's cards; None (with the reason on standard error) where
        this machine has fewer. `device` names one device for every card
        instead: the tests' CPU path."""
        if device is not None:
            return [torch.device(device)] * self.chips
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < self.chips:
            log(f"refused: {self.name} needs {self.chips} CUDA device(s), this machine has {have}")
            return None
        return [torch.device("cuda", i) for i in range(self.chips)]


def least_bytes_of_template(sql: str, tables) -> int:
    """Each base-table column the query names, read once over its table."""
    words = set(re.findall(r"[A-Za-z_][A-Za-z_0-9]*", sql))
    return sum(tab.rows * col.itemsize for name, (tab, col) in tables.columns().items() if name in words)


def result_bytes(res) -> int:
    return sum(d.nbytes + (0 if v is None else v.nbytes) for d, v in res.cols)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(args, root: Path, device, t_start: float) -> int:
    cell = Cell(root, args.workload)
    devices = cell.devices(device)
    if devices is None:
        return 2
    from portbench.core import port

    marks = [("imports", time.perf_counter())]
    mesh = port.mesh(cell.cfg.get("shards"), devices)
    homes = port.homes(mesh, devices[0])
    tables = cell.maker.make(cell.cfg, args.seed, homes)
    sync(devices)
    marks.append(("tables", time.perf_counter()))
    ctx = port.session(tables, devices[0], mesh)
    sync(devices)
    marks.append(("register", time.perf_counter()))
    pools = traffic.instances(cell.mix, cell.cfg, args.seed)
    least = {t: least_bytes_of_template(cell.mix["templates"][t]["sql"], tables) for t in pools}
    for pool in pools.values():  # every instance, so that nothing compiles in the window
        for inst in pool:
            ctx.sql(inst.sql)
    sync(devices)
    gc.collect()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    edges = [t_start] + [t for _, t in marks]
    log(f"setup {setup_s:.3f} s (" + ", ".join(f"{n} {b - a:.3f}" for (n, _), a, b in zip(marks, edges, edges[1:]))
        + f"): tables {tables.nbytes()} B in {len(homes)} block(s) on {len(set(homes))} device(s), "
        f"{sum(len(p) for p in pools.values())} instances warmed")

    keep = cell.mix["keep"]
    kept: list = []
    keep_rng = random.Random(f"{args.seed}/keep")
    lat: list[float] = []
    by_template = collections.defaultdict(list)
    errors: list[str] = []
    trace = bool(args.trace)
    seconds = min(args.seconds, TRACE_SECONDS) if trace else args.seconds
    summary = TraceSummary(cards=[d.index or 0 for d in devices]) if trace else None
    before = port.counters() if trace else None
    c0 = before
    per_template = collections.defaultdict(lambda: collections.defaultdict(int))
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if devices[0].type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    streams = traffic.streams(cell.mix, args.seed)
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_end = t0
    done = False
    while not done:
        for tname, idx in next(streams):
            if not trace and time.perf_counter() >= deadline:
                done = True
                break
            inst = pools[tname][idx]
            q0 = time.perf_counter()
            try:
                if trace:
                    with torch.profiler.record_function(SPAN + tname):
                        res = ctx.sql(inst.sql)
                    c1 = port.counters()
                    for k, v in c1.items():
                        per_template[tname][k] += v - c0[k]
                    c0 = c1
                    summary.plan_s += ctx.last_stats["parse_s"] + ctx.last_stats["plan_s"]
                    summary.least_bytes += least[tname] + result_bytes(res)
                else:
                    res = ctx.sql(inst.sql)
            except Exception as e:  # a query that fails is counted, and the run is not correct
                res = None
                errors.append(f"{tname}#{idx}: {type(e).__name__}: {e}")
            t_end = time.perf_counter()
            lat.append(t_end - q0)
            by_template[tname].append(t_end - q0)
            if res is not None:  # a sample of the window's results, drawn from the seed
                if len(kept) < keep:
                    kept.append((inst, res))
                else:
                    j = keep_rng.randrange(n + 1)
                    if j < keep:
                        kept[j] = (inst, res)
            n += 1
        if trace and time.perf_counter() >= deadline:
            done = True
    window_s = t_end - t0
    if trace:
        prof.__exit__(None, None, None)
        after = port.counters()
        summary.counters = {k: after[k] - before[k] for k in after}
        summary.queries = n
        summary.events, summary.spans = read_profile(prof) if devices[0].type == "cuda" else ([], [])
        if summary.spans:
            summary.window_s = (summary.spans[-1].end_ns - summary.spans[0].start_ns) / 1e9
        del prof

    kind = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu"
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices] if devices[0].type == "cuda" else [0]
    peak = max(peaks)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"refused: the run's process holds {found}")
        return 3

    del ctx, mesh  # the program's state, before the reference runs
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    exact, ferr = verify(cell, tables.joined(devices[0]), kept, devices[0])
    ref_s = time.perf_counter() - r0
    checks = {
        "failed": {"value": len(errors), "limit": 0},
        "exact_mismatch": {"value": exact, "limit": 0},
        "float_err": {"value": min(ferr, DOUBLE_MAX), "limit": cell.limits["float_err"]},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(kept)

    metrics = {}
    device_info = {"platform": "gpu" if devices[0].type == "cuda" else devices[0].type, "kind": kind,
                   "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": n, "failed": len(errors)}
    if trace:
        summary.hbm_bytes_per_s = hbm_bytes_per_s(kind) or 0.0
        busy = summary.busy_s()
        device_info["busy_s"] = statistics.fmean(busy.values()) if busy else 0.0
        device_info["window_s"] = summary.window_s
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(summary)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": summary.device_ops(), "idle_gaps": summary.idle_gaps()}
        counts = summary.kernel_counts()
        for tname in pools:
            log(f"crosscheck {tname}: " + json.dumps({k: [per_template[tname][k], counts[tname].get(k, 0)]
                                                       for k in summary.counters if k.endswith("_kernel")}))
        log("crosscheck: [launches the wrappers counted, launches the trace holds] by template over the traced "
            "window; the port's counters over it " + json.dumps(summary.counters))
    else:
        p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3 if len(lat) > 1 else lat[0] * 1e3
        values = {"qps": n / window_s, "p95_ms": p95, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device_info
    out["checks"] = checks

    for e in errors[:5]:
        log(f"query failed: {e}")
    log("latency ms by template (median, max, count): " + json.dumps(
        {t: [round(statistics.median(v) * 1e3, 3), round(max(v) * 1e3, 3), len(v)] for t, v in by_template.items()}))
    log(f"window {window_s:.3f} s, {n} queries, setup {setup_s:.3f} s; peak device memory {peak} B "
        f"(max_memory_allocated, fullest card; by card {peaks}); reference {ref_s:.3f} s over {len(kept)} results")
    smi = shutil.which("nvidia-smi")
    if smi and devices[0].type == "cuda":
        q = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        log("cards: " + " | ".join(q.stdout.strip().splitlines()))
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


def digest(res) -> str:
    h = hashlib.blake2b(digest_size=16)
    for d, v in res.cols:
        h.update(np.ascontiguousarray(d).view(np.uint8) if d.dtype.kind != "O" else repr(d.tolist()).encode())
        h.update(b"-" if v is None else np.ascontiguousarray(v).view(np.uint8))
    return h.hexdigest()


def verify(cell: Cell, tables, kept, device) -> tuple[int, float]:
    """Every kept result against the reference of its instance: the
    summed exact mismatches and the widest float gap. Results of one
    instance with the same bytes are compared once and counted each time."""
    exact, ferr = 0, 0.0
    want, seen = {}, {}
    for inst, res in kept:
        key = (inst.template, inst.values)  # instances with the same constants share a reference
        dkey = key + (digest(res),)
        if dkey not in seen:
            if key not in want:
                want[key] = getattr(cell.reference, inst.template)(tables, inst.params, torch.float64)
            t = cell.mix["templates"][inst.template]
            seen[dkey] = compare.compare(compare.port_columns(res), want[key], t["ordered"], device)
        e, f = seen[dkey]
        exact += e
        ferr = max(ferr, f)
    return exact, ferr
