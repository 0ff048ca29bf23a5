"""The host self time of the port's program spans in one benchmark cell,
with the profiler off and with it recording.

    python3 scripts/span_self_times.py --workload cities_2e25.groupby --seed 7 [--queries 400] [--rounds 2]

Makes the cell's tables and session as `portbench/run.py` does, warms
every instance, draws one list of `--queries` queries from the cell's
streams, and runs that list `--rounds` times each way, in turns:

- off: no profiler; the port's `span` (datafusion_tpu_torch/utils/
  trace.py) is replaced by a timer that sums each span's self time (the
  span less the spans inside it), as the profiler would have recorded
  it. The timers add about two `perf_counter` calls to each span;
- on: under `torch.profiler`, as `run.py --trace 1` records, with the
  self time of each span from `portbench/core/hostspans.py`'s reduction
  (the `dft.kernel.*` total is what `wrapper_host_ms` reads).

Prints one line a pass: queries per second, and the self ms per query
of the kernel wrappers (`dft.kernel.*`) in all and of every span name.
The two sides' wrapper sums differ by what the profiler adds to the host
work it records (one event for every torch op and runtime call inside a
wrapper). `--device cpu` runs a tiny-scale check on the CPU (the
configurations' `rows` cut to 50,000)."""

import argparse
import collections
import itertools
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from portbench.core import harness, hostspans, traffic  # noqa: E402


class Timers:
    """A stand-in for `trace.span`: each span's own seconds, summed by name."""

    def __init__(self):
        self.own = collections.Counter()
        self.stack: list = []

    def span(self, name: str):
        return _Timed(self, name)


class _Timed:
    __slots__ = ("timers", "name", "t0", "inner")

    def __init__(self, timers: Timers, name: str):
        self.timers, self.name = timers, name

    def __enter__(self):
        self.inner = 0.0
        self.timers.stack.append(self)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        spent = time.perf_counter() - self.t0
        stack = self.timers.stack
        stack.pop()
        self.timers.own[self.name] += spent - self.inner
        if stack:
            stack[-1].inner += spent


def timed_spans(timers: Timers) -> list:
    """Every binding of the port's `span` pointed at `timers`; the bindings
    to put back."""
    from datafusion_tpu_torch.utils import trace

    real = trace.span
    mods = [m for n, m in list(sys.modules.items()) if n.startswith("datafusion_tpu_torch")
            and getattr(m, "span", None) is real]
    for m in mods:
        m.span = timers.span
    return [(m, real) for m in mods]


def traced_own(prof, cards: list) -> tuple[collections.Counter, float]:
    """The self seconds of every program span in the profile, by name, and
    `HostSide.wrapper_self_ns` in seconds (what `wrapper_host_ms` reads)."""
    events, spans = hostspans.read_profile(prof)
    corrs, host, _ = events.raw
    evs = hostspans.nest(host)
    inner = collections.Counter()
    for e in evs:
        if e.kind == "program" and e.program_parent >= 0:
            inner[e.program_parent] += e.end - e.start
    own = collections.Counter()
    for i, e in enumerate(evs):
        if e.kind == "program":
            own[e.name] += (e.end - e.start - inner[i]) / 1e9
    side = hostspans.reduce(corrs, host, spans, events, cards)
    return own, side.wrapper_self_ns / 1e9


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default=None, help="one device for every card (cpu: a tiny-scale check)")
    args = ap.parse_args()

    cell = harness.Cell(REPO, args.workload)
    devices = cell.devices(args.device)
    if devices is None:
        sys.exit(2)
    if devices[0].type == "cpu":
        cell.cfg["rows"] = {t: min(r, 50000) for t, r in cell.cfg["rows"].items()}
    from portbench.core import port

    mesh = port.mesh(cell.cfg.get("shards"), devices)
    tables = cell.maker.make(cell.cfg, args.seed, port.homes(mesh, devices[0]))
    ctx = port.session(tables, devices[0], mesh)
    pools = traffic.instances(cell.mix, cell.cfg, args.seed)
    for pool in pools.values():
        for inst in pool:
            ctx.sql(inst.sql)
    order = list(itertools.islice(itertools.chain.from_iterable(traffic.streams(cell.mix, args.seed)), args.queries))
    harness.sync(devices)
    card = "cpu"
    if devices[0].type == "cuda":
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    acts = [torch.profiler.ProfilerActivity.CPU]
    if devices[0].type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def run(traced: bool):
        for tname, idx in order:
            if traced:
                with torch.profiler.record_function(harness.SPAN + tname):
                    ctx.sql(pools[tname][idx].sql)
            else:
                ctx.sql(pools[tname][idx].sql)

    for r in range(args.rounds):
        for traced in (False, True):
            harness.sync(devices)
            if traced:
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    run(True)
                    wall = time.perf_counter() - t0
                own, wrappers = traced_own(prof, [d.index or 0 for d in devices])
                del prof
            else:
                timers = Timers()
                put_back = timed_spans(timers)
                try:
                    t0 = time.perf_counter()
                    run(False)
                    wall = time.perf_counter() - t0
                finally:
                    for m, real in put_back:
                        m.span = real
                own = timers.own
                wrappers = sum(v for k, v in own.items() if k.startswith(hostspans.KERNEL))
            n = len(order)
            print(f"{args.workload} {card} round {r} {'on ' if traced else 'off'}: {n / wall:.3f} queries/s, "
                  f"dft.kernel.* self {wrappers * 1e3 / n:.4f} ms/query; self ms/query by span "
                  + json.dumps({k: round(v * 1e3 / n, 4) for k, v in own.most_common()}), flush=True)


if __name__ == "__main__":
    main()
