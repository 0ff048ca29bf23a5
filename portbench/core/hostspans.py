"""The host's side of a traced window, on the device's clock: the port's
program spans (`dft.*`, `datafusion_tpu_torch/utils/trace.py`), its CPU
ops and its CUDA runtime calls, tied to the device events they launched.

Every device event is tied to the runtime call that launched it by the
profiler's correlation id. The least `device start - launch start` over
those pairs, by card, is the clock offset between the two timelines;
where it is negative the device events are shifted by it, so that no
event starts before its launch. A device event then belongs to the
template whose span holds its launch, not its device start.

The idle gaps of the cards (the same gaps as `TraceSummary.idle_gaps`)
are put down to what the host was doing over them: each stretch of idle
time to the innermost program span and CPU op or runtime call the host
was in then ("python" where it was in no op), and each of the longest
gaps, whole, to the innermost program span that covers most of it and
the op it spent most in, or the blocking call (a synchronize, a
blocking copy) it opened in. The host's blocking calls inside `dft.sql`
spans, the idle time of the gaps that opened in one, and the self time
of the kernel wrappers' `dft.kernel.*` spans are summed here too;
`metrics/host_syncs.py`, `sync_idle_ms.py` and `wrapper_host_ms.py`
read them.

The reduction enters the harness through `install()`, which the readers
call when they are imported: the traced run then reads the profile
through `read_profile` here, which returns what `core.trace.read_profile`
returns, less the device-side copies of the program spans, and keeps the
host's side beside the device events; its summary labels the idle gaps
and places launches as above."""

from __future__ import annotations

import bisect
import json
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import numpy as np

from portbench.core import trace

PROGRAM = "dft."
ROOT = "dft.sql"
KERNEL = "dft.kernel."
# CUDA API calls (cuda*, cu*) that block the host until the card is done
BLOCKING = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2", "cuMemcpy",
})
LABELED = 32  # the longest gaps that get a label of their own


@dataclass(slots=True)
class HostEvent:
    name: str
    start: int
    end: int
    kind: str  # "program" (dft.*), "template" (the harness's span), "op" (a CPU op), "runtime"
    corr: int = 0
    depth: int = 0
    program_parent: int = -1  # index of the innermost program span around it
    in_sql: bool = False  # inside a dft.sql span
    outer_op: int = -1  # index of the outermost CPU op around it


@dataclass
class Gap:
    card: int
    start: int  # device clock
    end: int
    host_start: int = 0  # host clock
    template: str = ""
    blocked: bool = False  # it opened while the host waited in a blocking call inside dft.sql
    label: str = ""  # the span path over most of it (the longest gaps only: `LABELED`)


@dataclass
class HostSide:
    """The host's side of one traced window, reduced."""

    offset_ns: dict = field(default_factory=dict)  # card -> least device start - launch start
    linked: int = 0  # device events tied to their launch
    unlinked: int = 0
    sql_spans: int = 0
    host_syncs: int = 0  # blocking calls inside dft.sql spans
    syncs_by_span: Counter = field(default_factory=Counter)
    sync_idle_ns: int = 0
    wrapper_self_ns: int = 0
    kernel_spans: int = 0
    program_spans: Counter = field(default_factory=Counter)  # spans by name
    spans_by_template: Counter = field(default_factory=Counter)  # spans by the template they started in
    gaps: list = field(default_factory=list)  # Gap, the `LABELED` longest of every card's, longest first
    idle_by: dict = field(default_factory=lambda: defaultdict(Counter))  # template -> span path -> idle ns
    idle_in_sql: int = 0  # idle ns while the host was inside dft.sql
    idle_named: int = 0  # of those, inside a program span below dft.sql
    launch_template: dict = field(default_factory=dict)  # id(device event) -> template of its launch
    queries_by_template: Counter = field(default_factory=Counter)


def _main_thread(host: list) -> tuple[int | None, int | None]:
    """The thread of the harness's spans, and the thread that made most
    runtime calls (the profiler numbers them apart)."""
    op_tid = next((h[3] for h in host if h[5] == "template"), None)
    rt = Counter(h[3] for h in host if h[5] == "runtime")
    return op_tid, (rt.most_common(1)[0][0] if rt else None)


def nest(host: list) -> list[HostEvent]:
    """The main thread's host events, sorted by start, each with its
    depth, innermost program span, outermost CPU op and whether it lies
    inside dft.sql."""
    op_tid, rt_tid = _main_thread(host)
    evs = [HostEvent(n, s, s + d, k, c) for n, s, d, t, c, k in host
           if (t == rt_tid if k == "runtime" else t == op_tid)]
    evs.sort(key=lambda e: (e.start, -e.end))
    stack: list[int] = []
    for i, e in enumerate(evs):
        while stack and evs[stack[-1]].end <= e.start:
            stack.pop()
        if stack:
            p = evs[stack[-1]]
            e.depth = p.depth + 1
            e.program_parent = stack[-1] if p.kind == "program" else p.program_parent
            e.in_sql = p.in_sql or (p.kind == "program" and p.name == ROOT)
            e.outer_op = p.outer_op if p.outer_op >= 0 else (stack[-1] if p.kind == "op" else -1)
        stack.append(i)
    return evs


def segments(evs: list[HostEvent]) -> tuple[list[int], list[int]]:
    """The main thread's time cut where its innermost event changes: the
    start of each stretch and its innermost event's index (-1 for none);
    a stretch runs to the next one's start."""
    ts: list[int] = []
    inner: list[int] = []

    def cut(t: int, k: int) -> None:
        if ts and t <= ts[-1]:  # nothing between: the later state wins
            inner[-1] = k
        else:
            ts.append(t)
            inner.append(k)

    stack: list[int] = []
    for i, e in enumerate(evs):
        while stack and evs[stack[-1]].end <= e.start:
            j = stack.pop()
            cut(evs[j].end, stack[-1] if stack else -1)
        cut(e.start, i)
        stack.append(i)
    while stack:
        j = stack.pop()
        cut(evs[j].end, stack[-1] if stack else -1)
    return ts, inner


class _Paths:
    """What the host was in, by innermost event: its program span's name
    and its op (the outermost CPU op around it, and the runtime call where
    it is one; "python" where none), memoized."""

    def __init__(self, evs: list[HostEvent]):
        self.evs = evs
        self.memo: dict[int, tuple] = {}

    def span_of(self, k: int) -> int:
        if k < 0:
            return -1
        e = self.evs[k]
        return k if e.kind == "program" else e.program_parent

    def op(self, k: int) -> str:
        e = self.evs[k] if k >= 0 else None
        if e is None or e.kind not in ("op", "runtime"):
            return "python"
        outer = self.evs[e.outer_op].name if e.outer_op >= 0 else None
        if e.kind == "op":
            return outer or e.name
        return f"{outer} > {e.name}" if outer else e.name

    def of(self, k: int) -> tuple[str, bool, bool]:
        """(span path, inside dft.sql, inside a span below dft.sql)."""
        got = self.memo.get(k)
        if got is None:
            s = self.span_of(k)
            sp = self.evs[s] if s >= 0 else None
            in_sql = sp is not None and (sp.name == ROOT or sp.in_sql)
            got = (f"{sp.name if sp else '-'} > {self.op(k)}", in_sql, in_sql and sp.name != ROOT)
            self.memo[k] = got
        return got

    def blocking(self, k: int) -> bool:
        return k >= 0 and self.evs[k].kind == "runtime" and self.evs[k].name in BLOCKING


def _label(paths: _Paths, ts: list[int], inner: list[int], a: int, b: int) -> str:
    """A gap's host interval [a, b) as one span path: the innermost
    program span that covers at least half of it (else the one that
    covers most), then the blocking call it opened in, or else the op
    that covers most of it ("python": no op)."""
    evs = paths.evs
    cover: Counter = Counter()
    ops: Counter = Counter()
    i = bisect.bisect_right(ts, a) - 1
    opening = inner[i] if i >= 0 else -1
    while i < len(ts) and (i < 0 or ts[i] < b):
        lo = max(a, ts[i]) if i >= 0 else a
        hi = min(b, ts[i + 1]) if i + 1 < len(ts) else b
        k = inner[i] if i >= 0 else -1
        if hi > lo:
            s = paths.span_of(k)
            while s >= 0:
                cover[s] += hi - lo
                s = evs[s].program_parent
            ops[paths.op(k)] += hi - lo
        i += 1
    half = (b - a) / 2
    best = max(cover, key=lambda s: (cover[s] >= half, evs[s].depth if cover[s] >= half else cover[s]),
               default=-1)
    span = evs[best].name if best >= 0 else "-"
    op = paths.op(opening) if paths.blocking(opening) else ops.most_common(1)[0][0] if ops else "python"
    return f"{span} > {op}"


def card_gaps(events: list, cards: list, w0: int, w1: int) -> dict:
    """Every stretch in which a card ran nothing between `w0` and `w1`,
    as `TraceSummary.idle_gaps` finds them: by card, their starts and
    ends (int64 arrays, device clock)."""
    by_card = defaultdict(list)
    for e in events:
        by_card[e.card].append((e.start_ns, e.start_ns + e.dur_ns))
    out = {}
    for card in cards:
        a, b, edge = [], [], w0
        for s, t in trace._union(by_card.get(card, [])) + [(w1, w1)]:
            if s > edge:
                a.append(edge)
                b.append(s)
            edge = max(edge, t)
        out[card] = (np.array(a, dtype=np.int64), np.array(b, dtype=np.int64))
    return out


def _idle_in(ts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Idle ns within each stretch [ts[i], ts[i + 1]) (the last runs on
    to the end of the last gap) of gaps [a, b): the differences of the
    running sum of idle time, which is linear inside a gap and flat
    between two."""
    run = np.concatenate([[0], np.cumsum(b - a)]).astype(np.float64)
    x = np.empty(2 * len(a), dtype=np.float64)
    y = np.empty(2 * len(a), dtype=np.float64)
    x[0::2], x[1::2], y[0::2], y[1::2] = a, b, run[:-1], run[1:]
    edges = np.append(ts, max(int(ts[-1]), int(b.max()))).astype(np.float64)
    return np.diff(np.interp(edges, x, y, left=0.0))


def reduce(corrs: list, host: list, spans: list, events: list, cards: list) -> HostSide:
    """The host's side of the window: `events` and `spans` as
    `read_profile` gives them (the device events, the templates' spans),
    `corrs` each device event's correlation id, `host` the host events as
    (name, start ns, duration ns, thread, correlation id, kind), `cards`
    the cell's."""
    out = HostSide()
    evs = nest(host)
    out.queries_by_template = Counter(s.template for s in spans)

    # each device event's launch, by correlation id; the offset by card
    launch = {e.corr: e.start for e in evs if e.kind == "runtime" and e.corr}
    least: dict[int, int] = {}
    launched_at = {}
    for e, corr in zip(events, corrs):
        t = launch.get(corr)
        if t is None:
            out.unlinked += 1
            continue
        out.linked += 1
        launched_at[id(e)] = t
        d = e.start_ns - t
        least[e.card] = min(least.get(e.card, d), d)
    out.offset_ns = least
    shift = {c: max(0, -v) for c, v in least.items()}
    span_starts = [s.start_ns for s in spans]

    def template_at(t: int) -> str:
        i = bisect.bisect_right(span_starts, t) - 1
        return spans[i].template if i >= 0 and t <= spans[i].end_ns else "between queries"

    for e in events:
        t = launched_at.get(id(e), e.start_ns + shift.get(e.card, 0))
        out.launch_template[id(e)] = template_at(t)

    # spans, blocking calls, the wrappers' self time
    child_ns = Counter()
    for i, e in enumerate(evs):
        if e.kind == "program":
            out.program_spans[e.name] += 1
            out.spans_by_template[template_at(e.start)] += 1
            if e.program_parent >= 0:
                child_ns[e.program_parent] += e.end - e.start
        elif e.kind == "runtime" and e.name in BLOCKING and e.in_sql:
            out.host_syncs += 1
            out.syncs_by_span[evs[e.program_parent].name if e.program_parent >= 0 else "-"] += 1
    out.sql_spans = out.program_spans[ROOT]
    for i, e in enumerate(evs):
        if e.kind == "program" and e.name.startswith(KERNEL):
            out.kernel_spans += 1
            out.wrapper_self_ns += e.end - e.start - child_ns[i]

    if not spans or not evs:
        return out
    # every gap's time split by what the host was in; the clock's zero at the window's start
    w0 = spans[0].start_ns
    ts, inner = segments(evs)
    paths = _Paths(evs)
    t_rel = np.array(ts, dtype=np.int64) - w0
    inner_arr = np.array(inner, dtype=np.int64)
    keys: dict[tuple, int] = {}
    key_of = np.empty(len(evs) + 1, dtype=np.int64)  # by event, the last for none
    for k in range(-1, len(evs)):
        key_of[k] = keys.setdefault(paths.of(k), len(keys))
    names = list(keys)
    seg_key = key_of[inner_arr]
    blocking = np.array([paths.blocking(k) and evs[k].in_sql for k in range(len(evs))] + [False])
    starts = np.array([sp.start_ns for sp in spans], dtype=np.int64) - w0
    ends = np.array([sp.end_ns for sp in spans], dtype=np.int64) - w0
    at = np.searchsorted(starts, t_rel, side="right") - 1
    seg_tmpl = np.where((at >= 0) & (t_rel < ends[np.maximum(at, 0)]), at, -1)
    tmpl_names = [sp.template for sp in spans]
    idle = np.zeros(len(ts))
    lengths, where = [], []
    for card, (a, b) in card_gaps(events, cards, w0, spans[-1].end_ns).items():
        if not len(a):
            continue
        sh = shift.get(card, 0) - w0
        idle += _idle_in(t_rel, a + sh, b + sh)
        opening = np.searchsorted(t_rel, a + sh, side="right") - 1
        blocked = blocking[np.where(opening >= 0, inner_arr[np.maximum(opening, 0)], -1)]
        out.sync_idle_ns += int((b - a)[blocked].sum())
        lengths.append(b - a)
        where.append(np.stack([np.full(len(a), card), a, b, blocked]))
    for (tm, key), ns in zip(*_summed(seg_tmpl, seg_key, idle)):
        out.idle_by[tmpl_names[tm] if tm >= 0 else "between queries"][names[key][0]] += ns
        out.idle_in_sql += ns if names[key][1] else 0
        out.idle_named += ns if names[key][2] else 0
    if lengths:
        every = np.concatenate(where, axis=1)
        for j in np.argsort(-np.concatenate(lengths), kind="stable")[:LABELED]:
            card, a, b, blocked = (int(v) for v in every[:, j])
            g = Gap(card, a, b, a + shift.get(card, 0), blocked=bool(blocked))
            g.template = template_at(g.host_start + (b - a) // 2)
            g.label = _label(paths, ts, inner, g.host_start, g.host_start + b - a)
            out.gaps.append(g)
    return out


def _summed(tmpl: np.ndarray, key: np.ndarray, ns: np.ndarray):
    """The sums of `ns` by (template, key) pair, as the pairs and the sums."""
    width = int(key.max()) + 1
    u, inv = np.unique((tmpl + 1) * width + key, return_inverse=True)
    sums = np.bincount(inv, weights=ns)
    return [(int(p) // width - 1, int(p) % width) for p in u], [int(round(v)) for v in sums]


def idle_table(side: HostSide, top: int = 8) -> dict:
    """Device idle ms per query by what the host was in over it (span
    path), for each template (summed over the cards; "between queries"
    over every query), the `top` largest."""
    out = {}
    for tname, paths in sorted(side.idle_by.items()):
        q = side.queries_by_template.get(tname) or sum(side.queries_by_template.values()) or 1
        out[tname] = [[p, round(ns / 1e6 / q, 4)] for p, ns in paths.most_common(top)]
    return out


def report(side: HostSide) -> None:
    """The host side's lines on standard error."""
    in_sql, named = side.idle_in_sql, side.idle_named
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log("crosscheck clock: least device start - launch start by card (ns) " + json.dumps(side.offset_ns)
        + f"; device events tied to their launch {side.linked}, not tied {side.unlinked}; placed by launch")
    log("host spans: " + json.dumps(dict(side.program_spans.most_common())) + f" over {side.sql_spans} dft.sql; "
        "per query by template " + json.dumps({t: round(n / (side.queries_by_template.get(t) or 1), 2)
                                               for t, n in sorted(side.spans_by_template.items())}))
    log("host syncs inside dft.sql by innermost span: " + json.dumps(dict(side.syncs_by_span.most_common())))
    log("idle ms per query by span path, by template: " + json.dumps(idle_table(side)))
    share = f"{100.0 * named / in_sql:.2f}%" if in_sql else "none"
    log(f"idle inside dft.sql named by a span below it: {share} of {in_sql / 1e6:.3f} ms")


class EventList(list):
    """The device events the harness keeps, with the profile's raw events
    beside them (`raw`: the events' correlation ids, the host's events and
    the templates' spans), reduced once, on first use (`of`)."""

    raw: tuple | None = None
    host: HostSide | None = None


def read_profile(prof):
    """What `core.trace.read_profile` returns (the device events and the
    templates' spans), less the profiler's device-side copies of the
    program spans, which are not device work; the returned event list
    keeps each event's correlation id and the host's events beside it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kept, spans, corrs, host = EventList(), [], [], []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith((trace.SPAN, PROGRAM)):
                kept.append(trace.DeviceEvent(name, e.device_index(), start, dur))
                corrs.append(e.correlation_id())
            continue
        if name.startswith(trace.SPAN):
            spans.append(trace.Span(name[len(trace.SPAN):], start, start + dur))
            kind = "template"
        elif name.startswith(PROGRAM):
            kind = "program"
        else:  # a CUDA API call (cudaLaunchKernel, cuLaunchKernel), or a CPU op
            kind = "runtime" if name.startswith("cu") and "::" not in name else "op"
        host.append((name, start, dur, e.start_thread_id(), e.correlation_id(), kind))
    spans.sort(key=lambda s: s.start_ns)
    kept.raw = (corrs, host, spans)
    return kept, spans


def of(t) -> HostSide | None:
    """The host's side of a summary, where the run recorded one: reduced
    on the first call, which prints `report`'s lines."""
    evs = t.events
    if getattr(evs, "host", None) is None and getattr(evs, "raw", None) is not None:
        corrs, host, spans = evs.raw
        evs.raw = None
        evs.host = reduce(corrs, host, spans, evs, t.cards)
        report(evs.host)
    return getattr(evs, "host", None)


class SpanSummary(trace.TraceSummary):
    """`TraceSummary` whose idle gaps name the host's span path after
    their template, and whose launches belong to the template that
    launched them."""

    def idle_gaps(self, top: int = 10) -> list:
        """The `top` longest gaps (at most `LABELED`), each labelled with
        its template, its card where there are several, and its span
        path."""
        side = of(self)
        if side is None or not side.gaps:
            return super().idle_gaps(top)
        multi = len(self.cards) > 1
        return [[f"{g.template}{f' cuda:{g.card}' if multi else ''} {g.label}", (g.end - g.start) / 1e9]
                for g in side.gaps[:top]]

    def kernel_counts(self) -> dict[str, dict[str, int]]:
        side = of(self)
        if side is None:
            return super().kernel_counts()
        names = [k for k in self.counters if k.endswith("_kernel")]
        out = defaultdict(lambda: defaultdict(int))
        for e in self.events:
            for k in names:
                if k in e.name:
                    out[side.launch_template.get(id(e), "between queries")][k] += 1
        return out


def install() -> None:
    """Read the traced window through this module: the harness's
    profile reader and summary become `read_profile` and `SpanSummary`."""
    from portbench.core import harness

    harness.read_profile = read_profile
    harness.TraceSummary = SpanSummary
