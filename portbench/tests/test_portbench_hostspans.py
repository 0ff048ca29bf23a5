"""The host side of a traced window (`core/hostspans.py`) on synthetic
traces: launches placed by correlation whatever the clock offset, which
is recovered; a gap that opens inside a synchronize counts toward
`sync_idle_ms` and one that opens in plain Python does not;
`wrapper_host_ms` is self time; each new reader is None on a summary
with no queries; and the seven readers the benchmark had read the same
hand-computed values through this module's profile reader as through
`core.trace`'s."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench.core import hostspans, trace
from portbench.core.trace import DeviceEvent, Span, TraceSummary

NEW = ("host_syncs", "sync_idle_ms", "wrapper_host_ms")
OLD = ("plan_ms", "torch_ops_ms", "kernel_ms", "roofline_share", "device_idle_share", "d2h_ms", "peer_copy_mb")
OP, RT = 1, 99  # the profiler's thread ids of CPU ops and of runtime calls

SPANS = [Span("q1", 1000, 2000), Span("q2", 2100, 3000)]


def host_events():
    """(name, start, duration, thread, correlation, kind), host clock."""
    ops = [("portbench/q1", 1000, 1000, "template"), ("dft.sql", 1010, 980, "program"),
           ("dft.parse", 1010, 40, "program"), ("dft.node.Aggregate.dense", 1100, 700, "program"),
           ("dft.kernel.K2", 1200, 300, "program"), ("dft.to_card", 1300, 50, "program"),
           ("aten::nonzero", 1600, 100, "op"), ("dft.to_host", 1800, 180, "program"),
           ("portbench/q2", 2100, 900, "template"), ("dft.sql", 2110, 880, "program")]
    rts = [("cudaLaunchKernel", 1250, 10, 7), ("cudaLaunchKernel", 1400, 5, 8), ("cudaLaunchKernel", 1605, 5, 9),
           ("cudaStreamSynchronize", 1620, 70, 0), ("cudaLaunchKernel", 2500, 5, 10)]
    return ([(n, s, d, OP, 0, k) for n, s, d, k in ops] + [(n, s, d, RT, c, "runtime") for n, s, d, c in rts])


def device_events(skew: int):
    """Four kernels launched at 1250, 1400, 1605 (q1) and 2500 (q2), each
    starting `skew` + (0, 10, 10, 5) ns after its launch on the card's
    clock: (name, card, start, duration, correlation)."""
    return [("seg_dense_kernel<a>", 0, 1250 + skew, 100, 7), ("at::native::sort", 0, 1410 + skew, 100, 8),
            ("seg_dense_kernel<b>", 0, 1615 + skew, 30, 9), ("seg_dense_kernel<c>", 0, 2505 + skew, 100, 10)]


def side_of(skew: int):
    dev = device_events(skew)
    events = [DeviceEvent(n, c, s, d) for n, c, s, d, _ in dev]
    return hostspans.reduce([k for *_, k in dev], host_events(), SPANS, events, [0]), events


def test_launches_placed_by_correlation_and_offset_recovered():
    side, events = side_of(600)  # the card's clock 600 ns ahead: q1's last kernel starts inside q2's span
    assert side.offset_ns == {0: 600} and side.linked == 4 and side.unlinked == 0
    summary = hostspans.SpanSummary(cards=[0], spans=SPANS, events=hostspans.EventList(events),
                                    counters={"seg_dense_kernel": 3})
    summary.events.host = side
    placed = summary.kernel_counts()
    assert placed["q1"]["seg_dense_kernel"] == 2 and placed["q2"]["seg_dense_kernel"] == 1
    by_device_start = TraceSummary(cards=[0], spans=SPANS, events=events, counters={"seg_dense_kernel": 3})
    wrong = by_device_start.kernel_counts()  # by the device clock alone: q1's last kernel in q2, q2's after it
    assert [wrong[t]["seg_dense_kernel"] for t in ("q1", "q2", "between queries")] == [1, 1, 1]


def test_gap_opening_in_a_synchronize_is_sync_idle():
    side, events = side_of(-20)  # the card's clock 20 ns behind: shifted by 20
    assert side.offset_ns == {0: -20}
    gaps = {(g.start, g.end): g for g in side.gaps}
    old = TraceSummary(cards=[0], spans=SPANS, events=events).idle_gaps(top=99)
    assert sorted(ns for _, ns in old) == sorted((b - a) / 1e9 for a, b in gaps)  # the same gaps
    blocked = gaps[(1625, 2485)]  # opens at 1645 on the host clock, inside the synchronize
    assert blocked.blocked and blocked.label == "dft.sql > aten::nonzero > cudaStreamSynchronize"
    python = gaps[(1490, 1595)]  # opens at 1510, between ops
    assert not python.blocked and python.label == "dft.node.Aggregate.dense > python"
    assert side.sync_idle_ns == 860 and side.host_syncs == 1 and side.syncs_by_span == {"dft.node.Aggregate.dense": 1}


def test_idle_split_by_what_the_host_was_in():
    side, _ = side_of(-20)
    q1, q2, between = side.idle_by["q1"], side.idle_by["q2"], side.idle_by["between queries"]
    assert q1["dft.node.Aggregate.dense > python"] == 100 + 90 + 100 and q1["dft.parse > python"] == 30
    assert q1["dft.kernel.K2 > cudaLaunchKernel"] == 5 and q1["dft.node.Aggregate.dense > aten::nonzero"] == 10 + 10
    assert q1["dft.node.Aggregate.dense > aten::nonzero > cudaStreamSynchronize"] == 45
    assert q2["dft.sql > python"] == 390 + 385 and q2["- > python"] == 10 + 10 and between == {"- > python": 120}
    assert sum(sum(c.values()) for c in side.idle_by.values()) == 230 + 60 + 105 + 860 + 415  # every gap's time
    assert side.idle_in_sql == 230 + 60 + 105 + 740 + 385 and side.idle_named == 180 + 60 + 105 + 335


def test_wrapper_time_is_self_time():
    side, _ = side_of(0)
    assert side.kernel_spans == 1 and side.wrapper_self_ns == 300 - 50


def test_labels_name_the_span_path():
    side, events = side_of(-20)
    summary = hostspans.SpanSummary(cards=[0], spans=SPANS, events=hostspans.EventList(events))
    summary.events.host = side
    labels = summary.idle_gaps(top=2)
    assert labels[0] == ["between queries dft.sql > aten::nonzero > cudaStreamSynchronize", 860 / 1e9]
    assert labels[1] == ["q2 dft.sql > python", 415 / 1e9]


@pytest.mark.parametrize("name", NEW)
def test_new_reader_is_none_without_queries(name):
    reader = importlib.import_module(f"portbench.metrics.{name}")
    assert reader.read(TraceSummary()) is None
    assert reader.read(hostspans.SpanSummary(events=hostspans.EventList())) is None
    side, events = side_of(-20)
    summary = hostspans.SpanSummary(cards=[0], spans=SPANS, events=hostspans.EventList(events), queries=2)
    summary.events.host = side
    assert reader.read(summary) == {"host_syncs": 0.5, "sync_idle_ms": 860 / 1e6 / 2,
                                    "wrapper_host_ms": 250 / 1e6 / 2}[name]


class _Event:
    """A kineto event as `read_profile` reads it."""

    def __init__(self, name, start, dur, device=None, card=0, corr=0, tid=OP):
        self._v = (name, start, dur, device, card, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] == "cuda" else torch.autograd.DeviceType.CPU

    def device_index(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda _: events})()})()


def fixed_profile(annotations: bool) -> _Profile:
    """One query q1 over [1000, 2000] on two cards: a port kernel, a
    PyTorch kernel and a device-to-host copy on card 0, a PyTorch kernel
    on card 1, and, with `annotations`, the profiler's device-side copies
    of the program spans."""
    evs = [_Event("portbench/q1", 1000, 1000), _Event("portbench/q1", 1100, 500, "cuda"),
           _Event("dft.sql", 1010, 980), _Event("cudaLaunchKernel", 1100, 10, corr=5, tid=RT),
           _Event("fused_stage_kernel", 1200, 300, "cuda", 0, 5),
           _Event("void at::native::index_kernel", 1400, 200, "cuda", 0),
           _Event("Memcpy DtoH (Device -> Pinned)", 1700, 100, "cuda", 0),
           _Event("void cub::DeviceRadixSort", 1100, 400, "cuda", 1)]
    if annotations:
        evs += [_Event("dft.kernel.K1", 1200, 700, "cuda", 0), _Event("dft.node.Projection", 1000, 990, "cuda", 1)]
    return _Profile(evs)


def summary_of(kind, read, prof) -> TraceSummary:
    s = kind(cards=[0, 1])
    s.events, s.spans = read(prof)
    s.window_s = (s.spans[-1].end_ns - s.spans[0].start_ns) / 1e9
    s.queries, s.plan_s, s.least_bytes = 2, 0.004, 3350.0
    s.counters, s.hbm_bytes_per_s = {"to_card_bytes": 3_000_000}, 3.35e12
    return s


# by hand: window 1000 ns; card 0 busy 300 + 200 (overlapping 100) + 100 = 500 ns, card 1 400 ns
WANT = {"plan_ms": 2.0, "torch_ops_ms": 600 / 1e6 / 2, "kernel_ms": 300 / 1e6 / 2,
        "roofline_share": 100.0 * 3350.0 / (3.35e12 * 900e-9), "device_idle_share": 100.0 * (0.5 + 0.6) / 2,
        "d2h_ms": 100 / 1e6 / 2, "peer_copy_mb": 1.5}


@pytest.mark.parametrize("annotations", [False, True])
def test_old_readers_read_the_same(annotations):
    old = summary_of(TraceSummary, trace.read_profile, fixed_profile(False))
    new = summary_of(hostspans.SpanSummary, hostspans.read_profile, fixed_profile(annotations))
    for name in OLD:
        reader = importlib.import_module(f"portbench.metrics.{name}")
        assert reader.read(old) == pytest.approx(WANT[name], rel=1e-12), name
        assert reader.read(new) == reader.read(old), name
    assert new.device_ops() == old.device_ops()
    assert [ns for _, ns in new.idle_gaps()] == [ns for _, ns in old.idle_gaps()]
    assert hostspans.of(new).linked == 1 and hostspans.of(new).offset_ns == {0: 100}
