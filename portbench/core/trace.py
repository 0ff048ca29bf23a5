"""The reduction of a traced window: device activity from the profiler,
the harness's own spans around each query, and the port's counters, into
one `TraceSummary` that the per-layer readers (`metrics/`) read.

Device activity is every device event of the trace: kernels, memcpys and
memsets. "PyTorch's own" are the kernels named under `at::`, `c10::`,
CUB, cuBLAS or NCCL; every other kernel is the port's, so a kernel that
a later change adds counts as the port's with no edit here."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SPAN = "portbench/"
TORCH_MARKS = ("at::", "at_cuda_detail", "c10::", "cub::", "CUB", "cublas", "nccl")


def kind_of(name: str) -> str:
    """'d2h', 'copy' (other memcpys), 'memset', 'torch' or 'port'."""
    if name.startswith("Memcpy"):
        return "d2h" if "DtoH" in name else "copy"
    if name.startswith("Memset"):
        return "memset"
    if any(m in name for m in TORCH_MARKS):
        return "torch"
    return "port"


@dataclass
class DeviceEvent:
    name: str
    card: int
    start_ns: int
    dur_ns: int


@dataclass
class Span:
    template: str
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    """What the readers read, over the traced window's queries."""

    queries: int = 0
    window_s: float = 0.0
    cards: list = field(default_factory=list)
    events: list = field(default_factory=list)  # DeviceEvent
    spans: list = field(default_factory=list)  # Span
    plan_s: float = 0.0  # parse + plan seconds, summed
    least_bytes: float = 0.0  # summed
    counters: dict = field(default_factory=dict)  # the port's counters, deltas over the window
    hbm_bytes_per_s: float = 0.0  # per card, 0 where the table has no figure

    def busy_s(self) -> dict[int, float]:
        """Seconds of device activity by card: the union of its events."""
        out = {c: 0.0 for c in self.cards}
        by_card = defaultdict(list)
        for e in self.events:
            by_card[e.card].append((e.start_ns, e.start_ns + e.dur_ns))
        for card, iv in by_card.items():
            out[card] = sum(b - a for a, b in _union(iv)) / 1e9
        return out

    def time_s(self, kinds: tuple[str, ...]) -> float:
        return sum(e.dur_ns for e in self.events if kind_of(e.name) in kinds) / 1e9

    def count(self, kinds: tuple[str, ...]) -> int:
        return sum(1 for e in self.events if kind_of(e.name) in kinds)

    def template_at(self, t_ns: int) -> str:
        starts = [s.start_ns for s in self.spans]
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and self.spans[i].start_ns <= t_ns <= self.spans[i].end_ns:
            return self.spans[i].template
        return "between queries"

    def device_ops(self, top: int = 10) -> list:
        tot = defaultdict(int)
        for e in self.events:
            tot[e.name[:160]] += e.dur_ns
        return [[n, v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches in which a card ran nothing, by the
        template that was running then."""
        if not self.spans:
            return []
        w0, w1 = self.spans[0].start_ns, self.spans[-1].end_ns
        gaps = []
        by_card = defaultdict(list)
        for e in self.events:
            by_card[e.card].append((e.start_ns, e.start_ns + e.dur_ns))
        for card in self.cards:
            edge = w0
            for a, b in _union(by_card.get(card, [])) + [(w1, w1)]:
                if a > edge:
                    label = self.template_at((edge + a) // 2)
                    gaps.append((a - edge, label if len(self.cards) == 1 else f"{label} cuda:{card}"))
                edge = max(edge, b)
        gaps.sort(key=lambda g: -g[0])
        return [[label, ns / 1e9] for ns, label in gaps[:top]]

    def kernel_counts(self) -> dict[str, dict[str, int]]:
        """Per template, the trace's launches of each kernel the port's
        counters name."""
        names = [k for k in self.counters if k.endswith("_kernel")]
        out = defaultdict(lambda: defaultdict(int))
        for e in self.events:
            for k in names:
                if k in e.name:
                    out[self.template_at(e.start_ns)][k] += 1
        return out


def _union(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_profile(prof) -> tuple[list[DeviceEvent], list[Span]]:
    """Device events and the harness's spans from a finished
    `torch.profiler.profile`, read from its raw kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if name.startswith(SPAN):
            if e.device_type() != cuda:
                spans.append(Span(name[len(SPAN):], start, start + dur))
            continue
        if e.device_type() == cuda:
            events.append(DeviceEvent(name, e.device_index(), start, dur))
    spans.sort(key=lambda s: s.start_ns)
    return events, spans
