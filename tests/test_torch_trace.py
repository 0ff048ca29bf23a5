"""The port's program spans (datafusion_tpu_torch/utils/trace.py) on the
CPU: none is made while no profiler records; under a profiler a query's
spans nest as `dft.sql` > `dft.node.*` > `dft.kernel.*`, with
`dft.to_host` inside `dft.materialize` inside `dft.sql`; a mesh of two logical cards records its
merge and collectives once per query, not once per shard; a cached plan
records no lowering; the collector's pauses show as `dft.gc`."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import datafusion_tpu_torch as dft
from datafusion_tpu_torch.utils import trace

GROUP_BY = "SELECT k, SUM(v), COUNT(*) FROM t GROUP BY k"
TOP_K = "SELECT k, v FROM t WHERE v > 3 ORDER BY v LIMIT 5"


def _table():
    return dft.Table.from_pydict({"k": np.arange(2000, dtype=np.int32) % 37, "v": np.arange(2000) / 8}, device="cpu")


@pytest.fixture(scope="module")
def ctx():
    c = dft.ExecutionContext(device="cpu")
    c.register_table("t", _table())
    return c


def _spans(fn) -> list[tuple[str, int, int]]:
    """(name, start, end) of every dft.* span recorded while `fn` runs."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in p.profiler.kineto_results.events()
           if e.name().startswith("dft.")]
    return sorted(evs, key=lambda e: (e[1], -e[2]))


def _inside(inner, outers) -> bool:
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def test_no_span_without_a_profiler(ctx, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("dft.a") is trace.span("dft.b")
    for q in (GROUP_BY, TOP_K):
        assert ctx.sql(q).num_rows > 0


@pytest.mark.parametrize("sql, node, kernel", [
    (GROUP_BY, "dft.node.Aggregate.dense", "dft.kernel.K2"),
    (TOP_K, "dft.node.Limit.topk", "dft.kernel.K1"),
])
def test_spans_nest_under_a_profiler(ctx, sql, node, kernel):
    ctx.sql(sql)  # lowered once before the profiled run
    evs = _spans(lambda: ctx.sql(sql))
    by = {}
    for e in evs:
        by.setdefault(e[0], []).append(e)
    assert len(by["dft.sql"]) == 1 and len(by[node]) == 1, sorted(by)
    assert {"dft.parse", "dft.plan", "dft.optimize", "dft.materialize", "dft.to_host", "dft.result", kernel} <= set(by)
    assert "dft.lower" not in by
    nodes = [e for e in evs if e[0].startswith("dft.node.")]
    for e in evs:
        if e[0] != "dft.sql" and e[0] != "dft.gc":
            assert _inside(e, by["dft.sql"]), e
        if e[0].startswith("dft.kernel."):
            assert _inside(e, nodes), e
    assert _inside(by[kernel][0], by[node]) and _inside(by["dft.to_host"][0], by["dft.materialize"])


def test_mesh_records_merge_and_collectives_once(ctx):
    m = dft.ExecutionContext(mesh=dft.make_mesh(4, devices=("cpu", "cpu")))
    m.register_table("t", ctx.table("t"))
    sql = "SELECT k, v FROM t WHERE v > 3 ORDER BY v"
    want = m.sql(sql).result_str()
    evs = _spans(lambda: m.sql(sql))
    names = [e[0] for e in evs]
    assert "dft.merge" in names and "dft.node.Sort.sample" in names
    assert any(n.startswith("dft.collective.") for n in names) and "dft.kernel.K5" in names
    assert names.count("dft.node.Projection") == 1 and names.count("dft.kernel.K1") == 4  # one K1 call a shard
    assert m.sql(sql).result_str() == want


def test_cached_plan_records_no_lowering():
    c = dft.ExecutionContext(device="cpu")
    c.register_table("t", _table())
    assert "dft.lower" in [e[0] for e in _spans(lambda: c.sql(GROUP_BY))]
    assert "dft.lower" not in [e[0] for e in _spans(lambda: c.sql(GROUP_BY))]


def test_collector_pause_is_a_span():
    assert "dft.gc" in [e[0] for e in _spans(gc.collect)]
    assert not trace._gc_open
