"""TPC-H's 22 shapes (benchmarks/tpch.py) through the torch port on the CPU.

At `gen_tables(0.003, seed=7)`, as tests/test_tpch.py runs the JAX
package. Each query's port result is held to `verify` (the pandas
reference, its own rel 2e-3; it skips date columns) and to the JAX
package's result of the same SQL over the same tables: row count and
order, strings, integers and dates exact; Float64 cells at rtol 1e-12;
Float32 cells at rtol 1e-5, because the JAX package sums Float32 columns
in f32 and the port in f64 (ROADMAP Queue 3), about n * 2^-24 apart for
a sum of n terms. q1 on the port's mesh of 8 shards equals one card at
rtol 1e-12.
"""

import os
import sys

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port

ALL_QUERIES = [
    "q1", "q2ish", "q3", "q4ish", "q5ish", "q6", "q7ish", "q8ish",
    "q9ish", "q10ish", "q11ish", "q12ish", "q13ish", "q14ish", "q15ish",
    "q16ish", "q17ish", "q18ish", "q19ish", "q20ish", "q21ish", "q22ish",
]
NAMES = ("lineitem", "orders", "customer", "part")


@pytest.fixture(scope="module")
def tpch():
    """benchmarks/tpch.py, imported after the JAX package (its import sets
    DFTPU_X64=0 when unset, which the JAX package reads at its own import;
    the variable is put back as it was)."""
    bench = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
    sys.path.insert(0, bench)
    old = os.environ.get("DFTPU_X64")
    try:
        import tpch
    finally:
        sys.path.remove(bench)
        if old is None:
            os.environ.pop("DFTPU_X64", None)
        else:
            os.environ["DFTPU_X64"] = old
    return tpch


@pytest.fixture(scope="module")
def contexts(tpch):
    tables = tpch.gen_tables(0.003, seed=7)
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, cols in zip(NAMES, tables):
        r.register_table(name, ref.Table.from_pydict(cols))
        p.register_table(name, port.Table.from_pydict(cols, device="cpu"))
    return tables, r, p


def assert_same(got, want, f32_rtol=1e-5):
    """Port result `got` against `want`: shapes, order, validity and
    non-float cells exact; floats at rtol 1e-12 (Float32 columns at
    `f32_rtol`)."""
    assert (got.num_rows, got.num_columns) == (want.num_rows, want.num_columns)
    for j in range(got.num_columns):
        dt = got.schema.field(j).dtype
        assert dt.value == want.schema.field(j).dtype.value
        a, b = got.column_values(j), want.column_values(j)
        assert [x is None for x in a] == [y is None for y in b]
        if dt.value in ("Float32", "Float64"):
            rtol = f32_rtol if dt.value == "Float32" else 1e-12
            live = [x is not None for x in a]
            assert np.allclose(np.array(a)[live].astype(float), np.array(b)[live].astype(float), rtol=rtol, atol=0), j
        else:
            assert a == b, j


@pytest.mark.parametrize("name", ALL_QUERIES)
def test_tpch_query_matches_verify_and_jax(name, tpch, contexts):
    tables, r, p = contexts
    res = p.sql(tpch.QUERIES[name])
    tpch.verify(name, res, *tables)
    assert_same(res, r.sql(tpch.QUERIES[name]))


def test_tpch_q1_mesh_matches_one_card(tpch, contexts):
    _, _, p = contexts
    m = port.ExecutionContext(mesh=port.make_mesh(8, device="cpu"))
    m.register_table("lineitem", p.table("lineitem"))
    sql = tpch.QUERIES["q1"]
    assert "per shard" in m.sql(f"EXPLAIN VERBOSE {sql}").result_str()
    assert_same(m.sql(sql), p.sql(sql), f32_rtol=1e-12)


def test_tpch_year_queries_run_date_functions(tpch, contexts):
    """q7ish-q9ish group by EXTRACT(YEAR FROM o_orderdate) over joins: the
    key is a torch op over the join's output (no fused stage there)."""
    _, _, p = contexts
    for name in ("q7ish", "q8ish", "q9ish"):
        txt = p.sql(f"EXPLAIN VERBOSE {tpch.QUERIES[name]}").result_str()
        assert "year(" in txt and "co-sort + segmented reduce" in txt, name
