"""Kernel K1 (fused scan/filter/project) on the CPU: the port's program
compiler plus the plain evaluator, against the JAX package's fused stage
run in Pallas interpret mode (DFTPU_PALLAS=1, as tests/test_fused_stage.py
does). Same SQL over the same table; `result_str()` must match byte for
byte — integer, bool and NULL results are exact, and float results are
exact too: the same IEEE operation on the same inputs."""

import os

import numpy as np
import pytest
import torch

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu_torch.ops.pallas import fused_stage as fs

FIELDS = [
    ("k", "Int32", False), ("lat", "Float64", False), ("lng", "Float64", False),
    ("nv", "Float64", True), ("j", "Int32", True), ("s", "Utf8", False),
    ("f", "Float32", False), ("i8", "Int8", False), ("u16", "UInt16", False),
]


def _arrays(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.integers(0, 50, n).astype(np.int32),
        rng.random(n) * 40 + 30,
        rng.random(n) * 360 - 180,
        rng.random(n) * 10,
        rng.integers(-4, 5, n).astype(np.int32),  # zeros: integer division by zero
        list(rng.choice(["ant", "bee", "cat", "dog"], n)),
        (rng.standard_normal(n) * 100).astype(np.float32),
        rng.integers(-128, 128, n).astype(np.int8),
        rng.integers(0, 65536, n).astype(np.uint16),
    ]
    validity = [None, None, None, rng.random(n) > 0.2, rng.random(n) > 0.1, None, None, None, None]
    return arrays, validity


def _ctx(mod, **kw):
    schema = mod.Schema([mod.Field(n, mod.DataType[t], nl) for n, t, nl in FIELDS])
    arrays, validity = _arrays()
    ctx = mod.ExecutionContext(**kw)
    ctx.register_table("t", mod.Table.from_arrays(schema, arrays, validity=validity, **kw))
    return ctx


@pytest.fixture(scope="module")
def ctxs():
    return _ctx(ref), _ctx(port, device="cpu")


QUERIES = [
    # the c1 shape
    "SELECT k, lat, lng, lat + lng FROM t WHERE lat > 51.0 AND lat < 53",
    "SELECT k, lat * 2 FROM t",
    "SELECT k, CASE WHEN lat > 50 THEN lat ELSE lng END, CAST(lat AS INT) FROM t WHERE lng < 0",
    "SELECT CASE WHEN j > 0 THEN k WHEN j < 0 THEN -k END, CAST(k AS DOUBLE) / 3 FROM t",
    "SELECT k, nv * 2 FROM t WHERE nv IS NOT NULL AND lat > 55",
    "SELECT k, nv + lat, nv IS NULL, j IS NOT NULL FROM t WHERE lat > 65",
    "SELECT lat FROM t WHERE k IN (3, 7, 11)",
    # integer /0 and %0 give NULL; negative operands truncate
    "SELECT k / j, k % j, k / 0, (k - 25) / 7, (k - 25) % 7, (k - 25) / -7, (k - 25) % -7 FROM t",
    "SELECT j / (k - k), lat / 0.0, lng % 3.5 FROM t WHERE k < 5",
    # Utf8 literal comparisons on dictionary codes (present and absent)
    "SELECT k FROM t WHERE s = 'cat'",
    "SELECT k, lat FROM t WHERE s < 'bee' OR s >= 'dog'",
    "SELECT k FROM t WHERE s <> 'zzz' AND s > 'b'",
    "SELECT k FROM t WHERE s = 'zzz'",
    # f32 arithmetic, narrow-int and unsigned wrap, CAST chains
    "SELECT f * 2 + f, f - 1.5, CAST(f AS INT), CAST(k AS FLOAT) FROM t",
    "SELECT i8 + i8, i8 * i8, u16 + u16, CAST(lat * 1000 AS SMALLINT) FROM t",
    "SELECT CAST(lat AS BIGINT) * 3, CAST(k AS BOOLEAN) FROM t WHERE NOT (k > 10)",
    # math functions that are exact on both sides
    "SELECT abs(lng), floor(lng), ceil(lng), sign(lng), degrees(lat) FROM t",
]


def _jax_sql(ctx, sql):
    os.environ["DFTPU_PALLAS"] = "1"  # JAX's fused stage in interpret mode
    try:
        return ctx.sql(sql).result_str(), ctx.sql(f"EXPLAIN VERBOSE {sql}").result_str()
    finally:
        os.environ.pop("DFTPU_PALLAS", None)


@pytest.mark.parametrize("sql", QUERIES)
def test_fused_stage_parity(ctxs, sql):
    r, p = ctxs
    expected, jax_notes = _jax_sql(r, sql)
    notes = p.sql(f"EXPLAIN VERBOSE {sql}").result_str()
    assert "fused CUDA stage" in notes, notes
    assert "fused pallas stage" in jax_notes, jax_notes
    assert p.sql(sql).result_str() == expected


@pytest.mark.parametrize(
    "sql,fused",
    [
        ("SELECT k FROM t WHERE s LIKE 'c%'", False),  # a dictionary LUT: declined at plan time
        ("SELECT upper(s), k + 1 FROM t", False),
        ("SELECT k + 1 FROM t WHERE s = s", True),  # one dictionary: a code compare
    ],
)
def test_fused_stage_routing_is_decided_at_plan_time(ctxs, sql, fused):
    r, p = ctxs
    notes = p.sql(f"EXPLAIN VERBOSE {sql}").result_str()
    assert ("fused CUDA stage" in notes) == fused, notes
    assert p.sql(sql).result_str() == r.sql(sql).result_str()


def test_program_register_limit_declines():
    """A program past the kernel's register file is declined with the
    reason, and the query still runs on the plain projection path."""
    p = _ctx(port, device="cpu")
    expr = " + ".join(["lat"] * (fs.MAX_REGS + 2))
    notes = p.sql(f"EXPLAIN VERBOSE SELECT {expr} FROM t").result_str()
    assert "fused stage declined (more than" in notes, notes
    assert len(p.sql(f"SELECT {expr} FROM t").result_str().splitlines()) == 3000


def test_evaluate_plain_matches_expr_eval():
    """The plain K1 evaluator and the plain projection path agree on one
    program over NULLs, ÷0, CASE and CAST."""
    from datafusion_tpu_torch.ops.expr_eval import compile_expr

    p = _ctx(port, device="cpu")
    plan = p.plan("SELECT CASE WHEN j > 0 THEN k / j ELSE k % (j - j) END, CAST(nv AS INT) + j FROM t WHERE nv < 5")
    proj, sel_node = plan, plan.input
    scan_schema = sel_node.input.schema
    table = p.table("t")
    cols = [(c.data, c.validity) for c in table.columns]
    program = fs.compile_program(
        scan_schema, [c.dictionary for c in table.columns], [c.validity is not None for c in table.columns],
        sel_node.expr, list(proj.exprs),
    )
    sel, outs = fs.run_fused(
        program, [cols[i][0] for i in program.inputs], [cols[i][1] for i in program.inputs],
        table.num_rows, "cpu",
    )
    pred = compile_expr(sel_node.expr, scan_schema, [None] * len(cols), device="cpu")
    pd, pv = pred.fn(cols)
    assert torch.equal(sel, pd & pv)
    for (d, v), e in zip(outs, proj.exprs):
        ed, ev = compile_expr(e, scan_schema, [None] * len(cols), device="cpu").fn(cols)
        ev = torch.ones_like(d, dtype=torch.bool) if ev is None else ev.expand(d.shape)
        vv = torch.ones_like(d, dtype=torch.bool) if v is None else v
        assert torch.equal(vv, ev)
        assert torch.equal(d[vv], ed.expand(d.shape)[vv])


def test_round_trunc_divide_exactly(ctxs):
    """ROUND/TRUNC(x, n) divide by 10^n exactly. The JAX package differs
    here in the last bit: XLA rewrites its division by the literal 10^n
    into a multiplication by the reciprocal (a reference fault, ROADMAP
    Queue 3), so the port is held to the formula in numpy instead."""
    _, p = ctxs
    got = p.sql("SELECT lat, round(lat, 2), trunc(lng, 1), round(lng) FROM t WHERE k < 3").result_str()
    for line in got.splitlines():
        lat, r2, t1, r0 = (float(x) for x in line.split("\t")[:1] + line.split("\t")[1:])
        y = lat * 100.0
        assert r2 == np.sign(y) * np.floor(abs(y) + 0.5) / 100.0
    arrays, _ = _arrays()
    lng = arrays[2][arrays[0] < 3]
    col = [float(x.split("\t")[2]) for x in got.splitlines()]
    np.testing.assert_array_equal(col, np.trunc(lng * 10.0) / 10.0)


def test_sqrt_within_one_ulp(ctxs):
    """sqrt is correctly rounded in XLA and in CUDA, but torch's CPU
    kernel is not for about 1% of f64 inputs, so on the CPU the plain
    version is held to one ulp of the JAX package."""
    r, p = ctxs
    sql = "SELECT sqrt(lat) FROM t"
    got = np.array(p.sql(sql).result_str().split(), dtype=np.float64)
    expected = np.array(_jax_sql(r, sql)[0].split(), dtype=np.float64)
    np.testing.assert_allclose(got, expected, rtol=2.3e-16, atol=0)
