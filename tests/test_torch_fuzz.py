"""Seeded random-query parity through the port: the generator of
tests/test_fuzz_parity.py (its tables, predicates and 28 query shapes,
copied here at smaller table sizes), at two seeds. For each generated
statement the port on one CPU device, the port on an 8-shard CPU mesh
and the JAX package on one device must return the same rows, compared
as that file compares them: sorted rows, floats rounded to 4 places,
non-finite floats as text."""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port

SEEDS = (0, 1)


def _tables(rng):
    n = int(rng.integers(200, 600))
    fact = {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "g": rng.integers(-5, 5, n).astype(np.int64),
        "v": (rng.random(n) * 200 - 100).round(3),
        "s": np.array([f"c{int(x) % 7}" for x in rng.integers(0, 100, n)], dtype=object),
    }
    m = int(rng.integers(20, 60))
    dim = {"pk": np.arange(m, dtype=np.int32), "w": (rng.random(m) * 10).round(3)}
    return fact, dim


PREDICATES = [
    "v > 0",
    "v BETWEEN -50 AND 50",
    "k IN (1, 3, 5, 7)",
    "s = 'c3' OR v < -80",
    "NOT (g = 0) AND v > -90",
    "CASE WHEN g > 0 THEN TRUE ELSE v > 0 END",
]

QUERIES = [
    "SELECT k, v, v * 2 + 1 FROM fact WHERE {p}",
    "SELECT g, MIN(v), MAX(v), COUNT(v), SUM(v), AVG(v) FROM fact WHERE {p} GROUP BY g",
    "SELECT s, COUNT(v), MIN(k) FROM fact WHERE {p} GROUP BY s HAVING COUNT(v) > 3",
    "SELECT k, CASE WHEN v > 0 THEN 1 ELSE 0 END AS pos FROM fact WHERE {p} ORDER BY k, pos LIMIT 50",
    "SELECT fact.k, SUM(dim.w) FROM fact JOIN dim ON fact.k = dim.pk WHERE {p} GROUP BY fact.k",
    "SELECT fact.g, COUNT(fact.v) FROM fact LEFT JOIN dim ON fact.k = dim.pk WHERE {p} GROUP BY fact.g",
    "SELECT v FROM fact WHERE {p} ORDER BY v DESC LIMIT 20",
    "SELECT g, COUNT(DISTINCT k) FROM fact WHERE {p} GROUP BY g",
    "SELECT k FROM fact WHERE {p} UNION SELECT pk FROM dim WHERE pk < 10",
    "SELECT COALESCE(NULLIF(g, 0), -99) AS c, COUNT(v) FROM fact WHERE {p} GROUP BY c",
    "SELECT fact.k, dim.w FROM fact FULL JOIN dim ON fact.k = dim.pk WHERE {p}",
    "SELECT k, v FROM fact WHERE k IN (SELECT pk FROM dim WHERE w > 3) AND ({p})",
    "SELECT k FROM fact WHERE NOT EXISTS (SELECT 1 FROM dim WHERE dim.pk = fact.k) AND ({p})",
    "SELECT k, v - (SELECT AVG(v) FROM fact) AS d FROM fact WHERE {p} ORDER BY k, d LIMIT 40",
    "SELECT k, (SELECT MAX(w) FROM dim WHERE dim.pk = fact.k) AS mw FROM fact WHERE {p} ORDER BY k, mw LIMIT 40",
    "SELECT g, k, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, k) AS rn FROM fact WHERE {p} ORDER BY g, k, rn LIMIT 60",
    "WITH hot AS (SELECT k, v FROM fact WHERE {p}) SELECT k, COUNT(v) FROM hot GROUP BY k",
    "SELECT k FROM fact WHERE {p} INTERSECT SELECT pk FROM dim",
    "SELECT k FROM fact WHERE {p} EXCEPT ALL SELECT pk FROM dim WHERE pk < 20",
    "SELECT g, s, SUM(v) FROM fact WHERE {p} GROUP BY ROLLUP(g, s)",
    "SELECT g, k, SUM(v) OVER (PARTITION BY g ORDER BY k, v ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS w FROM fact "
    "WHERE {p} ORDER BY g, k, w LIMIT 60",
    "SELECT g, STDDEV_POP(v), VAR_POP(v) FROM fact WHERE {p} GROUP BY g",
    "SELECT CASE WHEN v > 0 THEN 'pos' WHEN v < -50 THEN s ELSE 'neg' END AS b, COUNT(v) FROM fact WHERE {p} GROUP BY b",
    "SELECT k FROM fact WHERE v IS DISTINCT FROM 0 AND ({p}) ORDER BY k LIMIT 30 OFFSET 5",
    "SELECT s, g, RANK() OVER (ORDER BY SUM(v) DESC) FROM fact WHERE {p} GROUP BY s, g",
    "SELECT g, SUM(v) OVER (PARTITION BY g) AS sv, COUNT(*) OVER (PARTITION BY g) AS c FROM fact WHERE {p} "
    "ORDER BY g, sv LIMIT 60",
    "SELECT UPPER(s) AS u, COUNT(v) FROM fact WHERE {p} GROUP BY u",
    "SELECT s, LENGTH(s) FROM fact WHERE ({p}) AND SUBSTR(s, 1, 1) = 'c' ORDER BY s, 2 LIMIT 30",
]


def _canonical(rows):
    """tests/test_fuzz_parity.py's row canonicalization."""
    out = []
    for row in rows:
        cells = []
        for v in row.values():
            if isinstance(v, float) or (hasattr(v, "dtype") and np.issubdtype(np.asarray(v).dtype, np.floating)):
                f = float(v)
                cells.append(repr(f) if not np.isfinite(f) else round(f, 4))
            elif v is None:
                cells.append(None)
            else:
                cells.append(v if isinstance(v, str) else int(v))
        out.append(tuple(cells))
    return sorted(out, key=repr)


def _cases():
    """(seed, statement) in the generator's order: the tables first, then
    one predicate draw per query shape, as tests/test_fuzz_parity.py draws."""
    cases = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        _tables(rng)
        for i, qt in enumerate(QUERIES):
            cases.append((seed, i, qt.format(p=PREDICATES[int(rng.integers(0, len(PREDICATES)))])))
    return cases


@pytest.fixture(scope="module")
def contexts():
    """seed -> (JAX on one device, port on one CPU device, port on 8 CPU
    shards) over the seed's tables, each made once."""
    made = {}

    def of(seed):
        if seed not in made:
            fact, dim = _tables(np.random.default_rng(seed))
            ctxs = (ref.ExecutionContext(), port.ExecutionContext(device="cpu"),
                    port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")))
            for name, cols in (("fact", fact), ("dim", dim)):
                ctxs[0].register_table(name, ref.Table.from_pydict(dict(cols)))
                for c in ctxs[1:]:
                    c.register_table(name, port.Table.from_pydict(dict(cols), device="cpu"))
            made[seed] = ctxs
        return made[seed]

    return of


@pytest.mark.parametrize("seed,i,sql", _cases(), ids=[f"s{s}-q{i}" for s, i, _ in _cases()])
def test_fuzz_port_one_device_mesh_and_jax(contexts, seed, i, sql):
    jax_ctx, one, shards = contexts(seed)
    want = _canonical(jax_ctx.sql(sql).to_pylist())
    assert _canonical(one.sql(sql).to_pylist()) == want, f"port on one device vs JAX: {sql}"
    assert _canonical(shards.sql(sql).to_pylist()) == want, f"port mesh vs JAX: {sql}"
