"""Subqueries, CTEs and INTERSECT / EXCEPT: the JAX package vs the torch
port on the CPU.

The SQL of tests/test_subqueries.py (IN / NOT IN / EXISTS / scalar
subqueries become LEFT or INNER joins in the planner) and the statements
of tests/test_cte_setops.py that need neither UNION nor a window (CTEs,
INTERSECT and EXCEPT without ALL, which become Aggregate + Join) run
through `datafusion_tpu.ExecutionContext()` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
columns, and `result_str()` must match byte for byte, row order
included; float SUM/AVG columns at rtol=1e-12.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from test_torch_join import compare, register_both

T = {
    "k": np.array([1, 2, 3, 4, 5, 6], np.int32),
    "g": ["a", "a", "b", "b", "c", "c"],
    "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0], np.float64),
}


@pytest.fixture(scope="module")
def contexts():
    r, p = ref.ExecutionContext(), port.ExecutionContext(device="cpu")
    register_both(r, p, {
        "t": T,
        "s": {"k": np.array([2, 4, 4, 9], np.int32), "tag": ["x", "y", "y", "z"]},
        "labels": {"l": ["a", "c", "q"]},
        # make_exists_ctx's tables
        "te": {"k": np.array([1, 2, 3, 4], np.int32), "v": np.array([10.0, 20.0, 30.0, 40.0])},
        "se": {"k": np.array([2, 4, 4], np.int32), "w": np.array([1.0, 2.0, 99.0])},
        "th": {"k": np.array([1, 1, 2, 2, 3], np.int64), "v": [10.0, 10.0, 1.0, 1.0, 100.0]},
        "tg": {"g": np.array([1, 1, 1, 2, 2, 3], np.int64), "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])},
    })
    return r, p


CASES = [
    # IN lists, BETWEEN, derived tables
    ("SELECT k FROM t WHERE k IN (2, 4, 9)", ()),
    ("SELECT k FROM t WHERE k NOT IN (1, 2, 3, 4)", ()),
    ("SELECT k FROM t WHERE g IN ('a', 'c') ORDER BY k", ()),
    ("SELECT k FROM t WHERE v BETWEEN 20 AND 40", ()),
    ("SELECT k FROM t WHERE k NOT BETWEEN 2 AND 5", ()),
    ("SELECT k FROM t WHERE v BETWEEN 20 AND 40 AND k > 2", ()),
    ("SELECT big_v FROM (SELECT k, v * 2 AS big_v FROM t WHERE k > 3) sub ORDER BY big_v", ()),
    ("SELECT g, total FROM (SELECT g, SUM(v) AS total FROM t GROUP BY g) agg WHERE total > 40 ORDER BY g", (1,)),
    ("SELECT t.k, agg.total FROM t JOIN (SELECT g, SUM(v) AS total FROM t GROUP BY g) AS agg ON t.g = agg.g "
     "WHERE t.k < 3 ORDER BY k", (1,)),
    ("SELECT t.k, agg.total FROM t JOIN (SELECT g, SUM(v) AS total FROM t GROUP BY g) AS agg ON t.g = agg.g", (1,)),
    ("SELECT g, COUNT(v) FROM tg GROUP BY g HAVING COUNT(v) > 1", ()),
    ("SELECT g, COUNT(v) FROM tg GROUP BY g HAVING SUM(v) > 5.0", ()),
    ("SELECT g * 10 AS bucket, COUNT(v) FROM tg GROUP BY bucket", ()),
    ("SELECT g FROM t GROUP BY g ORDER BY g", ()),
    ("SELECT g FROM t GROUP BY g HAVING SUM(v) > 40 ORDER BY g", ()),
    # IN / NOT IN (SELECT ...): semi- and anti-joins
    ("SELECT k FROM t WHERE k IN (SELECT k FROM s) ORDER BY k", ()),
    ("SELECT k FROM t WHERE k IN (SELECT k FROM s)", ()),
    ("SELECT k FROM t WHERE k NOT IN (SELECT k FROM s) ORDER BY k", ()),
    ("SELECT k FROM t WHERE k NOT IN (SELECT k FROM s)", ()),
    ("SELECT k FROM t WHERE k IN (SELECT k FROM s) AND v > 25 ORDER BY k", ()),
    ("SELECT k FROM t WHERE v > 25 AND k NOT IN (SELECT k FROM s WHERE tag = 'y') ORDER BY k", ()),
    ("SELECT k FROM t WHERE g IN (SELECT tag FROM s) ORDER BY k", ()),
    ("SELECT k FROM t WHERE g IN (SELECT l FROM labels) ORDER BY k", ()),
    ("SELECT k FROM t WHERE g IN (SELECT l FROM labels)", ()),
    ("SELECT k FROM t WHERE g IN (SELECT g FROM t GROUP BY g HAVING SUM(v) > 40) ORDER BY k", ()),
    # scalar subqueries: LEFT cross joins (empty subquery -> NULL)
    ("SELECT k FROM t WHERE v > (SELECT AVG(v) FROM t) ORDER BY k", ()),
    ("SELECT k, (SELECT MAX(k) FROM s) FROM t WHERE k < 3 ORDER BY k", ()),
    ("SELECT k, v - (SELECT MIN(v) FROM t) AS d FROM t WHERE k > 4 ORDER BY k", ()),
    ("SELECT k FROM t WHERE v > (SELECT AVG(v) FROM t WHERE k > 100)", ()),
    ("SELECT k, (SELECT MAX(v) FROM t WHERE k > 100) FROM t WHERE k = 1", ()),
    ("SELECT k, v - (SELECT AVG(v) FROM t) AS d FROM t WHERE v > (SELECT MIN(v) FROM t) ORDER BY k", ()),
    # EXISTS / NOT EXISTS, correlated and not
    ("SELECT k FROM te WHERE EXISTS (SELECT 1 FROM se WHERE se.k = te.k) ORDER BY k", ()),
    ("SELECT k FROM te WHERE NOT EXISTS (SELECT 1 FROM se WHERE se.k = te.k) ORDER BY k", ()),
    ("SELECT k FROM te WHERE NOT EXISTS (SELECT 1 FROM se WHERE se.k = te.k)", ()),
    ("SELECT k FROM te WHERE EXISTS (SELECT 1 FROM se WHERE se.k = te.k AND se.w > 50) ORDER BY k", ()),
    ("SELECT k FROM te WHERE EXISTS (SELECT 1 FROM se WHERE se.w > 100)", ()),
    ("SELECT k FROM te WHERE NOT EXISTS (SELECT 1 FROM se WHERE se.w > 100) ORDER BY k", ()),
    ("SELECT k FROM te WHERE EXISTS (SELECT 1 FROM se WHERE se.w > 50) ORDER BY k", ()),
    ("SELECT k FROM te WHERE v > 15 AND EXISTS (SELECT 1 FROM se WHERE se.k = te.k) ORDER BY k", ()),
    # correlated scalar subqueries: GROUP BY + LEFT join
    ("SELECT k, (SELECT MAX(w) FROM se WHERE se.k = te.k) FROM te ORDER BY k", ()),
    ("SELECT k, (SELECT MAX(w) FROM se WHERE se.k = te.k) FROM te", ()),
    ("SELECT k FROM te WHERE v > (SELECT SUM(w) FROM se WHERE se.k = te.k) ORDER BY k", ()),
    ("SELECT k, (SELECT COUNT(w) FROM se WHERE se.k = te.k AND se.w > 1.5) FROM te ORDER BY k", ()),
    ("SELECT k, SUM(v) AS s FROM th GROUP BY k HAVING SUM(v) > (SELECT AVG(v) FROM th) ORDER BY k", (1,)),
    # CTEs (tests/test_cte_setops.py)
    ("WITH big AS (SELECT k, v FROM t WHERE v > 30) SELECT k FROM big ORDER BY k", ()),
    ("WITH a AS (SELECT k FROM t WHERE k < 4), b AS (SELECT k FROM a WHERE k > 1) SELECT k FROM b ORDER BY k", ()),
    ("WITH agg AS (SELECT g, SUM(v) AS total FROM t GROUP BY g) SELECT t.k, agg.total FROM t JOIN agg "
     "ON t.g = agg.g WHERE t.k < 3 ORDER BY k", (1,)),
    ("WITH s AS (SELECT k, g FROM t WHERE k < 5) SELECT x.k, y.k FROM s AS x JOIN s AS y ON x.g = y.g "
     "WHERE x.k < y.k ORDER BY 1", ()),
    ("WITH t AS (SELECT k FROM t WHERE k = 3) SELECT k FROM t", ()),
    ("SELECT k FROM (WITH w AS (SELECT k FROM t WHERE k > 4) SELECT k FROM w) d ORDER BY k", ()),
    ("SELECT k FROM t WHERE k IN (WITH w AS (SELECT k FROM t WHERE k < 3) SELECT k FROM w) ORDER BY k", ()),
    # INTERSECT / EXCEPT (distinct): Aggregate + INNER / LEFT join
    ("SELECT g FROM t WHERE k < 5 INTERSECT SELECT g FROM t WHERE k > 2", ()),
    ("SELECT g FROM t EXCEPT SELECT g FROM t WHERE k > 2", ()),
    ("SELECT g FROM t INTERSECT SELECT g FROM t", ()),
    ("SELECT k FROM t WHERE k < 3 INTERSECT SELECT k + 1 FROM t", ()),
    ("WITH lo AS (SELECT k FROM t WHERE k <= 3) SELECT k FROM t EXCEPT SELECT k FROM lo", ()),
    ("SELECT k, g FROM t INTERSECT SELECT k, g FROM t WHERE v > 20", ()),
]


@pytest.mark.parametrize("sql,tol", CASES, ids=[c[0] for c in CASES])
def test_subquery_parity(contexts, sql, tol):
    r, p = contexts
    compare(p.sql(sql).result_str(), r.sql(sql).result_str(), tol)


@pytest.mark.parametrize(
    "sql,match",
    [
        ("SELECT k FROM t WHERE k > 3 OR k IN (SELECT k FROM s)", "top-level AND conjunct"),
        ("SELECT k FROM t WHERE k IN (SELECT k, tag FROM s)", "exactly one column"),
        ("SELECT k FROM t WHERE k + 1 IN (SELECT k FROM s)", "plain column"),
        ("SELECT k FROM t WHERE v > (SELECT k, tag FROM s)", "exactly one column"),
        ("SELECT k FROM te WHERE EXISTS (SELECT 1 FROM se WHERE se.k > te.k)", "inner-only or"),
        ("SELECT k, (SELECT w FROM se WHERE se.k = te.k) FROM te", "aggregate"),
    ],
)
def test_subquery_errors(contexts, sql, match):
    _, p = contexts
    with pytest.raises(port.PlanError, match=match):
        p.sql(sql)
