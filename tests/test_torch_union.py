"""UNION [ALL], grouping sets and set operations: the JAX package (the
reference) vs the torch port on the CPU.

The SQL of tests/test_case_union.py, tests/test_cte_setops.py and
tests/test_grouping_sets.py (INSERT aside: the port has no DML yet) runs
through `datafusion_tpu.ExecutionContext()` and
`datafusion_tpu_torch.ExecutionContext(device="cpu")` over the same
columns, and `result_str()` must match byte for byte, row order
included: UNION ALL concatenates its children in order, as the JAX
package does. INTERSECT / EXCEPT ALL number their rows with ROW_NUMBER
windows before a join. Also: the merge of differing dictionaries, a
0-row child's empty vocabulary, and the Utf8/numeric mix, which both
packages refuse with ExecutionError.
"""

import numpy as np
import pytest

import datafusion_tpu as ref
from datafusion_tpu.errors import ExecutionError as RefExecutionError
from datafusion_tpu.plan import logical as ref_logical
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.plan import logical as port_logical
from test_torch_window import contexts


def check(tables, sqls):
    r, p = contexts(tables)
    for q in sqls:
        try:
            want = r.sql(q).result_str()
        except Exception as e:  # the planner's errors: the port's copy raises the same class
            with pytest.raises(Exception) as got:
                p.sql(q)
            assert type(got.value).__name__ == type(e).__name__, q
            continue
        assert p.sql(q).result_str() == want, q


CASE_UNION = {
    "t": {"a": np.array([1, 2, 3, 4, 5], np.int64), "b": np.array([1.5, 2.5, 3.5, 4.5, 5.5]),
          "s": np.array(["x", "y", "x", "z", "y"], dtype=object)},
    "u": {"a": np.array([3, 4], np.int32), "s": np.array(["y", "w"], dtype=object)},
}


def test_case_union_sql():
    check(CASE_UNION, [
        "SELECT a, CASE WHEN a < 2 THEN 0 WHEN a < 4 THEN a * 10 ELSE 99 END FROM t",
        "SELECT CASE WHEN a < 3 THEN b END FROM t",
        "SELECT CASE a WHEN 1 THEN 100 WHEN 5 THEN 500 ELSE 0 END FROM t",
        "SELECT SUM(CASE WHEN a > 2 THEN b ELSE 0.0 END) FROM t",
        "SELECT a FROM t WHERE CASE WHEN a > 3 THEN TRUE ELSE FALSE END",
        "SELECT CASE WHEN s = 'x' THEN 1 ELSE 0 END FROM t",
        "SELECT CASE WHEN a < 3 THEN a ELSE b END FROM t",
        "SELECT CASE WHEN a THEN 1 ELSE 0 END FROM t",
        "SELECT a FROM t UNION ALL SELECT a FROM u",
        "SELECT b FROM t UNION ALL SELECT a FROM u",
        "SELECT s FROM t UNION SELECT s FROM u",
        "SELECT s FROM t UNION ALL SELECT s FROM u",
        "SELECT s, COUNT(a) FROM (SELECT a, s FROM t UNION ALL SELECT a, s FROM u) q GROUP BY s",
        "SELECT a FROM t WHERE a > 4 UNION ALL SELECT a FROM u WHERE a < 4",
        "SELECT 1 UNION ALL SELECT 2",
        "SELECT a, b FROM t UNION ALL SELECT a FROM u",
        "SELECT 1 UNION ALL SELECT 2 UNION ALL SELECT 3",
        "SELECT a FROM (SELECT a FROM t UNION ALL SELECT a FROM u) q ORDER BY a DESC LIMIT 3",
        "SELECT s, a * 2, b + 1 FROM t UNION ALL SELECT s, a, a FROM u UNION ALL SELECT 'v', 7, 0.5",
    ])
    schema = ref.Schema([ref.Field("a", ref.DataType.Float64), ref.Field("b", ref.DataType.Float64)])
    nt = ref.Table.from_arrays(schema, [np.array([1.0, 0.0, 3.0, 4.0]), np.array([10.0, 2.0, 3.0, 0.0])],
                               validity=[np.array([True, False, True, True]), np.array([False, True, True, False])])
    check({"t": nt, "i": {"i": np.array([1, 2], np.int64)}}, [
        "SELECT COALESCE(a, b) AS c1, COALESCE(a, -1.0) AS c2 FROM t",
        "SELECT COALESCE(a, b) FROM t WHERE a IS NULL AND b IS NULL",
        "SELECT NULLIF(a, b) FROM t",
        "SELECT NULLIF(b, 2.0) FROM t WHERE b IS NOT NULL",
        "SELECT COALESCE(i, 0.5) FROM i",
        "SELECT a FROM t UNION ALL SELECT b FROM t",
        "SELECT a FROM t UNION SELECT b FROM t",
        "SELECT a, a IS NULL FROM t UNION ALL SELECT b, b IS NULL FROM t WHERE b > 1.0",
    ])


SETOPS = {"t": {"k": np.array([1, 2, 3, 4, 5, 6], np.int32), "g": ["a", "a", "b", "b", "c", "c"],
                "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0])}}


def test_cte_setops_sql():
    check(SETOPS, [
        "WITH big AS (SELECT k, v FROM t WHERE v > 30) SELECT k FROM big ORDER BY k",
        "WITH a AS (SELECT k FROM t WHERE k < 4), b AS (SELECT k FROM a WHERE k > 1) SELECT k FROM b ORDER BY k",
        "WITH agg AS (SELECT g, SUM(v) AS total FROM t GROUP BY g) SELECT t.k, agg.total FROM t JOIN agg "
        "ON t.g = agg.g WHERE t.k < 3 ORDER BY k",
        "WITH s AS (SELECT k, g FROM t WHERE k < 5) SELECT x.k, y.k FROM s AS x JOIN s AS y ON x.g = y.g "
        "WHERE x.k < y.k ORDER BY 1",
        "WITH t AS (SELECT k FROM t WHERE k = 3) SELECT k FROM t",
        "SELECT COUNT(k) FROM t",
        "SELECT k FROM (WITH w AS (SELECT k FROM t WHERE k > 4) SELECT k FROM w) d ORDER BY k",
        "SELECT k FROM t WHERE k IN (WITH w AS (SELECT k FROM t WHERE k < 3) SELECT k FROM w) ORDER BY k",
        "WITH a AS (SELECT k FROM later), later AS (SELECT k FROM t) SELECT k FROM a",
        "SELECT g FROM t WHERE k < 5 INTERSECT SELECT g FROM t WHERE k > 2",
        "SELECT g FROM t EXCEPT SELECT g FROM t WHERE k > 2",
        "SELECT g FROM t INTERSECT SELECT g FROM t",
        "SELECT k FROM t WHERE k < 3 UNION SELECT k FROM t WHERE k > 4 EXCEPT SELECT k FROM t WHERE k = 5",
        "SELECT k FROM t WHERE k = 1 UNION SELECT k FROM t WHERE k < 4 INTERSECT SELECT k FROM t WHERE k > 2",
        "SELECT k FROM t WHERE k < 3 INTERSECT SELECT k + 1 FROM t",
        "SELECT k, g FROM t EXCEPT SELECT k FROM t",
        "WITH lo AS (SELECT k FROM t WHERE k <= 3) SELECT k FROM t EXCEPT SELECT k FROM lo",
        "SELECT k FROM t ORDER BY k LIMIT 2 OFFSET 3",
        "SELECT k FROM t LIMIT 3 OFFSET 1",
        "SELECT k FROM t ORDER BY k DESC OFFSET 4",
        "SELECT k FROM t ORDER BY k OFFSET 6",
        "SELECT k FROM t ORDER BY k LIMIT 5 OFFSET 99",
        "EXPLAIN SELECT k FROM t ORDER BY k LIMIT 2 OFFSET 3",
        "SELECT k FROM t OFFSET k",
    ])


def test_intersect_except_all():
    check({"a": {"x": np.array([1, 1, 1, 2, 3], np.int32)}, "b": {"x": np.array([1, 2, 2], np.int32)}}, [
        "SELECT x FROM a INTERSECT ALL SELECT x FROM b",
        "SELECT x FROM a EXCEPT ALL SELECT x FROM b",
        "SELECT x FROM b EXCEPT ALL SELECT x FROM a",
        "SELECT x FROM a INTERSECT SELECT x FROM b",
        "SELECT x FROM a EXCEPT SELECT x FROM b",
    ])
    rng = np.random.default_rng(3)
    check({"a": {"g": np.array([["x", "y"][i] for i in rng.integers(0, 2, 300)], dtype=object),
                 "v": rng.integers(0, 9, 300).astype(np.int32)},
           "b": {"g": np.array([["x", "y", "z"][i] for i in rng.integers(0, 3, 200)], dtype=object),
                 "v": rng.integers(0, 12, 200).astype(np.int32)}}, [
        "SELECT g, v FROM a EXCEPT ALL SELECT g, v FROM b",
        "SELECT g, v FROM a INTERSECT ALL SELECT g, v FROM b",
        "SELECT COUNT(*) FROM (SELECT v FROM a INTERSECT ALL SELECT v FROM b) q",
    ])


GROUPING = {"t": {"r": ["e", "e", "e", "w", "w", "w"], "g": ["a", "a", "b", "b", "c", "c"],
                  "v": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 65.0])}}


def test_grouping_sets_sql():
    check(GROUPING, [
        "SELECT NULL, v FROM t LIMIT 1",
        "SELECT CAST(NULL AS DOUBLE) + v FROM t LIMIT 1",
        "SELECT COALESCE(NULL, v) FROM t LIMIT 2",
        "SELECT g FROM t WHERE v > NULL",
        "SELECT 1, NULL UNION ALL SELECT 2, 'x'",
        "SELECT r, g, SUM(v) FROM t GROUP BY ROLLUP(r, g) ORDER BY 1, 2",
        "SELECT r, g, SUM(v), GROUPING(g) FROM t GROUP BY CUBE(r, g) ORDER BY 4, 1, 2",
        "SELECT r, g, COUNT(v) FROM t GROUP BY GROUPING SETS ((r), (g), ()) ORDER BY 1, 2",
        "SELECT r, SUM(v) AS s FROM t GROUP BY ROLLUP(r) ORDER BY s DESC LIMIT 2",
        "SELECT r, SUM(v) FROM t WHERE v > 15 GROUP BY ROLLUP(r) HAVING SUM(v) > 50 ORDER BY 1",
        "SELECT GROUPING(v) FROM t GROUP BY ROLLUP(r)",
        # without ORDER BY: the branches' rows in branch order
        "SELECT r, g, SUM(v), COUNT(*), MIN(v), MAX(v), AVG(v) FROM t GROUP BY ROLLUP(r, g)",
        "SELECT g, r, COUNT(v) FROM t GROUP BY CUBE(g, r)",
    ])
    check({"c": {"v": np.array([1.0, 5.0, 9.0]), "g": ["x", "y", "z"]}}, [
        "SELECT CASE WHEN v > 6 THEN 'high' WHEN v > 3 THEN 'mid' ELSE 'low' END FROM c",
        "SELECT CASE WHEN v > 3 THEN g ELSE NULL END FROM c",
        "SELECT CASE WHEN v > 3 THEN UPPER(g) ELSE g END FROM c",
        "SELECT CASE WHEN v > 3 THEN 'b' ELSE 'a' END AS k, COUNT(v) FROM c GROUP BY k ORDER BY k",
        "SELECT v FROM c ORDER BY CASE WHEN v > 6 THEN 'a' ELSE 'z' END, v",
        "SELECT v FROM c WHERE CASE WHEN v > 3 THEN 'y' ELSE 'n' END = 'y' ORDER BY v",
    ])


def test_union_dictionary_merge_and_empty_child():
    """Differing dictionaries remap into the sorted merged vocabulary; a
    0-row child's empty vocabulary maps nothing."""
    schema = ref.Schema([ref.Field("s", ref.DataType.Utf8, True), ref.Field("n", ref.DataType.Int32, True)])
    empty = ref.Table.from_arrays(schema, [np.array([], dtype=object), np.array([], np.int32)])
    check({"a": {"s": np.array(["m", "b", "m", "q"], dtype=object), "n": np.arange(4, dtype=np.int32)},
           "b": {"s": np.array(["z", "a", "m"], dtype=object), "n": np.array([7, 8, 9], np.int32)},
           "e": empty}, [
        "SELECT s, n FROM a UNION ALL SELECT s, n FROM b",
        "SELECT s, n FROM a UNION ALL SELECT s, n FROM e UNION ALL SELECT s, n FROM b",
        "SELECT s FROM e UNION ALL SELECT s FROM a",
        "SELECT s, COUNT(*), SUM(n) FROM (SELECT s, n FROM a UNION ALL SELECT s, n FROM b) q GROUP BY s ORDER BY s",
        "SELECT s FROM a UNION SELECT s FROM b UNION SELECT s FROM e",
        "SELECT s FROM a WHERE s > 'b' UNION ALL SELECT s FROM b ORDER BY s",
    ])


def test_union_mixed_utf8_numeric_raises():
    """A Union node whose children disagree on a column's Utf8-ness (the
    planner never builds one: its supertype check refuses first) raises
    ExecutionError in both packages."""
    r, p = contexts(CASE_UNION)
    for ctx, logical, err in ((r, ref_logical, RefExecutionError), (p, port_logical, ExecutionError)):
        left, right = ctx.plan("SELECT s FROM t"), ctx.plan("SELECT a FROM t")
        with pytest.raises(err, match="mixes Utf8 and numeric"):
            ctx.execute(logical.Union((left, right), left.schema))
