"""The statements of tests/test_string_functions.py through the port, on
one CPU device and on an 8-shard CPU mesh, `result_str`-equal to the JAX
package on one device: the string functions as dictionary transforms
(UPPER ... SPLIT_PART, `||`, LIKE over a transform, GROUP BY and ORDER BY
a transform), a LEFT JOIN beside LEFT(), and the math functions of the
same file; and its three refused statements, refused by both packages
with the same error."""

import numpy as np
import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.errors import NotImplementedError_ as RefNotImplemented, PlanError as RefPlanError

TABLES = {
    "names": {"t": {"k": np.array([1, 2, 3, 4], np.int32), "name": ["  Ann ", "bob", "CAT", "bob"]},
              "two": {"a": ["x", "y"], "b": ["p", "q"]}},
    "words": {"t": {"s": ["hello world", "Foo", "a,b,c"], "x": np.array([1.0, 2.0, 3.0])}},
    "math": {"t": {"x": np.array([2.5, -2.5, 100.0])}},
}
STATEMENTS = [
    ("names", "SELECT k, UPPER(name) FROM t ORDER BY k"),
    ("names", "SELECT k, LOWER(name) FROM t ORDER BY k"),
    ("names", "SELECT k, TRIM(name), LENGTH(name) FROM t ORDER BY k"),
    ("names", "SELECT k, SUBSTR(name, 2, 2) FROM t ORDER BY k"),
    ("names", "SELECT REVERSE(name) FROM t WHERE k = 3"),
    ("names", "SELECT REPLACE(name, 'b', 'B') FROM t WHERE k = 2"),
    ("names", "SELECT CONCAT('<', TRIM(name), '>') FROM t WHERE k = 1"),
    ("names", "SELECT k FROM t WHERE LOWER(TRIM(name)) = 'ann'"),
    ("names", "SELECT k FROM t WHERE UPPER(name) LIKE 'B%' ORDER BY k"),
    ("names", "SELECT LOWER(TRIM(name)) AS n, COUNT(1) FROM t GROUP BY n ORDER BY n"),
    ("names", "SELECT k, UPPER(TRIM(name)) AS u FROM t ORDER BY u, k"),
    ("names", "SELECT CONCAT(name, name) FROM t WHERE k = 1"),
    ("words", "SELECT INITCAP(s) FROM t ORDER BY 1"),
    ("words", "SELECT LEFT(s, 3), RIGHT(s, 2) FROM t WHERE s = 'hello world'"),
    ("words", "SELECT LPAD(s, 5, '*'), RPAD(s, 5, '.') FROM t WHERE s = 'Foo'"),
    ("words", "SELECT REPEAT(s, 2) FROM t WHERE s = 'Foo'"),
    ("words", "SELECT SPLIT_PART(s, ',', 2) FROM t WHERE s = 'a,b,c'"),
    ("words", "SELECT STRPOS(s, 'world'), ASCII(s) FROM t WHERE s = 'hello world'"),
    ("words", "SELECT s FROM t WHERE STRPOS(s, ',') > 0"),
    ("words", "SELECT s || '-x' FROM t WHERE s = 'Foo'"),
    ("words", "SELECT LEFT(t.s, 1) FROM t LEFT JOIN t AS u ON t.s = u.s WHERE t.s = 'Foo'"),
    ("math", "SELECT ROUND(x) FROM t"),
    ("math", "SELECT ROUND(x, 1), TRUNC(x) FROM t WHERE x < 0"),
    ("math", "SELECT POWER(x, 2), MOD(x, 2) FROM t WHERE x = 2.5"),
    ("math", "SELECT LOG10(x), SIGN(x) FROM t WHERE x = 100"),
    ("math", "SELECT DEGREES(RADIANS(x)) FROM t WHERE x = 100"),
]
REFUSED = [  # (statement, JAX error, port error, message)
    ("SELECT UPPER(name, name) FROM t", RefPlanError, port.PlanError, "argument"),
    ("SELECT UPPER(k) FROM t", RefPlanError, port.PlanError, "string argument"),
    ("SELECT CONCAT(a, b) FROM two", RefNotImplemented, port.NotImplementedError_, "DIFFERENT string columns"),
]


def _contexts(name):
    """(JAX on one device, port on one CPU device, port on 8 CPU shards)."""
    ctxs = (ref.ExecutionContext(), port.ExecutionContext(device="cpu"),
            port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")))
    for tname, cols in TABLES[name].items():
        ctxs[0].register_table(tname, ref.Table.from_pydict(dict(cols)))
        for c in ctxs[1:]:
            c.register_table(tname, port.Table.from_pydict(dict(cols), device="cpu"))
    return ctxs


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh"])
@pytest.mark.parametrize("tables,sql", STATEMENTS)
def test_string_statement_matches_the_jax_package(tables, sql, mesh):
    jax_ctx, one, shards = _contexts(tables)
    assert (shards if mesh else one).sql(sql).result_str() == jax_ctx.sql(sql).result_str()


@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh"])
@pytest.mark.parametrize("sql,ref_err,port_err,msg", REFUSED)
def test_refused_by_both(sql, ref_err, port_err, msg, mesh):
    jax_ctx, one, shards = _contexts("names")
    with pytest.raises(ref_err, match=msg):
        jax_ctx.sql(sql).result_str()
    with pytest.raises(port_err, match=msg):
        (shards if mesh else one).sql(sql).result_str()
