"""Expression compilation: Expr IR -> torch functions over device columns.

The port of datafusion_tpu/ops/expr_eval.py. Each expression compiles
once, at plan time, to a function over `(data, valid)` column values
that runs eagerly on the columns' device. String comparisons resolve
against the column dictionary at compile time; LIKE, string functions
and string casts evaluate on the (small) vocabulary on the host and
reach the device as one lookup-table gather.

Runtime value convention: a column value is `(data, valid)` where `data`
is a tensor (0-d for literals) and `valid` is a bool tensor or None
(all-valid).

Semantics carried from the JAX package's x64 results: integer `/`
truncates and `%` is the C remainder (`torch.div(..., rounding_mode=
"trunc")` and `torch.fmod`, not `//` or `%`); integer x/0 and x%0 are
NULL; integer results wrap to their logical width (`wrap_to`); AND/OR
validity is the AND of both validities (no Kleene logic).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.columnar.table import resolve_device
from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_
from datafusion_tpu_torch.plan.logical import (
    AggregateFunction,
    Alias,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Expr,
    IsNotNull,
    IsNull,
    Literal,
    Operator,
    ScalarFunction,
    SortExpr,
)
from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType, physical_np, torch_dtype
from datafusion_tpu_torch.utils import dates

ColVal = tuple[torch.Tensor, Optional[torch.Tensor]]


def full(x: torch.Tensor, n: int) -> torch.Tensor:
    """A literal's 0-d tensor broadcast to `n` rows; columns pass."""
    return x.expand(n) if x.dim() == 0 else x


def broadcast_col(cv: ColVal, n: int) -> ColVal:
    d, v = cv
    return full(d, n), None if v is None else full(v, n)


@dataclass(frozen=True)
class CompiledExpr:
    """A compiled expression: fn(cols) -> (data, valid|None)."""

    fn: Callable[[Sequence[ColVal]], ColVal]
    dtype: DataType
    dictionary: Optional[tuple[str, ...]] = None


# String functions evaluate on the dictionary VOCABULARY on the host at
# compile time; the transformed vocabulary is re-canonicalized (sorted
# unique) and the codes pass through a remap LUT, so code order keeps
# matching string order downstream.
_STRING_PYFNS: dict[str, Callable[..., str]] = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
    "substr": lambda s, start, ln=None: (
        s[max(int(start) - 1, 0):]
        if ln is None
        else s[max(int(start) - 1, 0): max(int(start) - 1, 0) + max(int(ln), 0)]
    ),
    "replace": lambda s, old, new: s.replace(str(old), str(new)),
    "lpad": lambda s, n, fill=" ": (
        s[: max(int(n), 0)] if len(s) >= int(n)
        else (str(fill) * int(n))[: int(n) - len(s)] + s
    ),
    "rpad": lambda s, n, fill=" ": (
        s[: max(int(n), 0)] if len(s) >= int(n)
        else s + (str(fill) * int(n))[: int(n) - len(s)]
    ),
    "left": lambda s, n: (
        s[: int(n)] if int(n) >= 0 else s[: max(len(s) + int(n), 0)]
    ),
    "right": lambda s, n: (
        s[max(len(s) - int(n), 0):] if int(n) >= 0 else s[min(-int(n), len(s)):]
    ),
    "initcap": lambda s: s.title(),
    "repeat": lambda s, n: s * max(int(n), 0),
    "split_part": lambda s, delim, n: (
        (s.split(str(delim)) + [""] * int(n))[int(n) - 1] if int(n) >= 1 else ""
    ),
}
_STRING_INT_PYFNS: dict[str, Callable[..., int]] = {
    "length": lambda s: len(s),
    "char_length": lambda s: len(s),
    "character_length": lambda s: len(s),
    "strpos": lambda s, sub: s.find(str(sub)) + 1,
    "ascii": lambda s: ord(s[0]) if s else 0,
}
_STRING_FN_NAMES = set(_STRING_PYFNS) | set(_STRING_INT_PYFNS) | {"substring", "concat"}

# the date and timestamp functions (utils/dates.py): EXTRACT fields and
# INTERVAL arithmetic; DATE_TRUNC is date_trunc_<unit>
DATE_FN_NAMES = frozenset(dates.EXTRACT_FIELDS + dates.INTERVAL_FUNCTIONS)


def is_date_function(name: str) -> bool:
    low = name.lower()
    return low in DATE_FN_NAMES or low.startswith("date_trunc_")


def sql_sign(x: torch.Tensor) -> torch.Tensor:
    """lax.sign semantics: +-1, keeping +-0 and NaN."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _sql_round(x, nd=None):
    """SQL ROUND: half away from zero."""
    m = torch.pow(10.0, nd) if nd is not None else torch.ones((), dtype=x.dtype, device=x.device)
    y = x * m
    return sql_sign(y) * torch.floor(torch.abs(y) + 0.5) / m


def _sql_trunc(x, nd=None):
    m = torch.pow(10.0, nd) if nd is not None else torch.ones((), dtype=x.dtype, device=x.device)
    return torch.trunc(x * m) / m


# built-in scalar functions, all on f64 arguments (the planner casts);
# ExecutionContext can register more
SCALAR_FUNCTIONS: dict[str, Callable] = {
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,  # natural log (ln alias; Postgres LOG is base 10 — use log10)
    "ln": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "sign": sql_sign,
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "power": torch.pow,
    "pow": torch.pow,
    "mod": torch.fmod,  # truncated remainder, sign follows the dividend
    "atan2": torch.atan2,
    "round": _sql_round,
    "trunc": _sql_trunc,
}

_WRAP_MASK = {DataType.UInt16: 0xFFFF, DataType.UInt32: 0xFFFFFFFF}


def wrap_to(t: torch.Tensor, dt: DataType) -> torch.Tensor:
    """Wrap an integer result to its LOGICAL width: the widened unsigned
    types (types.py) overflow like their numpy counterparts."""
    m = _WRAP_MASK.get(dt)
    return t if m is None else torch.bitwise_and(t, m)


def and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def int_div(l: torch.Tensor, r: torch.Tensor, mod: bool) -> torch.Tensor:
    """Truncating integer division / C remainder with the divisor's 0 and
    -1 taken out of the division (caller masks 0 as NULL): x / -1 is the
    wrapped negation (INT_MIN / -1 = INT_MIN) and x % -1 is 0, the JAX
    package's values, with no overflow trap."""
    signed = l.dtype not in (torch.uint8, torch.bool)
    bad = (r == 0) | (r == -1) if signed else r == 0
    safe = torch.where(bad, torch.ones((), dtype=r.dtype, device=r.device), r)
    if mod:
        out = torch.fmod(l, safe)
        return torch.where(r == -1, torch.zeros((), dtype=out.dtype, device=out.device), out) if signed else out
    out = torch.div(l, safe, rounding_mode="trunc")
    return torch.where(r == -1, torch.neg(l), out) if signed else out


def int_bounds(dt: DataType) -> tuple[int, int]:
    """Value range of a logical integer type."""
    info = np.iinfo(dt.to_np())
    return int(info.min), int(info.max)


def cast_tensor(d: torch.Tensor, target: DataType) -> torch.Tensor:
    """Numeric CAST of a device tensor to `target`'s physical dtype.
    Float -> integer truncates toward zero and saturates at the target's
    range, NaN giving 0 (XLA's conversion, which the JAX package's
    results follow); integer -> integer wraps to the target width."""
    tdt = torch_dtype(target)
    if target is DataType.Boolean:
        return d != 0
    if d.dtype.is_floating_point and not tdt.is_floating_point:
        lo, hi = int_bounds(target)
        x = torch.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
        big, small = d >= float(hi), d <= float(lo)
        out = torch.where(big | small, torch.zeros((), dtype=d.dtype, device=d.device), x).to(torch.int64)
        out = torch.where(big, hi, torch.where(small, lo, out))
        return out.to(tdt)
    return wrap_to(d.to(tdt), target)


def const_tensor(value, dt: DataType, device) -> torch.Tensor:
    """A 0-d device tensor holding a literal in `dt`'s physical dtype."""
    np_val = np.asarray(value, dtype=dt.to_np()).astype(physical_np(dt))
    return torch.from_numpy(np.array(np_val)).to(device)


_ARITH = {
    Operator.Plus: torch.add,
    Operator.Minus: torch.sub,
    Operator.Multiply: torch.mul,
    Operator.Divide: lambda l, r: (
        int_div(l, r, mod=False) if not l.dtype.is_floating_point else torch.div(l, r)
    ),
    Operator.Modulus: lambda l, r: (
        int_div(l, r, mod=True) if not l.dtype.is_floating_point else torch.fmod(l, r)
    ),
}

_CMP = {
    Operator.Eq: torch.eq,
    Operator.NotEq: torch.ne,
    Operator.Lt: torch.lt,
    Operator.LtEq: torch.le,
    Operator.Gt: torch.gt,
    Operator.GtEq: torch.ge,
}


def compile_expr(
    expr: Expr,
    schema: Schema,
    dicts: Sequence[Optional[tuple[str, ...]]],
    fn_registry: Optional[dict[str, Callable]] = None,
    device=None,
) -> CompiledExpr:
    """Compile `expr` against `schema`; `dicts[i]` is the dictionary of
    input column i (None for non-Utf8). Literals and lookup tables are
    placed on `device`: the card unless the caller names another
    (`resolve_device`)."""
    registry = dict(SCALAR_FUNCTIONS)
    if fn_registry:
        registry.update(fn_registry)
    return _Compiler(schema, list(dicts), registry, resolve_device(device)).compile(expr)


def strip_utf8_cast(e: Expr) -> Expr:
    """Identity Utf8 casts hide the column or literal a string rewrite
    wants; casts to non-string types are real conversions and stay."""
    while isinstance(e, Cast) and e.data_type is DataType.Utf8:
        e = e.expr
    return e


def _typeable(e: Expr, schema) -> bool:
    try:
        e.get_type(schema)
        return True
    except Exception:
        return False


def is_string_comparison(expr: BinaryExpr, schema) -> bool:
    lraw, rraw = strip_utf8_cast(expr.left), strip_utf8_cast(expr.right)
    l_str = _typeable(lraw, schema) and lraw.get_type(schema) is DataType.Utf8
    r_str = _typeable(rraw, schema) and rraw.get_type(schema) is DataType.Utf8
    return expr.op.is_comparison and (l_str or r_str)


def dict_literal_bounds(vocab: tuple[str, ...], lit: str) -> tuple[int, int]:
    """[lo, hi) code range of `lit` in a sorted vocabulary."""
    varr = np.asarray(vocab, dtype=object).astype(str)
    return (
        int(np.searchsorted(varr, lit, side="left")),
        int(np.searchsorted(varr, lit, side="right")),
    )


_FLIP = {
    Operator.Lt: Operator.Gt,
    Operator.LtEq: Operator.GtEq,
    Operator.Gt: Operator.Lt,
    Operator.GtEq: Operator.LtEq,
}


def _like_to_regex(pattern: str) -> str:
    import re

    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


_TRUE_STRINGS = {"true", "t", "yes", "y", "on", "1"}
_FALSE_STRINGS = {"false", "f", "no", "n", "off", "0"}


class _Compiler:
    def __init__(self, schema, dicts, registry, device):
        self.schema = schema
        self.dicts = dicts
        self.registry = registry
        self.device = device

    def lut(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def compile(self, expr) -> CompiledExpr:
        schema, dev = self.schema, self.device
        if isinstance(expr, Column):
            i = expr.index
            return CompiledExpr(lambda cols, i=i: cols[i], schema.field(i).dtype, self.dicts[i])

        if isinstance(expr, Literal):
            sv = expr.value
            dt = sv.dtype
            if sv.value is None:
                zero = const_tensor(0, dt, dev)
                invalid = torch.zeros((), dtype=torch.bool, device=dev)
                return CompiledExpr(lambda cols, z=zero, iv=invalid: (z, iv), dt)
            if dt is DataType.Utf8:
                # a bare string literal projects as a one-entry dictionary
                zero = torch.zeros((), dtype=torch.int32, device=dev)
                return CompiledExpr(lambda cols, z=zero: (z, None), dt, (str(sv.value),))
            const = const_tensor(sv.value, dt, dev)
            return CompiledExpr(lambda cols, c=const: (c, None), dt)

        if isinstance(expr, BinaryExpr):
            return self.binary(expr)

        if isinstance(expr, Cast):
            return self.cast(expr)

        if isinstance(expr, IsNull):
            inner = self.compile(expr.expr)

            def isnull_fn(cols, inner=inner):
                d, v = inner.fn(cols)
                if v is None:
                    return torch.zeros(d.shape, dtype=torch.bool, device=d.device), None
                return torch.logical_not(v), None

            return CompiledExpr(isnull_fn, DataType.Boolean)

        if isinstance(expr, IsNotNull):
            inner = self.compile(expr.expr)

            def isnotnull_fn(cols, inner=inner):
                d, v = inner.fn(cols)
                if v is None:
                    return torch.ones(d.shape, dtype=torch.bool, device=d.device), None
                return v, None

            return CompiledExpr(isnotnull_fn, DataType.Boolean)

        if isinstance(expr, ScalarFunction):
            low = expr.name.lower()
            if is_date_function(low):
                return self.date_fn(expr)
            if low in _STRING_FN_NAMES:
                return self.string_fn(expr)
            from datafusion_tpu_torch.ops.functions import HostFunction

            fn = self.registry.get(low)
            if fn is None:
                raise ExecutionError(f"Invalid function '{expr.name}'")
            if isinstance(fn, HostFunction):
                raise NotImplementedError_(
                    f"host function '{expr.name}' is only supported in the "
                    "top-level SELECT list (it runs on host at result time)"
                )
            args = [self.compile(a) for a in expr.args]

            def sf_fn(cols, fn=fn, args=args):
                datas, valid = [], None
                for a in args:
                    d, v = a.fn(cols)
                    datas.append(d)
                    valid = and_valid(valid, v)
                return fn(*datas), valid

            return CompiledExpr(sf_fn, expr.return_type)

        if isinstance(expr, Case):
            return self.case(expr)

        if isinstance(expr, (SortExpr, Alias)):
            return self.compile(expr.expr)

        if isinstance(expr, AggregateFunction):
            raise ExecutionError(
                "aggregate function reached the expression compiler; aggregates "
                "are lowered by the Aggregate operator"
            )
        raise NotImplementedError_(f"cannot compile expression {expr!r}")

    def date_fn(self, expr: ScalarFunction) -> CompiledExpr:
        """EXTRACT / EPOCH / DATE_TRUNC over a Date32 or Timestamp, and the
        planner's INTERVAL functions with their literal count; validity
        passes through."""
        low = expr.name.lower()
        inner = self.compile(expr.args[0])
        if low in dates.INTERVAL_FUNCTIONS:
            assert isinstance(expr.args[1], Literal)
            op = dates.interval_function(low, int(expr.args[1].value.value), self.device)
        elif low.startswith("date_trunc_"):
            op = dates.trunc_function(low[len("date_trunc_"):], inner.dtype is DataType.Timestamp)
        else:
            op = dates.extract_function(low, inner.dtype is DataType.Timestamp)

        def date_fn(cols, inner=inner, op=op):
            d, v = inner.fn(cols)
            return op(d), v

        return CompiledExpr(date_fn, expr.return_type)

    # ------------------------------------------------------------------
    def cast(self, expr: Cast) -> CompiledExpr:
        inner = self.compile(expr.expr)
        target = expr.data_type
        dev = self.device
        if inner.dtype is DataType.Null and target is DataType.Utf8:
            def null_str_fn(cols, inner=inner):
                _, v = inner.fn(cols)
                return torch.zeros((), dtype=torch.int32, device=dev), v

            return CompiledExpr(null_str_fn, target, ("",))
        if inner.dtype is DataType.Utf8 or target is DataType.Utf8:
            if inner.dtype == target:
                return inner
            if inner.dtype is DataType.Utf8 and inner.dictionary is not None:
                return self.utf8_cast(inner, target)
            raise NotImplementedError_(
                "CAST to Utf8 / from a non-dictionary string is not supported on device"
            )
        if inner.dtype is DataType.Date32 and target is DataType.Timestamp:
            def d2ts_fn(cols, inner=inner):
                d, v = inner.fn(cols)
                return d.to(torch.int64) * 86400, v

            return CompiledExpr(d2ts_fn, target)
        if inner.dtype is DataType.Timestamp and target is DataType.Date32:
            def ts2d_fn(cols, inner=inner):
                d, v = inner.fn(cols)
                return dates.ts_to_date(d), v

            return CompiledExpr(ts2d_fn, target)

        def cast_fn(cols, inner=inner, target=target):
            d, v = inner.fn(cols)
            return cast_tensor(d, target), v

        return CompiledExpr(cast_fn, target)

    def utf8_cast(self, inner: CompiledExpr, target: DataType) -> CompiledExpr:
        """CAST(string AS numeric/boolean/date/timestamp): the vocabulary
        parses on host into a value LUT + parse-ok LUT; unparseable
        strings yield NULL (TRY_CAST semantics, as the JAX package)."""
        from datafusion_tpu_torch.utils.dates import parse_iso_date, parse_iso_timestamp

        vocab = inner.dictionary if inner.dictionary else ("",)
        vals = np.zeros(len(vocab), target.to_np())
        ok = np.ones(len(vocab), np.bool_)
        for i, t in enumerate(vocab):
            t = t.strip()
            try:
                if target is DataType.Date32:
                    vals[i] = parse_iso_date(t)
                elif target is DataType.Timestamp:
                    vals[i] = parse_iso_timestamp(t)
                elif target is DataType.Boolean:
                    low = t.lower()
                    if low in _TRUE_STRINGS:
                        vals[i] = True
                    elif low in _FALSE_STRINGS:
                        vals[i] = False
                    else:
                        raise ValueError(t)
                elif np.issubdtype(vals.dtype, np.integer):
                    f = float(t)
                    # SQL CAST rounds half away from zero to integer types
                    vals[i] = int(np.sign(f) * np.floor(abs(f) + 0.5))
                else:
                    vals[i] = float(t)
            except (ValueError, OverflowError):
                ok[i] = False
        lutv = self.lut(vals.astype(physical_np(target)))
        luto = None if ok.all() else self.lut(ok)

        def fn(cols, inner=inner, lutv=lutv, luto=luto):
            d, v = inner.fn(cols)
            data = lutv[d.long()]
            if luto is None:
                return data, v
            return data, and_valid(luto[d.long()], v)

        return CompiledExpr(fn, target)

    # ------------------------------------------------------------------
    def case(self, expr: Case) -> CompiledExpr:
        out_dt = expr.get_type(self.schema)
        dev = self.device
        branches = [(self.compile(c), self.compile(r)) for c, r in expr.branches]
        else_c = self.compile(expr.else_expr) if expr.else_expr is not None else None

        def sel_valid(take, v_true, v_false):
            if v_true is None and v_false is None:
                return None
            vt = torch.ones((), dtype=torch.bool, device=dev) if v_true is None else v_true
            vf = torch.ones((), dtype=torch.bool, device=dev) if v_false is None else v_false
            return torch.where(take, vt, vf)

        if out_dt is DataType.Utf8:
            # string CASE: merge the arms' dictionaries, remap each arm's
            # codes into the merged vocabulary, select on the codes
            arms = [r for _, r in branches] + ([else_c] if else_c else [])
            for arm in arms:
                if arm.dictionary is None:
                    raise NotImplementedError_(
                        "every string CASE arm must be a dictionary "
                        "expression (column, string function, or literal)"
                    )
            merged = tuple(sorted(set().union(*[set(a.dictionary) for a in arms]))) or ("",)
            merged_np = np.asarray(merged, dtype=object).astype(str)
            remap_of = {
                id(a): self.lut(
                    np.searchsorted(
                        merged_np, np.asarray(a.dictionary or ("",), object).astype(str)
                    ).astype(np.int32)
                )
                for a in arms
            }

            def remap(arm, d):
                return remap_of[id(arm)][d.long()]

        else:
            tdt = torch_dtype(out_dt)
            merged = None

            def remap(arm, d):
                return d.to(tdt)

        def case_fn(cols):
            if else_c is not None:
                acc_d, acc_v = else_c.fn(cols)
                acc_d = remap(else_c, acc_d)
            else:  # no ELSE: unmatched rows are NULL
                acc_d = torch.zeros((), dtype=torch.int32 if merged else torch_dtype(out_dt), device=dev)
                acc_v = torch.zeros((), dtype=torch.bool, device=dev)
            # later WHEN arms lose to earlier ones: fold back-to-front
            for cond_c, res_c in reversed(branches):
                cd, cv = cond_c.fn(cols)
                take = cd if cv is None else torch.logical_and(cd, cv)  # NULL -> false
                rd, rv = res_c.fn(cols)
                acc_d = torch.where(take, remap(res_c, rd), acc_d)
                acc_v = sel_valid(take, rv, acc_v)
            return acc_d, acc_v

        return CompiledExpr(case_fn, out_dt, merged)

    # ------------------------------------------------------------------
    def binary(self, expr: BinaryExpr) -> CompiledExpr:
        op = expr.op
        if op in (Operator.Like, Operator.NotLike):
            return self.like(expr)
        if is_string_comparison(expr, self.schema):
            return self.string_cmp(strip_utf8_cast(expr.left), op, strip_utf8_cast(expr.right))

        left = self.compile(expr.left)
        right = self.compile(expr.right)

        if op in (Operator.And, Operator.Or):
            top = torch.logical_and if op is Operator.And else torch.logical_or

            def bool_fn(cols):
                ld, lv = left.fn(cols)
                rd, rv = right.fn(cols)
                return top(ld, rd), and_valid(lv, rv)

            return CompiledExpr(bool_fn, DataType.Boolean)

        if op.is_comparison:
            cmp = _CMP[op]

            def cmp_fn(cols):
                ld, lv = left.fn(cols)
                rd, rv = right.fn(cols)
                return cmp(ld, rd), and_valid(lv, rv)

            return CompiledExpr(cmp_fn, DataType.Boolean)

        if op in _ARITH:
            arith = _ARITH[op]
            out_dt = expr.get_type(self.schema)

            def wrapped(l, r):
                return wrap_to(arith(l, r), out_dt)

            if op in (Operator.Divide, Operator.Modulus) and out_dt.is_numeric and not out_dt.is_float:
                # integer x/0 and x%0 are NULL (the JAX package's documented
                # deviation from the reference's panic); float /0 keeps IEEE
                def div0_fn(cols):
                    ld, lv = left.fn(cols)
                    rd, rv = right.fn(cols)
                    zero = rd == 0
                    return wrapped(ld, rd), and_valid(and_valid(lv, rv), torch.logical_not(zero))

                return CompiledExpr(div0_fn, out_dt)

            def arith_fn(cols):
                ld, lv = left.fn(cols)
                rd, rv = right.fn(cols)
                return wrapped(ld, rd), and_valid(lv, rv)

            return CompiledExpr(arith_fn, out_dt)

        raise NotImplementedError_(f"operator {op!r} is not executable")

    def string_cmp(self, lraw, op, rraw) -> CompiledExpr:
        """String comparisons on dictionary codes, resolved at compile
        time. Either side may be a dictionary-carrying expression or a
        literal."""
        if isinstance(rraw, Literal) and not isinstance(lraw, Literal):
            return self.dict_lit_cmp(self.compile(lraw), op, rraw.value.value)
        if isinstance(lraw, Literal) and not isinstance(rraw, Literal):
            return self.dict_lit_cmp(self.compile(rraw), _FLIP.get(op, op), lraw.value.value)
        if not isinstance(lraw, Literal) and not isinstance(rraw, Literal):
            return self.dict_dict_cmp(self.compile(lraw), op, self.compile(rraw))
        raise NotImplementedError_("unsupported string comparison operands")

    def dict_lit_cmp(self, inner: CompiledExpr, op: Operator, lit: str) -> CompiledExpr:
        if inner.dictionary is None:
            raise ExecutionError("Utf8 expression has no dictionary")
        lo, hi = dict_literal_bounds(inner.dictionary, lit)
        present = lo < hi

        def fn(cols):
            d, v = inner.fn(cols)
            if op is Operator.Eq:
                out = (d == lo) if present else torch.zeros(d.shape, dtype=torch.bool, device=d.device)
            elif op is Operator.NotEq:
                out = (d != lo) if present else torch.ones(d.shape, dtype=torch.bool, device=d.device)
            elif op is Operator.Lt:
                out = d < lo
            elif op is Operator.LtEq:
                out = d < hi
            elif op is Operator.Gt:
                out = d >= hi
            elif op is Operator.GtEq:
                out = d >= lo
            else:
                raise ExecutionError(f"bad string cmp {op}")
            return out, v

        return CompiledExpr(fn, DataType.Boolean)

    def dict_dict_cmp(self, lc: CompiledExpr, op: Operator, rc: CompiledExpr) -> CompiledExpr:
        lv, rv = lc.dictionary, rc.dictionary
        if lv is None or rv is None:
            raise ExecutionError("Utf8 expression missing dictionary")
        cmp = _CMP[op]
        if lv == rv:
            def same_fn(cols):
                ld, lvd = lc.fn(cols)
                rd, rvd = rc.fn(cols)
                return cmp(ld, rd), and_valid(lvd, rvd)

            return CompiledExpr(same_fn, DataType.Boolean)
        # different dictionaries: remap both into the merged sorted vocab
        merged = np.asarray(sorted(set(lv) | set(rv)), dtype=object).astype(str)
        lmap = self.lut(np.searchsorted(merged, np.asarray(lv, dtype=object).astype(str)).astype(np.int32))
        rmap = self.lut(np.searchsorted(merged, np.asarray(rv, dtype=object).astype(str)).astype(np.int32))

        def remap_fn(cols):
            ld, lvd = lc.fn(cols)
            rd, rvd = rc.fn(cols)
            return cmp(lmap[ld.long()], rmap[rd.long()]), and_valid(lvd, rvd)

        return CompiledExpr(remap_fn, DataType.Boolean)

    def like(self, expr: BinaryExpr) -> CompiledExpr:
        """LIKE/NOT LIKE on dictionary-encoded strings: the pattern is
        matched against the vocabulary on the host, giving a bool LUT
        indexed by code on device."""
        import re

        lraw, rraw = strip_utf8_cast(expr.left), strip_utf8_cast(expr.right)
        if isinstance(lraw, Literal) or not isinstance(rraw, Literal):
            raise NotImplementedError_("LIKE requires <string expr> LIKE 'pattern'")
        inner = self.compile(lraw)
        if inner.dictionary is None:
            raise NotImplementedError_("LIKE is only supported on Utf8 expressions")
        rx = re.compile(_like_to_regex(rraw.value.value), re.DOTALL)
        matches = np.array([rx.fullmatch(v) is not None for v in inner.dictionary], dtype=np.bool_)
        if expr.op is Operator.NotLike:
            matches = ~matches
        lut = self.lut(matches if len(matches) else np.zeros(1, np.bool_))

        def fn(cols):
            d, v = inner.fn(cols)
            return lut[d.long()], v

        return CompiledExpr(fn, DataType.Boolean)

    def string_fn(self, expr: ScalarFunction) -> CompiledExpr:
        """String functions as dictionary transforms: the whole string
        expression tree evaluates on the host per vocabulary entry of ONE
        base dictionary expression; the codes then pass through a single
        remap LUT (Utf8 results) or value LUT (integer results)."""

        def canon(name: str) -> str:
            low = name.lower()
            return "substr" if low == "substring" else low

        base: dict = {}
        has_null = {"v": False}

        def build(e) -> Callable[[str], object]:
            raw = strip_utf8_cast(e)
            if isinstance(raw, Literal):
                v = raw.value.value
                if v is None:
                    has_null["v"] = True
                return lambda s, v=v: "" if v is None else v
            if isinstance(raw, ScalarFunction) and canon(raw.name) in (
                set(_STRING_PYFNS) | set(_STRING_INT_PYFNS) | {"concat"}
            ):
                low = canon(raw.name)
                argfns = [build(a) for a in raw.args]
                if low == "concat":
                    return lambda s, fs=argfns: "".join(str(f(s)) for f in fs)
                pyfn = _STRING_PYFNS.get(low) or _STRING_INT_PYFNS[low]
                return lambda s, fs=argfns, fn=pyfn: fn(*[f(s) for f in fs])
            c = self.compile(raw)
            if c.dictionary is None:
                raise NotImplementedError_(
                    f"{expr.name} argument must be a dictionary-encoded string "
                    "expression or a literal"
                )
            if "expr" in base:
                if base["expr"] != raw:
                    raise NotImplementedError_(
                        f"{expr.name} combines two DIFFERENT string columns — "
                        "only one base string expression per call is supported"
                    )
            else:
                base["expr"] = raw
                base["compiled"] = c
            return lambda s: s

        tree = build(expr)
        dev = self.device
        if has_null["v"]:
            # a NULL operand makes the whole string expression NULL
            invalid = torch.zeros((), dtype=torch.bool, device=dev)
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return CompiledExpr(lambda cols: (zero, invalid), DataType.Utf8, ("",))
        if "compiled" not in base:
            raise NotImplementedError_(f"{expr.name} needs at least one string column argument")
        inner: CompiledExpr = base["compiled"]
        vocab = inner.dictionary if inner.dictionary else ("",)
        try:
            transformed = [tree(v) for v in vocab]
        except TypeError:
            raise ExecutionError(f"wrong number of arguments for {expr.name}") from None

        if canon(expr.name) in _STRING_INT_PYFNS:
            lut = self.lut(np.array(transformed, np.int32))

            def int_fn(cols):
                d, v = inner.fn(cols)
                return lut[d.long()], v

            return CompiledExpr(int_fn, DataType.Int32)

        transformed = [str(t) for t in transformed]
        canonical = tuple(sorted(set(transformed)))
        remap = self.lut(
            np.searchsorted(
                np.asarray(canonical, dtype=object).astype(str),
                np.asarray(transformed, dtype=object).astype(str),
            ).astype(np.int32)
        )

        def str_fn(cols):
            d, v = inner.fn(cols)
            return remap[d.long()], v

        return CompiledExpr(str_fn, DataType.Utf8, canonical)
