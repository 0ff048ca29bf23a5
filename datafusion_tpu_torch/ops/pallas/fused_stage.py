"""K1 — fused scan -> filter -> project stage: ONE pass over the inputs.

Port of datafusion_tpu/ops/pallas/fused_stage.py `run_fused`. The Pallas
kernel traced a closure of compiled JAX expressions; here the plan
compiler lowers the predicate and every computed projection into a
short linear register `Program` (`compile_program`), and one CUDA kernel
(csrc/fused_stage.cu) interprets it a tile of rows at a time, reading
each referenced input column once and writing the selection mask plus
each computed column (and its validity) once.

`compile_program` ends with two passes over the builder's program:
`fold_immediates` lets an instruction read a constant as its second
operand (so no instruction fills a register with it) and drops the dead
instructions, and `allocate_registers` maps the logical registers onto
as few physical ones as the liveness over the linear code allows. The
kernel keeps the physical registers in shared memory, so fewer of them
buy a larger tile (`tile_rows`).

The opcode set IS the plan-time whitelist: `compile_program` raises
`Unsupported` for anything outside it, and the compiler then keeps the
plain torch projection path (decided at plan time, recorded in the
plan's notes). `evaluate_plain` is the same function in plain PyTorch:
the CPU tests run it, and chip_smoke.py holds the kernel against it.
"""

from __future__ import annotations

import ctypes
import heapq
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.ops.expr_eval import (
    SCALAR_FUNCTIONS,
    cast_tensor,
    dict_literal_bounds,
    int_div,
    is_date_function,
    is_string_comparison,
    sql_sign,
    strip_utf8_cast,
    wrap_to,
)
from datafusion_tpu_torch.plan.logical import (
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
from datafusion_tpu_torch.types import DataType, torch_dtype
from datafusion_tpu_torch.utils import dates
from datafusion_tpu_torch.utils.trace import spanned

# capacities of the kernel's Program struct (csrc/fused_stage.cu)
MAX_INSTR, MAX_REGS, MAX_IN, MAX_OUT, MAX_CONST = 64, 32, 12, 12, 32

# value types
(T_BOOL, T_I8, T_I16, T_I32, T_I64, T_U8, T_U16, T_U32, T_F32, T_F64) = range(10)
# opcodes
(
    OP_LOAD, OP_CONST, OP_NULL,
    OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD,
    OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
    OP_AND, OP_OR,
    OP_CAST, OP_ISNULL, OP_ISNOTNULL, OP_SELECT, OP_KEEPV,
    OP_MATH1, OP_MATH2,
    OP_DATE, OP_DTRUNC, OP_ADDMONTHS,
) = range(26)

MATH1 = {
    "sqrt": 0, "abs": 1, "exp": 2, "log": 3, "ln": 3, "log10": 4, "log2": 5,
    "sin": 6, "cos": 7, "tan": 8, "asin": 9, "acos": 10, "atan": 11,
    "floor": 12, "ceil": 13, "sign": 14,
}
MATH2 = {"power": 0, "pow": 0, "mod": 1, "atan2": 2, "round": 3, "trunc": 4}
# OP_DATE's fields (in `c`): EXTRACT's, then "days", Timestamp -> Date32;
# its source is a Date32 (b = T_I32, days) or a Timestamp (b = T_I64,
# seconds). OP_DTRUNC's units (in `c`) keep the source type, `ty`.
# OP_ADDMONTHS adds operand b (an int32 immediate) months to `ty`'s value.
_DATE_FIELD_NAMES = dates.EXTRACT_FIELDS + ("days",)
DATE_FIELDS = {f: i for i, f in enumerate(_DATE_FIELD_NAMES)}
TRUNC_UNITS = {u: i for i, u in enumerate(dates.DATE_TRUNC_UNITS)}

_TYPE_OF = {
    DataType.Boolean: T_BOOL, DataType.Int8: T_I8, DataType.Int16: T_I16,
    DataType.Int32: T_I32, DataType.Int64: T_I64, DataType.UInt8: T_U8,
    DataType.UInt16: T_U16, DataType.UInt32: T_U32, DataType.UInt64: T_I64,
    DataType.Float32: T_F32, DataType.Float64: T_F64, DataType.Utf8: T_I32,
    DataType.Date32: T_I32, DataType.Timestamp: T_I64, DataType.Null: T_I32,
}
# logical type standing for each value type (its torch storage + wrap width)
_LOGICAL = {
    T_BOOL: DataType.Boolean, T_I8: DataType.Int8, T_I16: DataType.Int16,
    T_I32: DataType.Int32, T_I64: DataType.Int64, T_U8: DataType.UInt8,
    T_U16: DataType.UInt16, T_U32: DataType.UInt32, T_F32: DataType.Float32,
    T_F64: DataType.Float64,
}
_CMP_OPS = {
    Operator.Eq: OP_EQ, Operator.NotEq: OP_NE, Operator.Lt: OP_LT,
    Operator.LtEq: OP_LE, Operator.Gt: OP_GT, Operator.GtEq: OP_GE,
}
_ARITH_OPS = {
    Operator.Plus: OP_ADD, Operator.Minus: OP_SUB, Operator.Multiply: OP_MUL,
    Operator.Divide: OP_DIV, Operator.Modulus: OP_MOD,
}


class Unsupported(Exception):
    """The expression needs an operation outside the kernel's opcode set."""


@dataclass
class Program:
    """A linear register program. `code` rows are (op, type, dst, a, b, c,
    imm, imm_type): with `imm` set, operand b is the constant `consts[b]`
    (of type imm_type, always valid) rather than a register; `inputs` are
    table column indices (LOAD's `a` indexes this list); `outputs` are
    (register, type, nullable) per computed expression. `n_regs` counts
    the registers the code names."""

    code: list = field(default_factory=list)
    consts: list = field(default_factory=list)  # 64-bit patterns
    inputs: list = field(default_factory=list)
    input_types: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    sel_reg: int = -1
    n_regs: int = 0
    c_program: object = field(default=None, repr=False, compare=False)  # c_program()'s cache


def value_type(dt: DataType) -> int:
    t = _TYPE_OF.get(dt)
    if t is None:
        raise Unsupported(f"{dt} values")
    return t


def _const_bits(value, t: int) -> int:
    """64-bit register pattern of a constant (floats as f64 bits; f32
    constants rounded to f32 first)."""
    if t in (T_F32, T_F64):
        v = float(np.float32(value)) if t == T_F32 else float(value)
        return int(np.array(v, np.float64).view(np.int64))
    return int(value)


class ProgramBuilder:
    """Lowers logical expressions into one Program. `schema`/`dicts`
    describe the scanned columns; `nullable[i]` says whether column i
    carries a validity tensor."""

    def __init__(self, schema, dicts, nullable: Sequence[bool]):
        self.schema = schema
        self.dicts = dicts
        self.col_nullable = nullable
        self.p = Program()
        self.nullable: list[bool] = []
        self.loaded: dict[int, int] = {}

    def emit(self, op, ty, a=0, b=0, c=0, nullable=False) -> int:
        dst = len(self.nullable)
        if dst >= MAX_REGS:
            raise Unsupported(f"more than {MAX_REGS} registers")
        if len(self.p.code) >= MAX_INSTR:
            raise Unsupported(f"more than {MAX_INSTR} instructions")
        self.p.code.append((op, ty, dst, a, b, c, 0, 0))
        self.nullable.append(nullable)
        return dst

    def const(self, value, ty) -> int:
        if len(self.p.consts) >= MAX_CONST:
            raise Unsupported(f"more than {MAX_CONST} constants")
        self.p.consts.append(_const_bits(value, ty))
        return self.emit(OP_CONST, ty, a=len(self.p.consts) - 1)

    def constant_value(self, e: Expr):
        """(value, DataType) when `e` is a literal or a cast of one,
        folded on the host the way the JAX package folds it (numpy
        astype); None otherwise."""
        if isinstance(e, Alias):
            return self.constant_value(e.expr)
        if isinstance(e, Literal) and e.value.value is not None and e.value.dtype is not DataType.Utf8:
            return e.value.value, e.value.dtype
        if isinstance(e, Cast) and e.data_type.is_numeric:
            inner = self.constant_value(e.expr)
            if inner is not None and inner[1].is_numeric:
                v = np.asarray(inner[0], dtype=inner[1].to_np()).astype(e.data_type.to_np())
                return v.item(), e.data_type
        return None

    # ------------------------------------------------------------------
    def lower(self, e: Expr) -> int:
        """Register holding `e`'s value (and validity)."""
        if isinstance(e, (Alias, SortExpr)):
            return self.lower(e.expr)
        if isinstance(e, Column):
            i = e.index
            if i not in self.loaded:
                if len(self.p.inputs) >= MAX_IN:
                    raise Unsupported(f"more than {MAX_IN} input columns")
                t = value_type(self.schema.field(i).dtype)
                self.p.inputs.append(i)
                self.p.input_types.append(t)
                self.loaded[i] = self.emit(
                    OP_LOAD, t, a=len(self.p.inputs) - 1, nullable=self.col_nullable[i]
                )
            return self.loaded[i]
        if isinstance(e, Literal):
            if e.value.dtype is DataType.Utf8:
                raise Unsupported("a bare Utf8 literal")
            t = value_type(e.value.dtype)
            if e.value.value is None:
                return self.emit(OP_NULL, t, nullable=True)
            return self.const(e.value.value, t)
        if isinstance(e, BinaryExpr):
            return self.binary(e)
        if isinstance(e, Cast):
            return self.cast(e)
        if isinstance(e, (IsNull, IsNotNull)):
            r = self.lower(e.expr)
            return self.emit(OP_ISNULL if isinstance(e, IsNull) else OP_ISNOTNULL, T_BOOL, a=r)
        if isinstance(e, Case):
            return self.case(e)
        if isinstance(e, ScalarFunction):
            return self.function(e)
        raise Unsupported(type(e).__name__)

    def cast(self, e: Cast) -> int:
        folded = self.constant_value(e)
        if folded is not None:
            return self.const(folded[0], value_type(folded[1]))
        src_dt = e.expr.get_type(self.schema)
        target = e.data_type
        if DataType.Utf8 in (src_dt, target):
            if src_dt == target:
                return self.lower(e.expr)
            raise Unsupported("a cast to or from Utf8")
        if src_dt is DataType.Null:
            return self.emit(OP_NULL, value_type(target), nullable=True)
        r = self.lower(e.expr)
        if src_dt is DataType.Date32 and target is DataType.Timestamp:
            wide = self.emit(OP_CAST, T_I64, a=r, c=T_I32, nullable=self.nullable[r])
            return self.emit(OP_MUL, T_I64, a=wide, b=self.const(86400, T_I64), nullable=self.nullable[r])
        if src_dt is DataType.Timestamp and target is DataType.Date32:
            return self.emit(OP_DATE, T_I32, a=r, b=T_I64, c=DATE_FIELDS["days"], nullable=self.nullable[r])
        return self.emit(OP_CAST, value_type(target), a=r, c=value_type(src_dt), nullable=self.nullable[r])

    def binary(self, e: BinaryExpr) -> int:
        op = e.op
        if op in (Operator.Like, Operator.NotLike):
            raise Unsupported("LIKE (a dictionary lookup table)")
        if is_string_comparison(e, self.schema):
            return self.string_cmp(strip_utf8_cast(e.left), op, strip_utf8_cast(e.right))
        if op in (Operator.And, Operator.Or):
            a, b = self.lower(e.left), self.lower(e.right)
            return self.emit(OP_AND if op is Operator.And else OP_OR, T_BOOL, a=a, b=b,
                             nullable=self.nullable[a] or self.nullable[b])
        if op in _CMP_OPS:
            t = value_type(e.left.get_type(self.schema))
            a, b = self.lower(e.left), self.lower(e.right)
            return self.emit(_CMP_OPS[op], t, a=a, b=b, nullable=self.nullable[a] or self.nullable[b])
        if op in _ARITH_OPS:
            out_dt = e.get_type(self.schema)
            t = value_type(out_dt)
            a, b = self.lower(e.left), self.lower(e.right)
            nullable = self.nullable[a] or self.nullable[b]
            if op in (Operator.Divide, Operator.Modulus) and t not in (T_F32, T_F64):
                # integer x/0 and x%0 are NULL; a non-zero literal divisor
                # leaves the validity as it was
                k = self.constant_value(e.right)
                nullable = nullable or k is None or k[0] == 0
            return self.emit(_ARITH_OPS[op], t, a=a, b=b, nullable=nullable)
        raise Unsupported(f"operator {op}")

    def string_cmp(self, lraw, op, rraw) -> int:
        """Utf8 comparisons on dictionary codes, resolved at plan time."""
        if isinstance(lraw, Literal) and not isinstance(rraw, Literal):
            flip = {Operator.Lt: Operator.Gt, Operator.LtEq: Operator.GtEq,
                    Operator.Gt: Operator.Lt, Operator.GtEq: Operator.LtEq}
            lraw, rraw, op = rraw, lraw, flip.get(op, op)
        if isinstance(lraw, Literal):
            raise Unsupported("a comparison of two Utf8 literals")
        if not isinstance(lraw, Column):
            raise Unsupported("a Utf8 expression other than a column")
        vocab = self.dicts[lraw.index]
        if isinstance(rraw, Column):
            if self.dicts[rraw.index] != vocab:
                raise Unsupported("Utf8 columns with different dictionaries")
            a, b = self.lower(lraw), self.lower(rraw)
            return self.emit(_CMP_OPS[op], T_I32, a=a, b=b, nullable=self.nullable[a] or self.nullable[b])
        if not isinstance(rraw, Literal) or vocab is None:
            raise Unsupported("a Utf8 comparison operand")
        lo, hi = dict_literal_bounds(vocab, rraw.value.value)
        d = self.lower(lraw)
        nl = self.nullable[d]
        if op in (Operator.Eq, Operator.NotEq) and lo == hi:
            # literal absent from the vocabulary: constant, inner validity
            k = self.const(op is Operator.NotEq, T_BOOL)
            return self.emit(OP_KEEPV, T_BOOL, a=k, b=d, nullable=nl)
        code_op, bound = {
            Operator.Eq: (OP_EQ, lo), Operator.NotEq: (OP_NE, lo),
            Operator.Lt: (OP_LT, lo), Operator.LtEq: (OP_LT, hi),
            Operator.Gt: (OP_GE, hi), Operator.GtEq: (OP_GE, lo),
        }[op]
        return self.emit(code_op, T_I32, a=d, b=self.const(bound, T_I32), nullable=nl)

    def case(self, e: Case) -> int:
        out_dt = e.get_type(self.schema)
        t = value_type(out_dt)
        if out_dt is DataType.Utf8:
            raise Unsupported("a Utf8 CASE")

        def arm(x) -> int:
            r = self.lower(x)
            xt = x.get_type(self.schema)
            if value_type(xt) == t or xt is DataType.Null:
                return r
            return self.emit(OP_CAST, t, a=r, c=value_type(xt), nullable=self.nullable[r])

        acc = arm(e.else_expr) if e.else_expr is not None else self.emit(OP_NULL, t, nullable=True)
        # later WHEN arms lose to earlier ones: fold back-to-front
        for cond, res in reversed(e.branches):
            c = self.lower(cond)
            r = arm(res)
            acc = self.emit(OP_SELECT, t, a=c, b=r, c=acc, nullable=self.nullable[r] or self.nullable[acc])
        return acc

    def function(self, e: ScalarFunction) -> int:
        low = e.name.lower()
        if is_date_function(low):
            return self.date_function(e)
        args = [self.lower(a) for a in e.args]
        if any(a.get_type(self.schema) is not DataType.Float64 for a in e.args):
            raise Unsupported(f"{e.name} on non-Float64 arguments")
        nl = any(self.nullable[a] for a in args)
        if low in ("degrees", "radians") and len(args) == 1:
            k = self.const(180.0 / math.pi if low == "degrees" else math.pi / 180.0, T_F64)
            return self.emit(OP_MUL, T_F64, a=args[0], b=k, nullable=nl)
        if low in MATH1 and len(args) == 1:
            return self.emit(OP_MATH1, T_F64, a=args[0], c=MATH1[low], nullable=nl)
        if low in ("round", "trunc") and len(args) == 1:
            args.append(self.const(0.0, T_F64))
        if low in MATH2 and len(args) == 2:
            return self.emit(OP_MATH2, T_F64, a=args[0], b=args[1], c=MATH2[low], nullable=nl)
        raise Unsupported(f"function {e.name}")

    def date_function(self, e: ScalarFunction) -> int:
        """EXTRACT fields, DATE_TRUNC and the planner's INTERVAL functions
        over a Date32 (int32 days) or Timestamp (int64 seconds) operand:
        one opcode each; adding days or seconds is an integer ADD that
        wraps at the operand's width."""
        low = e.name.lower()
        src = e.args[0].get_type(self.schema)
        if src not in (DataType.Date32, DataType.Timestamp):
            raise Unsupported(f"{e.name} of {src}")
        st = value_type(src)
        r = self.lower(e.args[0])
        nl = self.nullable[r]
        if low in dates.INTERVAL_FUNCTIONS:
            n = int(e.args[1].value.value)
            kt = T_I64 if low == "ts_add_seconds" else T_I32
            bits = 64 if kt == T_I64 else 32
            if not -(1 << (bits - 1)) <= n < 1 << (bits - 1):
                raise Unsupported(f"{e.name} by {n}, past int{bits}")
            op = OP_ADDMONTHS if low.startswith("add_months") else OP_ADD
            return self.emit(op, st, a=r, b=self.const(n, kt), nullable=nl)
        if low.startswith("date_trunc_"):
            return self.emit(OP_DTRUNC, st, a=r, c=TRUNC_UNITS[low[len("date_trunc_"):]], nullable=nl)
        return self.emit(OP_DATE, T_I64 if low == "epoch" else T_I32, a=r, b=st, c=DATE_FIELDS[low], nullable=nl)


def build_program(
    schema, dicts, nullable: Sequence[bool], predicate: Optional[Expr], computed: Sequence[Expr],
    fn_registry: Optional[dict] = None,
) -> Program:
    """Lower the predicate and each computed expression into one Program,
    one register per instruction (the limits apply here). Raises
    Unsupported when anything falls outside the opcode set."""
    for name, fn in (fn_registry or {}).items():
        if name in SCALAR_FUNCTIONS and fn is not SCALAR_FUNCTIONS[name]:
            raise Unsupported(f"user function overriding {name}")
    b = ProgramBuilder(schema, dicts, nullable)
    if predicate is not None:
        if predicate.get_type(schema) is not DataType.Boolean:
            raise Unsupported("a non-boolean predicate")
        b.p.sel_reg = b.lower(predicate)
    for e in computed:
        dt = e.get_type(schema)
        r = b.lower(e)
        b.p.outputs.append((r, value_type(dt), b.nullable[r]))
    if len(b.p.outputs) > MAX_OUT:
        raise Unsupported(f"more than {MAX_OUT} computed columns")
    b.p.n_regs = len(b.nullable)
    return b.p


def compile_program(
    schema, dicts, nullable: Sequence[bool], predicate: Optional[Expr], computed: Sequence[Expr],
    fn_registry: Optional[dict] = None,
) -> Program:
    """The program the kernel runs: `build_program`'s, with constants
    folded into operands and its registers allocated."""
    return allocate_registers(fold_immediates(build_program(schema, dicts, nullable, predicate, computed,
                                                            fn_registry)))


# registers each opcode reads: operand a, b (unless an immediate), c
_READS_A = frozenset(range(OP_ADD, OP_ADDMONTHS + 1))
_READS_B = frozenset(range(OP_ADD, OP_OR + 1)) | {OP_SELECT, OP_KEEPV, OP_MATH2, OP_ADDMONTHS}
_IMM_B = _READS_B - {OP_KEEPV}  # KEEPV reads b's validity only


def _operands(row) -> tuple[bool, bool, bool]:
    """Which of instruction `row`'s operands a, b, c name registers."""
    op, imm = row[0], row[6]
    return op in _READS_A, op in _READS_B and not imm, op == OP_SELECT


def _reads(row) -> list[int]:
    """The registers instruction `row` reads."""
    return [x for x, is_reg in zip(row[3:6], _operands(row)) if is_reg]


def _pinned(p: Program) -> set:
    """Registers read after the code: the selection and the outputs."""
    return {r for r, _, _ in p.outputs} | ({p.sel_reg} if p.sel_reg >= 0 else set())


def fold_immediates(p: Program) -> Program:
    """Constants as operands: an instruction whose second operand is a
    CONST's register names the constant instead, and instructions whose
    register nothing reads (those CONSTs) are dropped. `p` is the
    builder's program, where every register is written once."""
    const_of = {row[2]: (row[3], row[1]) for row in p.code if row[0] == OP_CONST}
    code = []
    for row in p.code:
        op, ty, d, a, b, c, imm, imm_ty = row
        if op in _IMM_B and not imm and b in const_of:
            k, kt = const_of[b]
            row = (op, ty, d, a, k, c, 1, kt)
        code.append(row)
    live, kept = _pinned(p), []
    for row in reversed(code):
        if row[2] in live:
            live.discard(row[2])
            live.update(_reads(row))
            kept.append(row)
    return replace(p, code=kept[::-1], c_program=None)


def allocate_registers(p: Program) -> Program:
    """Map `p`'s registers (each written once) onto the fewest physical
    ones by liveness over the linear code: a register is free after its
    last read, and the selection and the outputs stay live to the end.
    An instruction may write the register one of its operands frees."""
    pinned = _pinned(p)
    last = {}
    for i, row in enumerate(p.code):
        for r in _reads(row):
            last[r] = i
    free, phys, code = list(range(MAX_REGS)), {}, []
    for i, row in enumerate(p.code):
        op, ty, d, a, b, c, imm, imm_ty = row
        regs = _reads(row)
        a, b, c = (phys[x] if is_reg else x for x, is_reg in zip((a, b, c), _operands(row)))
        for r in set(regs):
            if last[r] == i and r not in pinned:
                heapq.heappush(free, phys[r])
        phys[d] = heapq.heappop(free)
        code.append((op, ty, phys[d], a, b, c, imm, imm_ty))
    return replace(p, code=code, outputs=[(phys[r], t, nl) for r, t, nl in p.outputs],
                   sel_reg=phys[p.sel_reg] if p.sel_reg >= 0 else -1, n_regs=max(phys.values(), default=-1) + 1,
                   c_program=None)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


_STORAGE = {t: torch_dtype(dt) for t, dt in _LOGICAL.items()}


def _storage(t: int) -> torch.dtype:
    return _STORAGE[t]


def _math1(f: int, x: torch.Tensor) -> torch.Tensor:
    fns = (torch.sqrt, torch.abs, torch.exp, torch.log, torch.log10, torch.log2,
           torch.sin, torch.cos, torch.tan, torch.asin, torch.acos, torch.atan,
           torch.floor, torch.ceil, sql_sign)
    return fns[f](x)


def _math2(f: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if f == 0:
        return torch.pow(x, y)
    if f == 1:
        return torch.fmod(x, y)
    if f == 2:
        return torch.atan2(x, y)
    m = torch.pow(10.0, y)
    v = x * m
    if f == 3:
        return sql_sign(v) * torch.floor(torch.abs(v) + 0.5) / m
    return torch.trunc(v) / m


def _date_field(f: int, timestamp: bool):
    field = _DATE_FIELD_NAMES[f]
    return dates.ts_to_date if field == "days" else dates.extract_function(field, timestamp)


def _const_tensor(bits: int, t: int, dev) -> torch.Tensor:
    """A constant's 64-bit pattern as a 0-d tensor of its type's storage."""
    bits = np.array(bits, np.int64)
    if t in (T_F32, T_F64):
        return torch.tensor(float(bits.view(np.float64)), dtype=_storage(t), device=dev)
    return torch.tensor(int(bits), device=dev).to(_storage(t))


def evaluate_plain(
    program: Program,
    in_data: Sequence[torch.Tensor],
    in_valid: Sequence[Optional[torch.Tensor]],
    n: int,
) -> tuple[Optional[torch.Tensor], list[tuple[torch.Tensor, Optional[torch.Tensor]]]]:
    """The kernel's function in plain PyTorch: (sel or None, [(data,
    validity or None) per output]). Inputs are the program's input
    columns in `program.inputs` order."""
    dev = in_data[0].device if in_data else torch.device("cpu")
    true = torch.ones((), dtype=torch.bool, device=dev)
    vals: list = [None] * program.n_regs
    valid: list = [None] * program.n_regs  # None = all valid

    def v_of(v):
        return true if v is None else v

    def both(x, y):
        if x is None:
            return y
        if y is None:
            return x
        return x & y

    for op, t, d, a, b, c, imm, imm_ty in program.code:
        vd, y, vy = None, None, None
        # operand b: a register, or the immediate consts[b] (always valid)
        if imm:
            y, vy = _const_tensor(program.consts[b], imm_ty, dev), None
        elif op in _READS_B:
            y, vy = vals[b], valid[b]
        if op == OP_LOAD:
            out, vd = in_data[a], in_valid[a]
        elif op == OP_CONST:
            out = _const_tensor(program.consts[a], t, dev)
        elif op == OP_NULL:
            out = torch.zeros((), dtype=_storage(t), device=dev)
            vd = torch.zeros((), dtype=torch.bool, device=dev)
        elif op in (OP_ADD, OP_SUB, OP_MUL):
            fn = {OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul}[op]
            out = wrap_to(fn(vals[a], y), _LOGICAL[t])
            vd = both(valid[a], vy)
        elif op in (OP_DIV, OP_MOD):
            x = vals[a]
            vd = both(valid[a], vy)
            if t in (T_F32, T_F64):
                out = torch.div(x, y) if op == OP_DIV else torch.fmod(x, y)
            else:
                out = wrap_to(int_div(x, y, mod=op == OP_MOD), _LOGICAL[t])
                nz = y != 0
                vd = nz if vd is None else vd & nz
        elif OP_EQ <= op <= OP_GE:
            fn = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)[op - OP_EQ]
            out = fn(vals[a], y)
            vd = both(valid[a], vy)
        elif op in (OP_AND, OP_OR):
            fn = torch.logical_and if op == OP_AND else torch.logical_or
            out = fn(vals[a] != 0, y != 0)
            vd = both(valid[a], vy)
        elif op == OP_CAST:
            out = cast_tensor(vals[a], _LOGICAL[t])
            vd = valid[a]
        elif op == OP_ISNULL:
            out = torch.logical_not(v_of(valid[a]))
        elif op == OP_ISNOTNULL:
            out = v_of(valid[a])
        elif op == OP_SELECT:
            take = (vals[a] != 0) & v_of(valid[a])
            out = torch.where(take, y, vals[c])
            vd = None if vy is None and valid[c] is None else torch.where(take, v_of(vy), v_of(valid[c]))
        elif op == OP_KEEPV:
            out, vd = vals[a], vy
        elif op == OP_MATH1:
            out, vd = _math1(c, vals[a]), valid[a]
        elif op == OP_MATH2:
            out, vd = _math2(c, vals[a], y), both(valid[a], vy)
        elif op == OP_DATE:
            out, vd = _date_field(c, b == T_I64)(vals[a]), valid[a]
        elif op == OP_DTRUNC:
            out, vd = dates.trunc_function(dates.DATE_TRUNC_UNITS[c], t == T_I64)(vals[a]), valid[a]
        elif op == OP_ADDMONTHS:
            add = dates.add_months_seconds if t == T_I64 else dates.add_months_days
            out, vd = add(vals[a], y), both(valid[a], vy)
        else:
            raise ValueError(f"bad opcode {op}")
        vals[d], valid[d] = out, vd

    def full(x, dtype):
        return x.to(dtype).expand(n).contiguous()

    sel = None
    if program.sel_reg >= 0:
        s = program.sel_reg
        sel = full((vals[s] != 0) & v_of(valid[s]), torch.bool)  # NULL predicate drops
    outs = []
    for r, t, nullable in program.outputs:
        data = full(vals[r], _storage(t))
        outs.append((data, full(v_of(valid[r]), torch.bool) if nullable else None))
    return sel, outs


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


class _Instr(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint8) for n in ("op", "ty", "dst", "a", "b", "c", "imm", "imm_ty")]


class _CProgram(ctypes.Structure):
    _fields_ = [
        ("consts", ctypes.c_longlong * MAX_CONST),
        ("in_data", ctypes.c_void_p * MAX_IN),
        ("in_valid", ctypes.c_void_p * MAX_IN),
        ("out_data", ctypes.c_void_p * MAX_OUT),
        ("out_valid", ctypes.c_void_p * MAX_OUT),
        ("sel", ctypes.c_void_p),
        ("n_instr", ctypes.c_int),
        ("n_in", ctypes.c_int),
        ("n_out", ctypes.c_int),
        ("sel_reg", ctypes.c_int),
        ("in_type", ctypes.c_int * MAX_IN),
        ("out_type", ctypes.c_int * MAX_OUT),
        ("out_reg", ctypes.c_int * MAX_OUT),
        ("code", _Instr * MAX_INSTR),
    ]


def c_program(program: Program) -> _CProgram:
    """The kernel's `Program` struct for `program`, built once and kept on
    it; each call fills in only the pointers (`bind_program`)."""
    cp = program.c_program
    if cp is None:
        if len(program.code) > MAX_INSTR or program.n_regs > MAX_REGS or len(program.consts) > MAX_CONST:
            raise ValueError("program exceeds the kernel's capacity")
        cp = _CProgram()
        cp.consts[: len(program.consts)] = program.consts
        cp.in_type[: len(program.inputs)] = program.input_types
        cp.out_type[: len(program.outputs)] = [t for _, t, _ in program.outputs]
        cp.out_reg[: len(program.outputs)] = [r for r, _, _ in program.outputs]
        cp.n_instr, cp.n_in, cp.n_out, cp.sel_reg = (
            len(program.code), len(program.inputs), len(program.outputs), program.sel_reg,
        )
        for i, row in enumerate(program.code):
            cp.code[i] = _Instr(*row)
        program.c_program = cp
    return cp


def bind_program(cp: _CProgram, in_data, in_valid, outs, sel) -> None:
    """Point `cp` at one call's tensors: inputs, (data, validity) outputs
    and the selection (validity and sel may be None)."""

    def ptr(t):
        return None if t is None else t.data_ptr()

    cp.in_data[: len(in_data)] = [ptr(d) for d in in_data]
    cp.in_valid[: len(in_valid)] = [ptr(v) for v in in_valid]
    cp.out_data[: len(outs)] = [ptr(d) for d, _ in outs]
    cp.out_valid[: len(outs)] = [ptr(v) for _, v in outs]
    cp.sel = ptr(sel)


# a block's threads, and the 8-byte register slots (n_regs x rows) a thread
# may hold: 64 KB of shared memory a block
THREADS, TILE_REGS = 256, 32


def tile_rows(n_regs: int) -> int:
    """Rows per thread of the kernel's tile: the largest of 8, 4, 2, 1
    whose register file, n_regs x rows x THREADS 8-byte slots, stays
    within 64 KB of shared memory (R = 8 at 4 registers, 1 at 32)."""
    for r in (8, 4, 2):
        if n_regs * r <= TILE_REGS:
            return r
    return 1


def _check_inputs(program, in_data, in_valid, n, device):
    if len(in_data) != len(program.inputs) or len(in_valid) != len(program.inputs):
        raise ValueError("one data and one validity entry per program input")
    for t, d, v in zip(program.input_types, in_data, in_valid):
        if d.device != device or d.dim() != 1 or d.shape[0] != n or not d.is_contiguous():
            raise ValueError("inputs must be contiguous 1-D tensors of n rows on one device")
        if d.dtype != _storage(t):
            raise ValueError(f"input dtype {d.dtype} != program type {_storage(t)}")
        if v is not None and (v.device != device or v.dtype != torch.bool or v.shape != d.shape
                              or not v.is_contiguous()):
            raise ValueError("validity must be a contiguous bool tensor like its column")


@spanned("dft.kernel.K1")
def run_fused(
    program: Program,
    in_data: Sequence[torch.Tensor],
    in_valid: Sequence[Optional[torch.Tensor]],
    n: int,
    device,
):
    """Evaluate `program` over `n` rows: (sel or None, [(data, validity or
    None)]). CPU tensors take `evaluate_plain`; CUDA tensors launch the
    kernel (or raise)."""
    device = torch.device(device)
    if device.type == "cpu":
        _check_inputs(program, in_data, in_valid, n, device)
        return evaluate_plain(program, in_data, in_valid, n)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _check_inputs(program, in_data, in_valid, n, device)
    cp = c_program(program)
    outs = [(torch.empty(n, dtype=_storage(t), device=device),
             torch.empty(n, dtype=torch.bool, device=device) if nullable else None)
            for _, t, nullable in program.outputs]
    sel = torch.empty(n, dtype=torch.bool, device=device) if program.sel_reg >= 0 else None
    if n > 0:
        bind_program(cp, in_data, in_valid, outs, sel)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            check(lib.dft_fused_stage(ctypes.byref(cp), n, program.n_regs, tile_rows(program.n_regs), stream),
                  "fused_stage kernel")
        run_fused.launches += 1
    return sel, outs


run_fused.launches = 0
