"""K1 — fused scan -> filter -> project stage: ONE pass over the inputs.

Port of datafusion_tpu/ops/pallas/fused_stage.py `run_fused`. The Pallas
kernel traced a closure of compiled JAX expressions; here the plan
compiler lowers the predicate and every computed projection into a
short linear register `Program` (`compile_program`), and one CUDA kernel
(csrc/fused_stage.cu) interprets it row by row, reading each referenced
input column once and writing the selection mask plus each computed
column (and its validity) once.

The opcode set IS the plan-time whitelist: `compile_program` raises
`Unsupported` for anything outside it, and the compiler then keeps the
plain torch projection path (decided at plan time, recorded in the
plan's notes). `evaluate_plain` is the same function in plain PyTorch:
the CPU tests run it, and chip_smoke.py holds the kernel against it.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_tpu_torch.ops.expr_eval import (
    SCALAR_FUNCTIONS,
    cast_tensor,
    dict_literal_bounds,
    int_div,
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
) = range(23)

MATH1 = {
    "sqrt": 0, "abs": 1, "exp": 2, "log": 3, "ln": 3, "log10": 4, "log2": 5,
    "sin": 6, "cos": 7, "tan": 8, "asin": 9, "acos": 10, "atan": 11,
    "floor": 12, "ceil": 13, "sign": 14,
}
MATH2 = {"power": 0, "pow": 0, "mod": 1, "atan2": 2, "round": 3, "trunc": 4}

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
    """A linear register program. `code` rows are (op, type, dst, a, b, c);
    `inputs` are table column indices (LOAD's `a` indexes this list);
    `outputs` are (register, type, nullable) per computed expression."""

    code: list = field(default_factory=list)
    consts: list = field(default_factory=list)  # 64-bit patterns
    inputs: list = field(default_factory=list)
    input_types: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    sel_reg: int = -1
    n_regs: int = 0


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
        self.p.code.append((op, ty, dst, a, b, c))
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
            raise Unsupported("Timestamp -> Date32 (floor division)")
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


def compile_program(
    schema, dicts, nullable: Sequence[bool], predicate: Optional[Expr], computed: Sequence[Expr],
    fn_registry: Optional[dict] = None,
) -> Program:
    """Lower the predicate and each computed expression into one Program.
    Raises Unsupported when anything falls outside the opcode set."""
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


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _storage(t: int) -> torch.dtype:
    return torch_dtype(_LOGICAL[t])


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

    def v_of(r):
        return true if valid[r] is None else valid[r]

    def both(a, b):
        if valid[a] is None:
            return valid[b]
        if valid[b] is None:
            return valid[a]
        return valid[a] & valid[b]

    for op, t, d, a, b, c in program.code:
        vd = None
        if op == OP_LOAD:
            out, vd = in_data[a], in_valid[a]
        elif op == OP_CONST:
            bits = np.array(program.consts[a], np.int64)
            if t in (T_F32, T_F64):
                out = torch.tensor(float(bits.view(np.float64)), dtype=_storage(t), device=dev)
            else:
                out = torch.tensor(int(bits), device=dev).to(_storage(t))
        elif op == OP_NULL:
            out = torch.zeros((), dtype=_storage(t), device=dev)
            vd = torch.zeros((), dtype=torch.bool, device=dev)
        elif op in (OP_ADD, OP_SUB, OP_MUL):
            fn = {OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul}[op]
            out = wrap_to(fn(vals[a], vals[b]), _LOGICAL[t])
            vd = both(a, b)
        elif op in (OP_DIV, OP_MOD):
            x, y = vals[a], vals[b]
            vd = both(a, b)
            if t in (T_F32, T_F64):
                out = torch.div(x, y) if op == OP_DIV else torch.fmod(x, y)
            else:
                out = wrap_to(int_div(x, y, mod=op == OP_MOD), _LOGICAL[t])
                nz = y != 0
                vd = nz if vd is None else vd & nz
        elif OP_EQ <= op <= OP_GE:
            fn = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)[op - OP_EQ]
            out = fn(vals[a], vals[b])
            vd = both(a, b)
        elif op in (OP_AND, OP_OR):
            fn = torch.logical_and if op == OP_AND else torch.logical_or
            out = fn(vals[a] != 0, vals[b] != 0)
            vd = both(a, b)
        elif op == OP_CAST:
            out = cast_tensor(vals[a], _LOGICAL[t])
            vd = valid[a]
        elif op == OP_ISNULL:
            out = torch.logical_not(v_of(a))
        elif op == OP_ISNOTNULL:
            out = v_of(a)
        elif op == OP_SELECT:
            take = (vals[a] != 0) & v_of(a)
            out = torch.where(take, vals[b], vals[c])
            vd = None if valid[b] is None and valid[c] is None else torch.where(take, v_of(b), v_of(c))
        elif op == OP_KEEPV:
            out, vd = vals[a], valid[b]
        elif op == OP_MATH1:
            out, vd = _math1(c, vals[a]), valid[a]
        elif op == OP_MATH2:
            out, vd = _math2(c, vals[a], vals[b]), both(a, b)
        else:
            raise ValueError(f"bad opcode {op}")
        vals[d], valid[d] = out, vd

    def full(x, dtype):
        return x.to(dtype).expand(n).contiguous()

    sel = None
    if program.sel_reg >= 0:
        s = program.sel_reg
        sel = full((vals[s] != 0) & v_of(s), torch.bool)  # NULL predicate drops
    outs = []
    for r, t, nullable in program.outputs:
        data = full(vals[r], _storage(t))
        outs.append((data, full(v_of(r), torch.bool) if nullable else None))
    return sel, outs


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


class _Instr(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint8) for n in ("op", "ty", "dst", "a", "b", "c", "pad0", "pad1")]


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
    if lib.dft_fused_stage_program_size() != ctypes.sizeof(_CProgram):
        raise RuntimeError("Program layout differs between Python and CUDA")
    cp = _CProgram()
    for i, k in enumerate(program.consts):
        cp.consts[i] = k
    for i, (d, v) in enumerate(zip(in_data, in_valid)):
        cp.in_data[i] = d.data_ptr()
        cp.in_valid[i] = None if v is None else v.data_ptr()
        cp.in_type[i] = program.input_types[i]
    outs = []
    for o, (r, t, nullable) in enumerate(program.outputs):
        data = torch.empty(n, dtype=_storage(t), device=device)
        val = torch.empty(n, dtype=torch.bool, device=device) if nullable else None
        cp.out_data[o] = data.data_ptr()
        cp.out_valid[o] = None if val is None else val.data_ptr()
        cp.out_type[o] = t
        cp.out_reg[o] = r
        outs.append((data, val))
    sel = None
    if program.sel_reg >= 0:
        sel = torch.empty(n, dtype=torch.bool, device=device)
        cp.sel = sel.data_ptr()
    cp.n_instr, cp.n_in, cp.n_out, cp.sel_reg = (
        len(program.code), len(program.inputs), len(program.outputs), program.sel_reg,
    )
    for i, row in enumerate(program.code):
        cp.code[i] = _Instr(*row, 0, 0)
    if n > 0:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            check(lib.dft_fused_stage(ctypes.byref(cp), n, stream), "fused_stage kernel")
        run_fused.launches += 1
    return sel, outs


run_fused.launches = 0
