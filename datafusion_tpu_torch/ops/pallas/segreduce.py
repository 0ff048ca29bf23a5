"""K2 — segmented reduce: per-group SUM / COUNT / MIN / MAX.

Port of datafusion_tpu/ops/pallas/segreduce.py `segmented_reduce_sorted`.
`segmented_reduce` reduces `values[a]` into `[num_groups]` slots by
`gid`, per op:

  * SUM accumulates in f64 for float values and in i64 for integers
    (the TPU kernel's f32 sums were a narrowing of the TPU, not part of
    the contract); NaN and +-inf sum the IEEE way, so the JAX package's
    sanitize pass and `ieee_sum_cond` restore have no counterpart
  * COUNT is i64
  * MIN/MAX keep the value dtype; f32/f64 reduce on their order-
    preserving integer image (NaN sorts past +inf, -0.0 equals +0.0), and
    a slot no row reached reads +inf / -inf, as in the TPU kernel

Rows with an id outside [0, num_groups) are dropped. A per-op mask of
None means every (kept) row contributes; a value of None is a COUNT.
Sorted mode (`dense=False`) requires ascending ids with the dropped rows
in the tail — what the grouped aggregate's co-sort produces. Dense mode
takes ids in any order with num_groups <= DENSE_MAX_SLOTS (the sort-free
GROUP BY for small key domains). Sorted mode reduces every op in one
launch, or in the fewest launches of at most FOLD_MAX_OPS ops
(`sorted_launch_ops`); dense mode in the fewest launches whose tables fit
a block's shared memory (`fold_launches`, shared with K4 and K6). Both
write the fold tables of `fold_tables` and return them as the outputs.

A float SUM on the card gives the same bits in every run
(csrc/reduce_common.cuh states the contract):
  * on the fold tile (dense mode, K4, K6) for any order of the launch's
    rows and any schedule of its blocks: it is added in fixed point by
    integer atomics. E is the exponent of the largest finite |value|
    among the launch's kept rows, found by a first pass on the card (for
    K4 on the main path, by K3: ops/pallas/partition.py `SlabFold`); each
    value is three signed 32-bit digits on the grid 2^(E-95), rounded to
    nearest in the last, summed exactly (in shared memory as 32-bit words
    of 16 bits each, in device memory in int64), with a fourth table for
    the NaN / +inf / -inf flags; the exact total is rounded once to f64.
    A slot of n rows is within n * 2^(E-96) of the exact sum plus half an
    ulp of the result, so a value more than 95 bits below the launch's
    largest is rounded to the grid. `fixed_sum_plain` is this function in
    plain PyTorch; the kernels equal it bit for bit. A launch takes fewer
    than 2^31 rows (the totals' headroom).
  * in sorted mode for the same rows in the same order on the same card:
    f64 in row order within a warp's span, and the runs that cross spans
    added in span order.
IEEE outcomes hold in both: any NaN gives NaN, +inf with -inf NaN, one
infinity itself; a slot no row reached reads +0.0; finite values whose
exact total overflows give +-inf.

CPU tensors take `segmented_reduce_plain`, whose `index_add_` sums in row
order (the JAX package's bits); CUDA tensors launch csrc/segreduce.cu (or
raise).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

from datafusion_tpu_torch.utils.trace import spanned

DENSE_MAX_SLOTS = 2048
OPS = ("sum", "count", "min", "max")
# the fold tile's shared tables (csrc/reduce_common.cuh), counted in units
# of one table of 8-byte slots: one unit an op, FIX_TABLES a float SUM (its
# six 4-byte words a slot); COUNT and 32-bit MIN/MAX take half a unit's
# bytes on the card, so a launch fits what these units say
FOLD_SMEM_BYTES = 230400  # dynamic shared memory of one launch: Hopper's 232,448 a block, less the static arrays
FOLD_MAX_OPS = 32  # DFT_FOLD_MAX_OPS: ops, and shared tables, of one launch
MAX_REPLICAS = 32  # DFT_MAX_REPS: one replica per lane of a warp
REPLICA_BUDGET = 57344  # replicas grow while a block's tables stay within this: four 512-thread blocks an SM
VALUE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
FIX_DEVICE_TABLES = 4  # a fixed-point float SUM's device tables: its digits 0-2 and its flags
FIX_TABLES = 3  # DFT_FIX_TABLES, its shared units: the digits (the flags go straight to the device table)
FIX_MAX_ROWS = 2**31 - 1  # DFT_FIX_MAX_ROWS: rows a launch with a float SUM folds (the int64 totals' headroom)
SORTED_BLOCK_ROWS = 16 * 32 * 4  # a sorted-mode block's 16 warps' first tiles
SORTED_MAX_BLOCKS = 1024  # csrc/segreduce.cu SORTED_MAX_BLOCKS
EDGE_SLOT_BYTES = 16  # csrc/segreduce.cu EdgeSlot

# kernel op kinds (csrc/segreduce.cu)
_KIND = {
    ("sum", torch.float32): 0, ("sum", torch.float64): 1,
    ("sum", torch.int32): 2, ("sum", torch.int64): 3, ("count", None): 4,
    ("min", torch.float32): 5, ("max", torch.float32): 6,
    ("min", torch.float64): 7, ("max", torch.float64): 8,
    ("min", torch.int32): 9, ("max", torch.int32): 10,
    ("min", torch.int64): 11, ("max", torch.int64): 12,
}
# the fold tile's float SUM, in fixed point
_FIX = {torch.float32: 13, torch.float64: 14}
_IMAGE = {torch.float32: torch.int32, torch.float64: torch.int64}


def to_sortable_int(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving float -> signed int image (sign-magnitude to
    two's complement); identity for integers. NaN maps past +inf."""
    if not x.dtype.is_floating_point:
        return x
    it = _IMAGE[x.dtype]
    bits = x.contiguous().view(it)
    lo = torch.iinfo(it).min
    return torch.where(bits < 0, lo - bits, bits)


def from_sortable_int(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of to_sortable_int."""
    if not dtype.is_floating_point:
        return bits.to(dtype)
    lo = torch.iinfo(bits.dtype).min
    return torch.where(bits < 0, lo - bits, bits).contiguous().view(dtype)


def _table_dtype(op: str, v: Optional[torch.Tensor]) -> torch.dtype:
    if op == "count":
        return torch.int64
    if op == "sum":
        return torch.float64 if v.dtype.is_floating_point else torch.int64
    return _IMAGE.get(v.dtype, v.dtype)


def _identity_tables(ops, values, num_groups, device, lead=()) -> list[torch.Tensor]:
    """One `[*lead, num_groups]` table per op, at the op's identity."""
    outs = []
    for op, v in zip(ops, values):
        dt = _table_dtype(op, v)
        if op in ("sum", "count"):
            fill = 0
        else:
            info = torch.iinfo(dt)
            fill = info.max if op == "min" else info.min
        outs.append(torch.full((*lead, num_groups), fill, dtype=dt, device=device))
    return outs


def _out_dtype(op: str, v: Optional[torch.Tensor]) -> torch.dtype:
    """The dtype of an op's result: f64/i64 SUM, i64 COUNT, value-dtype MIN/MAX."""
    return v.dtype if op in ("min", "max") else _table_dtype(op, v)


def float_sum(op: str, v: Optional[torch.Tensor]) -> bool:
    return op == "sum" and v is not None and v.dtype.is_floating_point


def fold_widths(ops, values) -> list[int]:
    """The shared tables of each op on the fold tile: FIX_TABLES for a
    float SUM (fixed point), else 1."""
    return [FIX_TABLES if float_sum(op, v) else 1 for op, v in zip(ops, values)]


class FoldTables(NamedTuple):
    """The fold kernels' zeroed buffer (`fold_tables`): per op its result
    table, its device table's address and its aux address (0 for none),
    then the launch counters' addresses; with `fixed`, the buffer and
    each float SUM's scale word's byte offset in it (None for other ops).
    """

    tables: list
    outs: list
    aux: list
    counters: list
    buf: Optional[torch.Tensor] = None
    scale_at: list = []

    def scale(self, a: int) -> torch.Tensor:
        """Op a's scale word, a one-element int64 view of the buffer."""
        return self.buf[self.scale_at[a]: self.scale_at[a] + 8].view(torch.int64)


def fold_tables(ops, values, num_groups, device, lead=(), counters=1, fixed=False, edge_blocks=0) -> FoldTables:
    """The fold kernels' output tables (csrc/reduce_common.cuh, the fold
    tile): one zeroed buffer that holds, per op, a `[*lead, num_groups]`
    table in the op's result dtype (every identity is 0 bits there), then
    `counters` 8-byte launch counters. With `fixed` (the fold tile), a
    float SUM takes FIX_DEVICE_TABLES int64 tables, one after another,
    and its 8-byte scale word instead, its f64 result ending in the first
    table. With `edge_blocks`
    (sorted mode), each float SUM gets 2 * edge_blocks edge slots after
    the counters."""
    rows = math.prod(lead) * num_groups
    spans, off = [], 0
    for op, v in zip(ops, values):
        if fixed and float_sum(op, v):
            spans.append((off, FIX_DEVICE_TABLES, torch.float64))
            off += FIX_DEVICE_TABLES * rows * 8 + 8
        else:
            dt = _out_dtype(op, v)
            spans.append((off, 1, dt))
            off += -(-rows * dt.itemsize // 8) * 8
    counter_at = off
    off += 8 * counters
    edges = []
    for op, v in zip(ops, values):
        edges.append(off if edge_blocks and float_sum(op, v) else None)
        off += 2 * edge_blocks * EDGE_SLOT_BYTES if edges[-1] is not None else 0
    buf = torch.zeros(off, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    tables = [buf[o: o + rows * dt.itemsize].view(dt) for o, _, dt in spans]
    if lead:
        tables = [t.view(*lead, num_groups) for t in tables]
    outs = [base + o for o, _, _ in spans]
    aux = [base + o + w * rows * 8 if w > 1 else (0 if e is None else base + e) for (o, w, _), e in zip(spans, edges)]
    return FoldTables(tables, outs, aux, [base + counter_at + 8 * c for c in range(counters)], buf,
                      [o + w * rows * 8 if w > 1 else None for o, w, _ in spans])


def op_kind(op: str, v: Optional[torch.Tensor], fixed: bool) -> int:
    """Op `op` over `v`'s kernel kind: on the fold tile (`fixed`) a float
    SUM is the fixed-point kind."""
    if fixed and float_sum(op, v):
        return _FIX[v.dtype]
    return _KIND[(op, None if v is None else v.dtype)]


def c_entries(ops, values, ft: FoldTables, lo: int, hi: int, fixed: bool):
    """Ops lo..hi's C arrays: kinds, device tables and aux (None for none)."""
    k = hi - lo
    return ((ctypes.c_int * k)(*[op_kind(ops[a], values[a], fixed) for a in range(lo, hi)]),
            (ctypes.c_void_p * k)(*ft.outs[lo:hi]),
            (ctypes.c_void_p * k)(*[x or None for x in ft.aux[lo:hi]]))


def c_streams(values, masks, lo: int, hi: int):
    """Ops lo..hi's value and mask pointers as C arrays (None for none)."""

    def ptrs(ts):
        return (ctypes.c_void_p * (hi - lo))(*[None if t is None else t.data_ptr() for t in ts[lo:hi]])

    return ptrs(values), ptrs(masks)


def check_fixed_rows(ops, values, rows: int) -> None:
    """A launch with a float SUM on the fold tile takes at most FIX_MAX_ROWS rows."""
    if rows > FIX_MAX_ROWS and any(float_sum(op, v) for op, v in zip(ops, values)):
        raise ValueError(f"a float SUM on the card folds at most {FIX_MAX_ROWS} rows a launch")


def _finish(ops, values, tables) -> tuple[torch.Tensor, ...]:
    """Float MIN/MAX images back to values; untouched slots read +-inf."""
    res = []
    for op, v, t in zip(ops, values, tables):
        if op in ("min", "max") and v.dtype.is_floating_point:
            info = torch.iinfo(t.dtype)
            empty = t == (info.max if op == "min" else info.min)
            inf = float("inf") if op == "min" else float("-inf")
            t = torch.where(empty, torch.full((), inf, dtype=v.dtype, device=t.device),
                            from_sortable_int(t, v.dtype))
        res.append(t)
    return tuple(res)


def _validate(gid, values, masks, ops, num_groups, dense):
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    if not (len(values) == len(masks) == len(ops)):
        raise ValueError("one value and one mask per op")
    if dense and num_groups > DENSE_MAX_SLOTS:
        raise ValueError(f"dense mode takes at most {DENSE_MAX_SLOTS} groups")
    n = gid.shape[0]
    for op, v, m in zip(ops, values, masks):
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        if (v is None) != (op == "count"):
            raise ValueError("COUNT takes no value; every other op takes one")
        for t in (v, m):
            if t is not None and (t.device != gid.device or t.dim() != 1 or t.shape[0] != n
                                  or not t.is_contiguous()):
                raise ValueError("values and masks must be contiguous 1-D tensors like gid")
        if v is not None and v.dtype not in VALUE_DTYPES:
            raise ValueError(f"value dtype {v.dtype} (takes f32/f64/i32/i64)")
        if m is not None and m.dtype != torch.bool:
            raise ValueError("masks must be bool")


def sorted_launch_ops(n_ops: int) -> list[tuple[int, int]]:
    """How sorted mode covers `n_ops` ops: `(first op, stop)` per launch,
    the fewest launches of at most FOLD_MAX_OPS ops, split evenly."""
    return _weighted_split([1] * n_ops, FOLD_MAX_OPS) if n_ops else []


def _weighted_split(tables: Sequence[int], cap: int) -> list[tuple[int, int]]:
    """Ops of `tables` shared tables each split into the fewest runs of
    consecutive ops within FOLD_MAX_OPS ops and `cap` tables, as evenly as
    they go: the cuts at i * total // n where those runs fit (always, when
    every op takes one table: the exact splits that test_fold_launches and
    test_sorted_launch_ops hold), else the runs of a greedy fill under the
    smallest table cap that needs no more runs (a float SUM's three tables
    can leave an even cut over a cap)."""
    cum = [0]
    for t in tables:
        cum.append(cum[-1] + t)

    def fits(lo, hi):
        return hi - lo <= FOLD_MAX_OPS and cum[hi] - cum[lo] <= cap

    total = cum[-1]
    n = max(1, -(-len(tables) // FOLD_MAX_OPS), -(-total // cap))
    while True:
        cuts = [0] + [max(a for a in range(len(tables) + 1) if cum[a] <= i * total // n) for i in range(1, n)]
        runs = [(lo, hi) for lo, hi in zip(cuts, cuts[1:] + [len(tables)]) if hi > lo]
        if all(fits(lo, hi) for lo, hi in runs):
            return runs
        for c in range(-(-total // n), cap + 1):
            runs, lo = [], 0
            for a in range(len(tables)):
                if a > lo and (cum[a + 1] - cum[lo] > c or not fits(lo, a + 1)):
                    runs.append((lo, a))
                    lo = a
            runs.append((lo, len(tables)))
            if len(runs) <= n:
                return runs
        n += 1


def fold_launches(widths: Sequence[int], num_groups: int) -> list[tuple[int, int, int]]:
    """How the fold tile (K2 dense mode, K4, K6) covers ops of `widths`
    shared tables each (`fold_widths`) of `num_groups` slots: `(first op,
    stop, replicas)` per launch. The op list splits evenly into the fewest
    launches whose tables fit one block's shared memory (FOLD_SMEM_BYTES)
    and whose ops and tables fit its struct (FOLD_MAX_OPS), and each slot
    is then held by the most replicas (a power of two up to MAX_REPLICAS)
    that keep the launch's tables within REPLICA_BUDGET; one when even a
    single copy does not."""
    table = num_groups * 8
    cap = max(1, min(FOLD_MAX_OPS, FOLD_SMEM_BYTES // table))
    if any(t > cap for t in widths):
        raise ValueError(f"a float SUM's {FIX_TABLES} tables of {num_groups} slots do not fit one launch")
    out = []
    for lo, hi in _weighted_split(widths, cap):
        tables = sum(widths[lo:hi])
        reps = 1
        while reps < MAX_REPLICAS and 2 * reps * table * tables <= REPLICA_BUDGET:
            reps *= 2
        out.append((lo, hi, reps))
    return out


def segmented_reduce_plain(
    gid: torch.Tensor,
    values: Sequence[Optional[torch.Tensor]],
    masks: Sequence[Optional[torch.Tensor]],
    *,
    ops: Sequence[str],
    num_groups: int,
) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch (either mode). On the CPU
    `index_add_` accumulates in row order, so float sums are the
    sequential left-to-right sums."""
    keep = (gid >= 0) & (gid < num_groups)
    tables = _identity_tables(ops, values, num_groups, gid.device)
    for op, v, m, t in zip(ops, values, masks, tables):
        rows = keep if m is None else keep & m
        idx = gid[rows].long()
        if op == "count":
            t.add_(torch.bincount(idx, minlength=num_groups))
        elif op == "sum":
            t.index_add_(0, idx, v[rows].to(t.dtype))
        else:
            red = "amin" if op == "min" else "amax"
            t.scatter_reduce_(0, idx, to_sortable_int(v[rows]), red, include_self=True)
    return _finish(ops, values, tables)


def fixed_decode(t0: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, flags: torch.Tensor, e: int) -> torch.Tensor:
    """The f64 value of int64 digit totals t0 2^64 + t1 2^32 + t2 on the
    grid 2^(e-95), rounded once to nearest even, or NaN / +-inf as the
    flags say (bit 0 NaN, bit 1 +inf, bit 2 -inf): csrc/reduce_common.cuh
    `fix_decode` in int64 tensor ops."""
    m32 = 0xFFFFFFFF
    m1 = t1 + (t2 >> 32)
    hi = t0 + (m1 >> 32)  # the total: hi 2^64 + d1 2^32 + d0, d1 and d0 in [0, 2^32)
    d1, d0 = m1 & m32, t2 & m32
    neg = hi < 0
    b0 = (d0 != 0).long()
    b1 = ((d1 + b0) != 0).long()
    h = torch.where(neg, -hi - b1, hi)  # the magnitude, h < 2^63
    d1 = torch.where(neg, (-d1 - b0) & m32, d1)
    d0 = torch.where(neg, (-d0) & m32, d0)
    # h > 0: its top 63 bits and then the rest of the total as a sticky bit
    ex = torch.frexp(h.double()).exponent.long()  # bit length of h, or one more
    bl = ex - ((h >> (ex - 1).clamp(min=0)) == 0).long()
    s = (63 - bl).clamp(0, 62)
    sa, sb1, sb2 = (32 - s).clamp(0, 32), (s - 32).clamp(0, 30), (64 - s).clamp(2, 32)
    low = s <= 32
    top = torch.where(low, d1 >> sa, (d1 << sb1) | (d0 >> sb2))
    rest = torch.where(low, (d1 & ((1 << sa) - 1)) | d0, d0 & ((1 << sb2) - 1))
    w = (h << s) | top | (rest != 0).long()
    k = 64 - s
    # h == 0: the total is d1 2^32 + d0 < 2^64
    wide = d1 >= (1 << 31)
    w = torch.where(h == 0, torch.where(wide, (d1 << 31) | (d0 >> 1) | (d0 & 1), (d1 << 32) | d0), w)
    k = torch.where(h == 0, wide.long(), k)
    r = w.double()
    p = k + (e - 95)
    tiny = p < -1022
    r = torch.where(tiny, r * 2.0**-1000, r)
    p = torch.where(tiny, p + 1000, p)
    r = r * ((p + 1023) << 52).view(torch.float64)
    r = torch.where(neg, -r, r)
    inf = torch.full((), float("inf"), dtype=torch.float64, device=r.device)
    r = torch.where((flags & 2) != 0, inf, r)
    r = torch.where((flags & 4) != 0, -inf, r)
    nan = ((flags & 1) != 0) | ((flags & 6) == 6)
    return torch.where(nan, torch.full_like(r, float("nan")), r)


def fixed_digits(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Finite f64 values as the fold tile's fixed-point digits
    (csrc/reduce_common.cuh `fix_digit`): the scale exponent E of the
    largest |x|, and int64 d0, d1, d2 with x ~ (d0 2^64 + d1 2^32 + d2)
    2^(E-95): d0 and d1 truncated, d2 rounded to nearest even, every step
    before that rounding exact. Returns (d0, d1, d2, E)."""
    m = int(x.abs().view(torch.int64).max()) if x.numel() else 0
    e = max(m >> 52, 1) - 1023
    t = 31 - e
    t1 = min(t, 1000)
    a = x * 2.0**t1 * 2.0**(t - t1)
    d0 = torch.trunc(a)
    a = (a - d0) * 2.0**32
    d1 = torch.trunc(a)
    d2 = torch.round((a - d1) * 2.0**32)  # half to even
    return d0.long(), d1.long(), d2.long(), e


def fixed_sum_plain(gid: torch.Tensor, value: torch.Tensor, mask: Optional[torch.Tensor],
                    num_groups: int) -> torch.Tensor:
    """The fold tile's float SUM (module doc) in plain PyTorch, on any
    device: the same scale E, digits and rounding as the kernels, the
    digits summed by int64 `index_add_` (exact, so in any order). Returns
    the `[num_groups]` f64 sums; the fold-tile kernels equal it bit for
    bit. Used by the tests and chip_smoke.py, not on the main path."""
    keep = (gid >= 0) & (gid < num_groups)
    if mask is not None:
        keep &= mask
    x, idx = value[keep].double(), gid[keep].long()
    fin = torch.isfinite(x)
    *digits, e = fixed_digits(x[fin])

    def total(d):
        return torch.zeros(num_groups, dtype=torch.int64, device=gid.device).index_add_(0, idx[fin], d)

    flags = torch.zeros(num_groups, dtype=torch.int64, device=gid.device)
    for bit, hit in ((1, torch.isnan(x)), (2, x == float("inf")), (4, x == float("-inf"))):
        flags |= (torch.bincount(idx[hit], minlength=num_groups) > 0).long() * bit
    return fixed_decode(*(total(d) for d in digits), flags, e)


@spanned("dft.kernel.K2")
def segmented_reduce(
    gid: torch.Tensor,
    values: Sequence[Optional[torch.Tensor]],
    masks: Sequence[Optional[torch.Tensor]],
    *,
    ops: Sequence[str],
    num_groups: int,
    dense: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Per-group reductions (module doc). Returns one `[num_groups]`
    tensor per op: f64/i64 sums, i64 counts, value-dtype MIN/MAX."""
    values, masks, ops = tuple(values), tuple(masks), tuple(ops)
    _validate(gid, values, masks, ops, num_groups, dense)
    if gid.device.type == "cpu":
        return segmented_reduce_plain(gid, values, masks, ops=ops, num_groups=num_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    n = gid.shape[0]
    if n == 0 or num_groups == 0 or not ops:  # nothing to launch
        return _finish(ops, values, _identity_tables(ops, values, num_groups, gid.device))
    if dense:  # one launch per group of ops whose tables fit shared memory
        check_fixed_rows(ops, values, n)
        launches = fold_launches(fold_widths(ops, values), num_groups)
        ft = fold_tables(ops, values, num_groups, gid.device, counters=len(launches), fixed=True)
    else:
        launches = [(lo, hi, 1) for lo, hi in sorted_launch_ops(len(ops))]
        max_blocks = min(SORTED_MAX_BLOCKS, -(-n // SORTED_BLOCK_ROWS))
        ft = fold_tables(ops, values, num_groups, gid.device, counters=len(launches), edge_blocks=max_blocks)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for (lo, hi, reps), counter in zip(launches, ft.counters):
            kinds, outs, aux = c_entries(ops, values, ft, lo, hi, fixed=dense)
            arrays = (kinds, *c_streams(values, masks, lo, hi), outs, aux)
            if dense:
                rc = lib.dft_segreduce_dense(gid.data_ptr(), n, num_groups, reps, hi - lo, *arrays, counter, stream)
                check(rc, "segreduce dense kernel")
                segmented_reduce.dense_launches += 1
            else:
                rc = lib.dft_segreduce(gid.data_ptr(), n, num_groups, hi - lo, *arrays, counter, max_blocks, stream)
                check(rc, "segreduce sorted kernel")
                segmented_reduce.sorted_launches += 1
    return tuple(ft.tables)


# CUDA kernel launches per mode
segmented_reduce.sorted_launches = 0
segmented_reduce.dense_launches = 0
