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
a block's shared memory (`fold_launches`, shared with K6). Both write the
fold tables of `fold_tables` and return them as the outputs.

CPU tensors take `segmented_reduce_plain`; CUDA tensors launch
csrc/segreduce.cu (or raise).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

DENSE_MAX_SLOTS = 2048
OPS = ("sum", "count", "min", "max")
# the fold tile's shared tables (csrc/reduce_common.cuh): 8-byte entries
FOLD_SMEM_BYTES = 230400  # dynamic shared memory of one launch: Hopper's 232,448 a block, less the static arrays
FOLD_MAX_OPS = 32  # DFT_FOLD_MAX_OPS
MAX_REPLICAS = 32  # DFT_MAX_REPS: one replica per lane of a warp
REPLICA_BUDGET = 57344  # replicas grow while a block's tables stay within this: four 512-thread blocks an SM
VALUE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)

# kernel op kinds (csrc/segreduce.cu)
_KIND = {
    ("sum", torch.float32): 0, ("sum", torch.float64): 1,
    ("sum", torch.int32): 2, ("sum", torch.int64): 3, ("count", None): 4,
    ("min", torch.float32): 5, ("max", torch.float32): 6,
    ("min", torch.float64): 7, ("max", torch.float64): 8,
    ("min", torch.int32): 9, ("max", torch.int32): 10,
    ("min", torch.int64): 11, ("max", torch.int64): 12,
}
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


def fold_tables(ops, values, num_groups, device, lead=(), counters=1):
    """The fold kernels' output tables (csrc/reduce_common.cuh, the fold
    tile): one zeroed buffer that holds, per op, a `[*lead, num_groups]`
    table in the op's result dtype (every identity is 0 bits there), then
    `counters` 8-byte launch counters. Returns (tables, counter
    addresses)."""
    rows = math.prod(lead) * num_groups
    spans, off = [], 0
    for op, v in zip(ops, values):
        dt = _out_dtype(op, v)
        spans.append((off, dt))
        off += -(-rows * dt.itemsize // 8) * 8
    buf = torch.zeros(off + 8 * counters, dtype=torch.uint8, device=device)
    tables = [buf[o: o + rows * dt.itemsize].view(dt) for o, dt in spans]
    if lead:
        tables = [t.view(*lead, num_groups) for t in tables]
    return tables, [buf.data_ptr() + off + 8 * c for c in range(counters)]


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


def _even_split(n_ops: int, per: int) -> list[tuple[int, int]]:
    """`n_ops` ops split evenly into the fewest runs of at most `per`."""
    n = -(-n_ops // per)
    return [(i * n_ops // n, (i + 1) * n_ops // n) for i in range(n)]


def sorted_launch_ops(n_ops: int) -> list[tuple[int, int]]:
    """How sorted mode covers `n_ops` ops: `(first op, stop)` per launch,
    the fewest launches of at most FOLD_MAX_OPS ops, split evenly."""
    return _even_split(n_ops, FOLD_MAX_OPS)


def fold_launches(n_ops: int, num_groups: int) -> list[tuple[int, int, int]]:
    """How the fold tile (K2 dense mode, K6) covers `n_ops` tables of
    `num_groups` slots: `(first op, stop, replicas)` per launch. The op
    list splits evenly into the fewest launches whose tables fit one
    block's shared memory (FOLD_SMEM_BYTES, at most FOLD_MAX_OPS ops), and
    each slot is then held by the most replicas (a power of two up to
    MAX_REPLICAS) that keep the launch's tables within REPLICA_BUDGET; one
    when even a single copy does not."""
    table = num_groups * 8
    per = max(1, min(FOLD_MAX_OPS, FOLD_SMEM_BYTES // table))
    out = []
    for lo, hi in _even_split(n_ops, per):
        reps = 1
        while reps < MAX_REPLICAS and 2 * reps * table * (hi - lo) <= REPLICA_BUDGET:
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
    kinds = [_KIND[(op, None if v is None else v.dtype)] for op, v in zip(ops, values)]
    vptr = [None if v is None else v.data_ptr() for v in values]
    mptr = [None if m is None else m.data_ptr() for m in masks]

    def arrays(lo, hi, tables):
        k = hi - lo
        return ((ctypes.c_int * k)(*kinds[lo:hi]), (ctypes.c_void_p * k)(*vptr[lo:hi]),
                (ctypes.c_void_p * k)(*mptr[lo:hi]), (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables[lo:hi]]))

    if dense:  # one launch per group of ops whose tables fit shared memory
        launches = fold_launches(len(ops), num_groups)
    else:
        launches = [(lo, hi, 1) for lo, hi in sorted_launch_ops(len(ops))]
    tables, done = fold_tables(ops, values, num_groups, gid.device, counters=len(launches))
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for (lo, hi, reps), counter in zip(launches, done):
            if dense:
                rc = lib.dft_segreduce_dense(gid.data_ptr(), n, num_groups, reps, hi - lo, *arrays(lo, hi, tables),
                                             counter, stream)
                check(rc, "segreduce dense kernel")
                segmented_reduce.dense_launches += 1
            else:
                rc = lib.dft_segreduce(gid.data_ptr(), n, num_groups, hi - lo, *arrays(lo, hi, tables), counter,
                                       stream)
                check(rc, "segreduce sorted kernel")
                segmented_reduce.sorted_launches += 1
    return tuple(tables)


# CUDA kernel launches per mode
segmented_reduce.sorted_launches = 0
segmented_reduce.dense_launches = 0
