"""K3 slab partition and K4 windowed reduce: the sort-free GROUP BY past
K2's 2048-slot dense window ("bigdense").

Port of datafusion_tpu/ops/pallas/partition.py.

  * K3 `slab_partition`: each `pblock`-row input block is compacted
    bucket-major (bucket = (gid & (id_mod - 1)) // WINDOW) into its own
    slab of `slab_capacity(pblock, n_buckets)` rows; every bucket's
    segment starts on a SLAB_CHUNK boundary, so each SLAB_CHUNK-row chunk
    of the slab holds rows of one bucket. The compaction is stable (rows
    keep their order within a bucket), so a slab is equal, row for row,
    to the JAX package's. Gaps hold SENTINEL in the gid and zeros in the
    payloads.
  * K4 `windowed_reduce`: per-group SUM / COUNT / MIN / MAX over slab rows,
    with K2's op contract and output types (ops/pallas/segreduce.py): f64
    / i64 sums, i64 counts, value-dtype MIN/MAX, +-inf for a float slot no
    row reached. Rows with a gid outside [0, num_groups) are dropped, the
    SENTINEL gaps among them. Any row order gives the same result, float
    SUMs included: they are K2 dense mode's fixed-point sums, bit for bit
    (ops/pallas/segreduce.py `fixed_sum_plain`). The slab layout is what
    makes the kernel fast (each chunk's rows lie in the window of its
    first row's bucket, which one block folds from many slabs). A call
    makes one launch per group of ops whose windows fit a block's shared
    memory (`fold_launches`: a float SUM takes three windows).

What was the TPU's is gone: payloads keep their own dtype (any 1-, 2-,
4- or 8-byte type) instead of riding as f32, so there are no 16-bit
halves, no sanitize pass and no special-class bits; the gid is int32; and
the row count need not be a multiple of 1024 (the last block is ragged
and its slab has the same capacity). The gid still carries mask bits
above `id_mod` (the caller's packing, ops/aggregate.py), which K3 moves
with the id at no extra column.

CPU tensors take the plain versions; CUDA tensors launch
csrc/partition.cu (or raise).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.ops.pallas.segreduce import (
    _finish,
    _identity_tables,
    _validate,
    c_entries,
    c_streams,
    check_fixed_rows,
    fold_launches,
    fold_tables,
    fold_widths,
    segmented_reduce_plain,
)

WINDOW = 2048  # slots per bucket = the reduce window width
PBLOCK = 8192  # input rows per partition block
SLAB_CHUNK = 256  # bucket-segment alignment inside a block slab
ALIGN = 1024  # slab capacity rounding, kept so slabs match the JAX package's
SENTINEL = 1 << 23  # gid of the alignment gaps; above every packed id
MAX_BUCKETS = 64  # csrc/partition.cu DFT_MAX_BUCKETS
MAX_COLS = 16  # payload columns per K3 launch
WINDOW_SMEM_BYTES = 232448  # shared memory one Hopper block may hold
MAX_OPS = WINDOW_SMEM_BYTES // (WINDOW * 8)  # K4 windows of 8-byte slots per block (launch): 14


def slab_capacity(pblock: int, n_buckets: int) -> int:
    """Slab rows per input block: the block's rows plus each bucket's
    alignment, rounded up to ALIGN (the JAX package's formula)."""
    cap = pblock + n_buckets * SLAB_CHUNK
    return -(-cap // ALIGN) * ALIGN


def _check_partition(gid, cols, n_buckets, id_mod, pblock):
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    if id_mod <= 0 or id_mod & (id_mod - 1):
        raise ValueError("id_mod must be a power of two")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets must be in [1, {MAX_BUCKETS}]")
    if pblock <= 0:
        raise ValueError("pblock must be positive")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} payload columns")
    for c in cols:
        if c.device != gid.device or c.dim() != 1 or c.shape[0] != gid.shape[0] or not c.is_contiguous():
            raise ValueError("payloads must be contiguous 1-D tensors like gid")
        if c.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"payload dtype {c.dtype} is not 1, 2, 4 or 8 bytes wide")


def slab_partition_plain(
    gid: torch.Tensor,
    cols: Sequence[torch.Tensor],
    *,
    n_buckets: int,
    id_mod: int,
    pblock: int = PBLOCK,
) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: a stable sort of each
    block's rows by bucket, and a scatter into a slab prefilled with
    SENTINEL / 0."""
    n = gid.shape[0]
    dev = gid.device
    scap = slab_capacity(pblock, n_buckets)
    nblocks = -(-n // pblock)
    bucket = ((gid & (id_mod - 1)) // WINDOW).clamp(max=n_buckets - 1).to(torch.int64)
    block = torch.arange(n, device=dev) // pblock
    key = block * n_buckets + bucket
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    counts = torch.bincount(key, minlength=nblocks * n_buckets)
    aligned = (counts.view(nblocks, n_buckets) + SLAB_CHUNK - 1) // SLAB_CHUNK * SLAB_CHUNK
    seg = (torch.cumsum(aligned, 1) - aligned).flatten()  # segment start in its block's slab
    first = torch.cumsum(counts, 0) - counts  # first sorted position of each (block, bucket)
    rank = torch.arange(n, device=dev) - first[skey]
    dest = (skey // n_buckets) * scap + seg[skey] + rank
    out_gid = torch.full((nblocks * scap,), SENTINEL, dtype=torch.int32, device=dev)
    out_gid[dest] = gid[order]
    outs = [out_gid]
    for c in cols:
        o = torch.zeros(nblocks * scap, dtype=c.dtype, device=dev)
        o[dest] = c[order]
        outs.append(o)
    return tuple(outs)


def slab_partition(
    gid: torch.Tensor,
    cols: Sequence[torch.Tensor],
    *,
    n_buckets: int,
    id_mod: int,
    pblock: int = PBLOCK,
) -> tuple[torch.Tensor, ...]:
    """Bucket-major slab compaction (K3, module doc). Returns a tuple of
    `[ceil(n / pblock) * slab_capacity(pblock, n_buckets)]` tensors: the
    slab-ordered gid (int32, SENTINEL in the gaps), then each payload in
    its own dtype. A bucket past `n_buckets - 1` joins the last bucket."""
    cols = tuple(cols)
    _check_partition(gid, cols, n_buckets, id_mod, pblock)
    if gid.device.type == "cpu":
        return slab_partition_plain(gid, cols, n_buckets=n_buckets, id_mod=id_mod, pblock=pblock)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    n = gid.shape[0]
    scap = slab_capacity(pblock, n_buckets)
    size = -(-n // pblock) * scap
    out_gid = torch.empty(size, dtype=torch.int32, device=gid.device)
    outs = [torch.empty(size, dtype=c.dtype, device=gid.device) for c in cols]
    if n > 0:
        k = len(cols)
        esizes = (ctypes.c_int * k)(*[c.element_size() for c in cols])
        ins = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
        optr = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
        with torch.cuda.device(gid.device):
            stream = torch.cuda.current_stream(gid.device).cuda_stream
            rc = lib.dft_slab_partition(gid.data_ptr(), out_gid.data_ptr(), n, id_mod, n_buckets, pblock, scap,
                                        k, esizes, ins, optr, stream)
        check(rc, "slab_partition kernel")
        slab_partition.launches += 1
    return (out_gid, *outs)


def _check_windowed(gid, values, masks, ops, num_groups):
    _validate(gid, values, masks, ops, num_groups, dense=False)
    if len(ops) > MAX_OPS:
        raise ValueError(f"at most {MAX_OPS} ops: one {WINDOW}-slot window each must fit shared memory")
    if num_groups > SENTINEL:
        raise ValueError("num_groups must not exceed SENTINEL, or the gaps would count")


# K2's plain version is K4's function: it drops rows outside
# [0, num_groups) and takes the rows in any order.
windowed_reduce_plain = segmented_reduce_plain


def windowed_reduce(
    gid: torch.Tensor,
    values: Sequence[Optional[torch.Tensor]],
    masks: Sequence[Optional[torch.Tensor]],
    *,
    ops: Sequence[str],
    num_groups: int,
) -> tuple[torch.Tensor, ...]:
    """Per-group reductions over slab rows (K4, module doc): one
    `[num_groups]` tensor per op, as `segmented_reduce` returns them."""
    values, masks, ops = tuple(values), tuple(masks), tuple(ops)
    _check_windowed(gid, values, masks, ops, num_groups)
    if gid.device.type == "cpu":
        return windowed_reduce_plain(gid, values, masks, ops=ops, num_groups=num_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    n = gid.shape[0]
    if n == 0 or num_groups == 0 or not ops:  # nothing to launch
        return _finish(ops, values, _identity_tables(ops, values, num_groups, gid.device))
    check_fixed_rows(ops, values, n)
    launches = fold_launches(fold_widths(ops, values), WINDOW)  # one replica: `reps` is K2's and K6's
    ft = fold_tables(ops, values, num_groups, gid.device, counters=len(launches), fixed=True)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for (lo, hi, _), done in zip(launches, ft.counters):
            kinds, outs, aux = c_entries(ops, values, ft, lo, hi, fixed=True)
            rc = lib.dft_windowed_reduce(gid.data_ptr(), n, num_groups, hi - lo, kinds,
                                         *c_streams(values, masks, lo, hi), outs, aux, done, stream)
            check(rc, "windowed_reduce kernel")
            windowed_reduce.launches += 1
    return tuple(ft.tables)


# CUDA kernel launches (K3: one per call that reached the card)
slab_partition.launches = 0
windowed_reduce.launches = 0
