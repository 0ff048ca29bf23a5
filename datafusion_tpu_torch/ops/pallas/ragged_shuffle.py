"""K5 ragged exchange and K6 ragged exchange + fold: the shuffle between
the logical shards of a mesh (parallel/).

Port of datafusion_tpu/ops/pallas/ragged_shuffle.py. Layout contract,
as there: every array is 1-D `[n_dev * split_cap]`; a sender's region `i`
holds the rows for shard `i`, and a receiver's region `j` the rows shard
`j` sent it. `sizes[j, i]` is the number of rows shard j sends shard i
(an int32 `[n_dev, n_dev]` matrix, parallel/collectives.size_matrix), so
region j of receiver i is valid in its first `sizes[j, i]` rows and no
validity rides the exchange. The senders may outnumber the receivers:
on a mesh that spans processes the receivers are this process's
`n_dev` shards, every shard of the mesh is a sender, and `sizes` is the
`[n_send, n_dev]` block of the mesh's matrix whose columns are this
process's shards (parallel/shuffle.py). Each count must be at most `split_cap`: the
caller sizes `split_cap` from the counts (parallel/shuffle.py), so no row
is ever dropped and the JAX package's overflow retry has no counterpart.

  * K5 `ragged_exchange(sends, sizes)`: `sends[j]` is shard j's list of
    region-layout arrays (any dtype of 1, 2, 4 or 8 bytes); returns each
    receiver's list. Only `ceil(sizes[j, i] / chunk)` chunks move per
    pair; tails stay unwritten. On the card, array a's receivers are
    views of one `[n_dev * n_send * split_cap]` buffer, and the pointers
    ride in the kernel's launch parameters (`exchange_args`), so a call
    makes `n_arrs` allocations and no host-to-device copy.
  * K6 `ragged_exchange_fold`: routed rows carry a receiver-local window
    id (< num_groups <= 2048), per-op values and deduplicated masks; each
    receiver gets K2 dense mode's per-op tables over its windows
    (ops/pallas/segreduce.py: f64 sums in fixed point, the same bits for
    any order of the routed rows, with IEEE NaN and +-inf; i64 sums and
    counts, value-dtype MIN/MAX, +-inf for an empty float MIN/MAX slot),
    with no post-exchange batch. The TPU kernel's f32-only values and its
    zero-sanitized sums are gone. One launch per group of ops whose tables
    fit a block's shared memory (`fold_launches`; a float SUM takes three
    tables and one scale, found over every receiver's routed rows): the
    wrapper zeroes one buffer of `[n_dev, num_groups]` tables
    (segreduce.fold_tables), copies one packed pointer table per launch
    (`fold_pointer_table`), all in one copy from pinned host memory, and
    the kernel leaves the results in the tables.

The senders' buffers are all on one device. CPU tensors take the plain
versions; CUDA tensors launch csrc/ragged_shuffle.cu (or raise).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.ops.pallas.partition import MAX_OPS, WINDOW
from datafusion_tpu_torch.ops.pallas.segreduce import (
    _finish,
    _identity_tables,
    _validate,
    c_entries,
    check_fixed_rows,
    fold_launches,
    fold_tables,
    fold_widths,
    segmented_reduce_plain,
)

CHUNKS = (1024, 512, 256, 128)  # K5 chunk sizes, in rows
MAX_DEV = 255  # csrc/ragged_shuffle.cu DFT_MAX_DEV
K5_MAX_ARRS, K5_MAX_SEND = 16, 384  # ExchangeArgs' capacity: arrays, sender pointers per launch


def pick_chunk(split_cap: int) -> Optional[int]:
    """Largest chunk of CHUNKS dividing the region capacity (the JAX
    package's rule), or None."""
    for c in CHUNKS:
        if split_cap % c == 0:
            return c
    return None


def _check_sizes(sizes: torch.Tensor, n_send: int, n_dev: int, split_cap: int, device) -> None:
    if not (1 <= n_dev <= MAX_DEV and 1 <= n_send <= MAX_DEV):
        raise ValueError(f"n_dev and the senders must be in [1, {MAX_DEV}]")
    if split_cap < 0:
        raise ValueError("split_cap must not be negative")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (n_send, n_dev) or not sizes.is_contiguous():
        raise ValueError("sizes must be a contiguous [n_send, n_dev] int32 tensor")
    if sizes.device != device:
        raise ValueError("sizes must lie on the arrays' device")


def _check_region(t: torch.Tensor, n_dev: int, split_cap: int, device) -> None:
    if t.device != device or t.dim() != 1 or t.shape[0] != n_dev * split_cap or not t.is_contiguous():
        raise ValueError("region-layout arrays must be contiguous 1-D [n_dev * split_cap] tensors on one device")


# --- K5 ---------------------------------------------------------------------


def _check_exchange(sends, sizes, n_dev, split_cap, chunk):
    """Every check in one pass: sender 0's arrays in full, every other
    sender's against sender 0's (dtype, shape, contiguity, device)."""
    if len(sends) != sizes.shape[0]:
        raise ValueError("one list of arrays per sender")
    if chunk not in CHUNKS or split_cap % chunk:
        raise ValueError(f"chunk must be one of {CHUNKS} and divide split_cap")
    dev = sends[0][0].device if sends and sends[0] else sizes.device
    _check_sizes(sizes, len(sends), n_dev, split_cap, dev)
    for t in sends[0]:
        _check_region(t, n_dev, split_cap, dev)
        if t.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"dtype {t.dtype} is not 1, 2, 4 or 8 bytes wide")
    spec = [(t.dtype, t.shape, t.is_contiguous(), t.device) for t in sends[0]]
    for arrs in sends[1:]:
        if len(arrs) != len(spec):
            raise ValueError("every sender sends the same arrays")
        if [(t.dtype, t.shape, t.is_contiguous(), t.device) for t in arrs] != spec:
            raise ValueError("every sender's arrays must have sender 0's dtypes, shapes, contiguity and device")


class ExchangeArgs(ctypes.Structure):
    """csrc/ragged_shuffle.cu ExchangeArgs: one launch's pointers."""

    _fields_ = [
        ("send", ctypes.c_void_p * K5_MAX_SEND),
        ("recv", ctypes.c_void_p * K5_MAX_ARRS),
        ("esize", ctypes.c_int * K5_MAX_ARRS),
        ("n_arrs", ctypes.c_int),
    ]


def exchange_args(sends, bufs) -> list[ExchangeArgs]:
    """K5's launch parameters: the arrays split into launches of at most
    K5_MAX_ARRS arrays and K5_MAX_SEND sender pointers, each with its
    senders' pointers (array-major), its receive buffers and widths."""
    n_send = len(sends)
    per = min(K5_MAX_ARRS, K5_MAX_SEND // n_send)
    out = []
    for lo in range(0, len(bufs), per):
        hi = min(lo + per, len(bufs))
        x = ExchangeArgs()
        x.n_arrs = hi - lo
        x.send[: x.n_arrs * n_send] = [sends[j][a].data_ptr() for a in range(lo, hi) for j in range(n_send)]
        x.recv[: x.n_arrs] = [b.data_ptr() for b in bufs[lo:hi]]
        x.esize[: x.n_arrs] = [b.element_size() for b in bufs[lo:hi]]
        out.append(x)
    return out


def receivers(bufs, n_dev: int, n_send: int, split_cap: int) -> list[list[torch.Tensor]]:
    """Each of the `n_dev` receivers' arrays: views of the per-array
    buffers, receiver i's `[n_send * split_cap]` at i * n_send * split_cap."""
    views = [b.view(n_dev, n_send * split_cap).unbind(0) for b in bufs]
    return [[v[i] for v in views] for i in range(n_dev)]


def ragged_exchange_plain(
    sends: Sequence[Sequence[torch.Tensor]],
    sizes: torch.Tensor,
    *,
    n_dev: int,
    split_cap: int,
    chunk: int,
) -> list[list[torch.Tensor]]:
    """The kernel's function in plain PyTorch: each pair's valid prefix
    copied region to region."""
    sz = sizes.tolist()
    if max(max(r) for r in sz) > split_cap:
        raise ValueError("a count exceeds split_cap")
    n_send = len(sends)
    recvs = [[t.new_empty(n_send * split_cap) for t in sends[0]] for _ in range(n_dev)]
    for j in range(n_send):
        for i in range(n_dev):
            c = sz[j][i]
            for a, t in enumerate(sends[j]):
                recvs[i][a][j * split_cap: j * split_cap + c] = t[i * split_cap: i * split_cap + c]
    return recvs


def ragged_exchange(
    sends: Sequence[Sequence[torch.Tensor]],
    sizes: torch.Tensor,
    *,
    n_dev: int,
    split_cap: int,
    chunk: int,
) -> list[list[torch.Tensor]]:
    """All-to-all of region-layout arrays (K5, module doc): `sends[j]` are
    sender j's `[n_dev * split_cap]` arrays; returns each of the `n_dev`
    receivers' `[len(sends) * split_cap]` arrays, valid in region j's
    first `sizes[j, i]` rows. On the card they are read-only views of one
    buffer per array; one launch per `exchange_args` entry."""
    sends = [list(s) for s in sends]
    _check_exchange(sends, sizes, n_dev, split_cap, chunk)
    dev = sizes.device
    if dev.type == "cpu":
        return ragged_exchange_plain(sends, sizes, n_dev=n_dev, split_cap=split_cap, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    n_send = len(sends)
    bufs = [torch.empty(n_dev * n_send * split_cap, dtype=t.dtype, device=dev) for t in sends[0]]
    if bufs and split_cap:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for x in exchange_args(sends, bufs):
                check(lib.dft_ragged_exchange(ctypes.byref(x), sizes.data_ptr(), n_send, n_dev, split_cap, chunk,
                                              stream),
                      "ragged_exchange kernel")
                ragged_exchange.launches += 1
    return receivers(bufs, n_dev, n_send, split_cap)


# --- K6 ---------------------------------------------------------------------


def _check_fold(gids, vals, masks, sizes, ops, mask_map, n_dev, split_cap, num_groups):
    n_send = len(gids)
    if not (len(vals) == len(masks) == n_send == sizes.shape[0]):
        raise ValueError("one gid, one value list and one mask list per sender")
    if not 0 <= num_groups <= WINDOW:
        raise ValueError(f"num_groups must be in [0, {WINDOW}]: one shared-memory window per op")
    if len(ops) > MAX_OPS:
        raise ValueError(f"at most {MAX_OPS} ops: one {WINDOW}-slot window each must fit shared memory")
    if len(mask_map) != len(ops):
        raise ValueError("one mask_map entry per op")
    if any(not 0 <= u <= len(masks[0]) for u in mask_map):
        raise ValueError("mask_map entries index the masks from 1 (0 = every routed row)")
    dev = gids[0].device
    _check_sizes(sizes, n_send, n_dev, split_cap, dev)
    # the ops and value dtypes once; the kernel takes each op's kind from sender 0
    _validate(gids[0], vals[0], [None] * len(ops), ops, num_groups, dense=False)
    dtypes = [None if v is None else v.dtype for v in vals[0]]
    seen = set()
    for j in range(n_send):
        if len(vals[j]) != len(ops) or len(masks[j]) != len(masks[0]):
            raise ValueError("every sender sends one value per op and the same masks")
        if gids[j].dtype != torch.int32 or [None if v is None else v.dtype for v in vals[j]] != dtypes:
            raise ValueError("every sender's window ids are int32 and its values have sender 0's dtypes")
        if any(m.dtype != torch.bool for m in masks[j]):
            raise ValueError("masks must be bool")
        for t in (gids[j], *vals[j], *masks[j]):  # each distinct array once
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                _check_region(t, n_dev, split_cap, dev)


def _op_masks(masks, mask_map):
    return [None if u == 0 else masks[u - 1] for u in mask_map]


def fold_pointer_table(gids, vals, op_masks, launch_ops: Sequence[int]) -> list[int]:
    """One K6 launch's packed pointer table (csrc/ragged_shuffle.cu): the
    senders' window ids, then the values of each op of `launch_ops` by
    sender, then its masks by sender (`op_masks[j][a]`); 0 where there is
    none."""
    n_send = len(gids)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    return ([ptr(g) for g in gids] + [ptr(vals[j][a]) for a in launch_ops for j in range(n_send)]
            + [ptr(op_masks[j][a]) for a in launch_ops for j in range(n_send)])


def ragged_exchange_fold_plain(
    gids: Sequence[torch.Tensor],
    vals: Sequence[Sequence[Optional[torch.Tensor]]],
    masks: Sequence[Sequence[torch.Tensor]],
    sizes: torch.Tensor,
    *,
    ops: Sequence[str],
    mask_map: Sequence[int],
    n_dev: int,
    split_cap: int,
    num_groups: int,
) -> list[tuple[torch.Tensor, ...]]:
    """The kernel's function in plain PyTorch: each receiver's routed rows
    gathered sender by sender, then K2's plain reduce."""
    sz = sizes.tolist()
    n_send = len(gids)
    out = []
    for i in range(n_dev):
        spans = [(j, i * split_cap, i * split_cap + sz[j][i]) for j in range(n_send)]

        def cat(ts):
            return torch.cat([ts[j][lo:hi] for j, lo, hi in spans])

        gid = cat(gids)
        v = [None if vals[0][a] is None else cat([vals[j][a] for j in range(n_send)]) for a in range(len(ops))]
        m = [None if u == 0 else cat([masks[j][u - 1] for j in range(n_send)]) for u in mask_map]
        out.append(segmented_reduce_plain(gid, v, m, ops=ops, num_groups=num_groups))
    return out


def ragged_exchange_fold(
    gids: Sequence[torch.Tensor],
    vals: Sequence[Sequence[Optional[torch.Tensor]]],
    masks: Sequence[Sequence[torch.Tensor]],
    sizes: torch.Tensor,
    *,
    ops: Sequence[str],
    mask_map: Sequence[int],
    n_dev: int,
    split_cap: int,
    num_groups: int,
) -> list[tuple[torch.Tensor, ...]]:
    """Exchange fused with a dense fold (K6, module doc). `gids[j]`,
    `vals[j][a]` (None for a COUNT) and `masks[j][u]` are sender j's
    region-layout window ids, per-op values and deduplicated bool masks,
    `[n_dev * split_cap]` each; `mask_map[a]` is 0 (every routed row) or
    1 + the index of op a's mask. Returns, per each of the `n_dev`
    receivers, one `[num_groups]` table per op."""
    ops, mask_map = tuple(ops), tuple(mask_map)
    _check_fold(gids, vals, masks, sizes, ops, mask_map, n_dev, split_cap, num_groups)
    dev = gids[0].device
    if dev.type == "cpu":
        return ragged_exchange_fold_plain(gids, vals, masks, sizes, ops=ops, mask_map=mask_map, n_dev=n_dev,
                                          split_cap=split_cap, num_groups=num_groups)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    k = len(ops)
    if not (k and split_cap and num_groups):  # nothing to launch
        tables = _finish(ops, vals[0], _identity_tables(ops, vals[0], num_groups, dev, lead=(n_dev,)))
        return [tuple(t[i] for t in tables) for i in range(n_dev)]
    check_fixed_rows(ops, vals[0], len(gids) * split_cap)  # the most rows one receiver's slots fold
    launches = fold_launches(fold_widths(ops, vals[0]), num_groups)
    ft = fold_tables(ops, vals[0], num_groups, dev, lead=(n_dev,), counters=len(launches), fixed=True)
    per_op = [_op_masks(masks[j], mask_map) for j in range(len(gids))]
    tables = [fold_pointer_table(gids, vals, per_op, range(lo, hi)) for lo, hi, _ in launches]
    ptrs = torch.tensor([p for t in tables for p in t], dtype=torch.int64).pin_memory()
    with torch.cuda.device(dev):
        ptrs = ptrs.to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = ptrs.data_ptr()
        for (lo, hi, reps), table, done in zip(launches, tables, ft.counters):
            rc = lib.dft_ragged_exchange_fold(at, sizes.data_ptr(), len(gids), n_dev, split_cap, num_groups, reps,
                                              hi - lo, *c_entries(ops, vals[0], ft, lo, hi, fixed=True), done, stream)
            check(rc, "ragged_exchange_fold kernel")
            ragged_exchange_fold.launches += 1
            at += 8 * len(table)
    return list(zip(*[t.unbind(0) for t in ft.tables]))


# CUDA kernel launches (K5: one per `exchange_args` entry, K6: one per `fold_launches` entry)
ragged_exchange.launches = 0
ragged_exchange_fold.launches = 0
