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
    memory (`fold_launches`: a float SUM takes three windows). On the main
    path K4 reads the slab as K3 left it (`SlabFold`): the gid still
    packed with the masks as its bits, each float SUM's scale word from
    K3 (no first pass), and its blocks split over the buckets by K3's
    chunk counts.

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
from typing import NamedTuple, Optional, Sequence

import torch

from datafusion_tpu_torch.ops.pallas.segreduce import (
    _finish,
    _identity_tables,
    _validate,
    c_entries,
    c_streams,
    check_fixed_rows,
    float_sum,
    fold_launches,
    fold_tables,
    fold_widths,
    segmented_reduce_plain,
)
from datafusion_tpu_torch.utils.trace import spanned

WINDOW = 2048  # slots per bucket = the reduce window width
PBLOCK = 8192  # input rows per partition block
SLAB_CHUNK = 256  # bucket-segment alignment inside a block slab
ALIGN = 1024  # slab capacity rounding, kept so slabs match the JAX package's
SENTINEL = 1 << 23  # gid of the alignment gaps; above every packed id
MAX_BUCKETS = 64  # csrc/partition.cu DFT_MAX_BUCKETS
MAX_COLS = 16  # payload columns per K3 launch
WINDOW_SMEM_BYTES = 232448  # shared memory one Hopper block may hold
MAX_OPS = WINDOW_SMEM_BYTES // (WINDOW * 8)  # K4 windows of 8-byte slots per block (launch): 14
MAX_SCALES = MAX_OPS  # float SUM scale words one K3 launch leaves (csrc/partition.cu K3_MAX_SCALES)


class SlabFold(NamedTuple):
    """A slab as `windowed_reduce` takes it straight from K3 (what
    ops/aggregate.py `slab_reduce` passes): the gid still packed, its id
    below `id_mod` and op a's mask in gid bit `mask_bits[a]` (None: no
    mask); `info`, what `slab_partition(..., scales=...)` left: the scale
    words of its `n_scales` (payload, bit) pairs, then each bucket's chunk
    count; `scale_at[a]`, the index in `info` of float SUM a's word (None
    for other ops). K4 then reads no mask stream and runs no first pass,
    and splits its blocks over the buckets by their chunks."""

    id_mod: int
    mask_bits: tuple
    info: torch.Tensor
    n_scales: int
    scale_at: tuple

    def unpacked(self, gid):
        """The gid's ids (SENTINEL in the gaps) and each op's mask, as the
        plain version takes them."""
        ids = torch.where(gid >= SENTINEL, gid, gid & (self.id_mod - 1))
        return ids, [None if b is None else ((gid >> b) & 1).bool() for b in self.mask_bits]


def scale_pairs(ops, values, payload_of, mask_bits) -> tuple[list, tuple]:
    """The (payload index, mask bit) pairs K3 leaves scale words for, one
    per distinct float SUM among `ops` over `values` (op a's payload
    `payload_of[a]`, its mask gid bit `mask_bits[a]` or None), and each
    op's index among them (None for an op that is not a float SUM): the
    `scales` of `slab_partition` and the `scale_at` of `SlabFold`."""
    keys = [(c, b) if float_sum(op, v) else None for op, v, c, b in zip(ops, values, payload_of, mask_bits)]
    pairs = list(dict.fromkeys(k for k in keys if k is not None))
    return pairs, tuple(None if k is None else pairs.index(k) for k in keys)


def slab_capacity(pblock: int, n_buckets: int) -> int:
    """Slab rows per input block: the block's rows plus each bucket's
    alignment, rounded up to ALIGN (the JAX package's formula)."""
    cap = pblock + n_buckets * SLAB_CHUNK
    return -(-cap // ALIGN) * ALIGN


def _check_partition(gid, cols, n_buckets, id_mod, pblock, scales, num_groups):
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
    if scales is not None:
        if num_groups is None or not 0 <= num_groups < id_mod:
            raise ValueError("scales need num_groups below id_mod")
        if len(scales) > MAX_SCALES:
            raise ValueError(f"at most {MAX_SCALES} scale words a launch")
        for c, bit in scales:
            if not 0 <= c < len(cols) or cols[c].dtype not in (torch.float32, torch.float64):
                raise ValueError("a scale word is over an f32 or f64 payload")
            if bit is not None and not (1 << bit >= id_mod and bit < 23):
                raise ValueError("a scale word's mask bit lies between id_mod and SENTINEL")


def slab_partition_plain(
    gid: torch.Tensor,
    cols: Sequence[torch.Tensor],
    *,
    n_buckets: int,
    id_mod: int,
    pblock: int = PBLOCK,
    scales=None,
    num_groups: Optional[int] = None,
) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: a stable sort of each
    block's rows by bucket, and a scatter into a slab prefilled with
    SENTINEL / 0; with `scales`, K3's `info` after the slab."""
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
    if scales is not None:
        words = []
        kept = (gid & (id_mod - 1)) < num_groups
        for c, bit in scales:
            rows = kept if bit is None else kept & ((gid >> bit) & 1).bool()
            x = cols[c][rows].double().abs()
            x = x[torch.isfinite(x)]
            word = x.view(torch.int64).max() if x.numel() else torch.zeros((), dtype=torch.int64, device=dev)
            words.append(word >> 32 << 32)
        chunks = ((counts.view(nblocks, n_buckets) + SLAB_CHUNK - 1) // SLAB_CHUNK).sum(0)
        outs.append(torch.cat([torch.stack(words).view(-1).to(dev) if words else chunks[:0], chunks]))
    return tuple(outs)


@spanned("dft.kernel.K3")
def slab_partition(
    gid: torch.Tensor,
    cols: Sequence[torch.Tensor],
    *,
    n_buckets: int,
    id_mod: int,
    pblock: int = PBLOCK,
    scales: Optional[Sequence[tuple[int, Optional[int]]]] = None,
    num_groups: Optional[int] = None,
) -> tuple[torch.Tensor, ...]:
    """Bucket-major slab compaction (K3, module doc). Returns a tuple of
    `[ceil(n / pblock) * slab_capacity(pblock, n_buckets)]` tensors: the
    slab-ordered gid (int32, SENTINEL in the gaps), then each payload in
    its own dtype. A bucket past `n_buckets - 1` joins the last bucket.

    With `scales`, (payload index, gid mask bit or None) pairs, one per
    float SUM that K4 is to fold over the slab, the tuple ends with one
    more tensor, `info` (int64, `[len(scales) + n_buckets]`): for each
    pair a scale word with the exponent of the word K4's first pass would
    leave (the high 32 bits of the bits of the largest finite |value| of
    the payload over the rows whose id, gid & (id_mod - 1), lies below
    `num_groups` and whose bit is set), then each bucket's chunk count over
    the slab (`SlabFold`)."""
    cols = tuple(cols)
    _check_partition(gid, cols, n_buckets, id_mod, pblock, scales, num_groups)
    if gid.device.type == "cpu":
        return slab_partition_plain(gid, cols, n_buckets=n_buckets, id_mod=id_mod, pblock=pblock, scales=scales,
                                    num_groups=num_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"unsupported device {gid.device}")
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    n = gid.shape[0]
    scap = slab_capacity(pblock, n_buckets)
    size = -(-n // pblock) * scap
    out_gid = torch.empty(size, dtype=torch.int32, device=gid.device)
    outs = [torch.empty(size, dtype=c.dtype, device=gid.device) for c in cols]
    info = None if scales is None else torch.zeros(len(scales) + n_buckets, dtype=torch.int64, device=gid.device)
    if n > 0:
        k, j = len(cols), 0 if scales is None else len(scales)
        esizes = (ctypes.c_int * k)(*[c.element_size() for c in cols])
        ins = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
        optr = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
        scols = (ctypes.c_int * j)(*[c for c, _ in scales or ()])
        sbits = (ctypes.c_int * j)(*[-1 if b is None else b for _, b in scales or ()])
        with torch.cuda.device(gid.device):
            stream = torch.cuda.current_stream(gid.device).cuda_stream
            rc = lib.dft_slab_partition(gid.data_ptr(), out_gid.data_ptr(), n, id_mod, n_buckets, pblock, scap,
                                        k, esizes, ins, optr, None if info is None else info.data_ptr(),
                                        num_groups or 0, j, scols, sbits, stream)
        check(rc, "slab_partition kernel")
        slab_partition.launches += 1
    return (out_gid, *outs) if info is None else (out_gid, *outs, info)


def _check_windowed(gid, values, masks, ops, num_groups, slab):
    _validate(gid, values, masks, ops, num_groups, dense=False)
    if len(ops) > MAX_OPS:
        raise ValueError(f"at most {MAX_OPS} ops: one {WINDOW}-slot window each must fit shared memory")
    if num_groups > SENTINEL:
        raise ValueError("num_groups must not exceed SENTINEL, or the gaps would count")
    if slab is not None:
        if any(m is not None for m in masks) or len(slab.mask_bits) != len(ops) or len(slab.scale_at) != len(ops):
            raise ValueError("a SlabFold gives every op's mask as a gid bit, and one entry per op")
        if not num_groups < slab.id_mod <= SENTINEL or slab.id_mod & (slab.id_mod - 1):
            raise ValueError("a SlabFold's id_mod is a power of two past num_groups")
        for op, v, at in zip(ops, values, slab.scale_at):
            if float_sum(op, v) and not (at is not None and 0 <= at < slab.n_scales):
                raise ValueError("a SlabFold names a scale word for every float SUM")


# K2's plain version is K4's function: it drops rows outside
# [0, num_groups) and takes the rows in any order.
windowed_reduce_plain = segmented_reduce_plain


@spanned("dft.kernel.K4")
def windowed_reduce(
    gid: torch.Tensor,
    values: Sequence[Optional[torch.Tensor]],
    masks: Sequence[Optional[torch.Tensor]],
    *,
    ops: Sequence[str],
    num_groups: int,
    slab: Optional[SlabFold] = None,
) -> tuple[torch.Tensor, ...]:
    """Per-group reductions over slab rows (K4, module doc): one
    `[num_groups]` tensor per op, as `segmented_reduce` returns them.
    With `slab`, `gid` is K3's packed gid and the masks are its bits
    (`masks` all None; SlabFold)."""
    values, masks, ops = tuple(values), tuple(masks), tuple(ops)
    _check_windowed(gid, values, masks, ops, num_groups, slab)
    if gid.device.type == "cpu":
        if slab is not None:
            gid, masks = slab.unpacked(gid)
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
            if slab is None:
                rc = lib.dft_windowed_reduce(gid.data_ptr(), n, num_groups, hi - lo, kinds,
                                             *c_streams(values, masks, lo, hi), outs, aux, done, stream)
            else:  # K3's scale words for the float SUMs, its chunk counts for the split
                words = slab.info.data_ptr()
                for a in range(lo, hi):
                    if slab.scale_at[a] is not None:
                        aux[a - lo] = words + 8 * slab.scale_at[a]
                bits = (ctypes.c_int * (hi - lo))(*[-1 if b is None else b for b in slab.mask_bits[lo:hi]])
                rc = lib.dft_windowed_reduce_slab(gid.data_ptr(), n, num_groups, slab.id_mod, hi - lo, kinds,
                                                  c_streams(values, masks, lo, hi)[0], bits, outs, aux, done,
                                                  words + 8 * slab.n_scales, stream)
            check(rc, "windowed_reduce kernel")
            windowed_reduce.launches += 1
    return tuple(ft.tables)


# CUDA kernel launches (K3: one per call that reached the card)
slab_partition.launches = 0
windowed_reduce.launches = 0
