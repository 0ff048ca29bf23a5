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

Across the cards of one process (a mesh of several cards,
parallel/mesh.py), `cards` names the cards the receivers lie on, in
contiguous blocks of `n_dev // len(cards)`; each sender's arrays lie on
its own card. Each card takes one launch (one per `exchange_args` entry,
or per `fold_launches` entry) over its own receivers, with every sender's
arrays, from that card's first region, read where they lie: the kernels
read a peer card's memory over NVLink once peer access is on
(`enable_peer_access`, once per ordered pair of cards; a pair without it
raises), and no row is staged through the host or copied by
`Tensor.to`. CUDA events order the cards as the TPU's barrier semaphore
did: each sender card records one after its regions, every receiving
card's stream waits for all of them before its launch, and every sender
card's stream waits for every receiving card's launch, so the caching
allocator cannot hand a send buffer to new work while a peer still reads
it. A float SUM's fixed-point scale is the mesh's: each card's first pass
runs alone, the largest scale word (and, through `agree`, every
process's) is written into each card's, and then every card folds, so
the sums do not depend on how the receivers split over cards or
processes. The entries of `cards` are logical: a device may repeat, and
each entry still takes its own launch and events. On a mesh that spans
processes with several cards in each, both hold at once: the local
senders' arrays lie on their own cards and the remote senders' on the
first card, where the transport delivered them (parallel/collectives.py
`exchange_regions`); the first card is then a sender card like the
others, so its event orders the received regions before every card's
launch. `card_launches` counts each wrapper's launches by logical card
(the index into `cards`; 0 without), beside `launches`.

CPU tensors take the plain versions (per card as on the card); CUDA
tensors launch csrc/ragged_shuffle.cu (or raise).
"""

from __future__ import annotations

import collections
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
from datafusion_tpu_torch.utils.trace import spanned

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


def _check_sizes(sizes: torch.Tensor, n_send: int, n_dev: int, split_cap: int) -> None:
    if not (1 <= n_dev <= MAX_DEV and 1 <= n_send <= MAX_DEV):
        raise ValueError(f"n_dev and the senders must be in [1, {MAX_DEV}]")
    if split_cap < 0:
        raise ValueError("split_cap must not be negative")
    if sizes.dtype != torch.int32 or tuple(sizes.shape) != (n_send, n_dev) or not sizes.is_contiguous():
        raise ValueError("sizes must be a contiguous [n_send, n_dev] int32 tensor")


def _check_region(t: torch.Tensor, n_dev: int, split_cap: int, device) -> None:
    if t.device != device or t.dim() != 1 or t.shape[0] != n_dev * split_cap or not t.is_contiguous():
        raise ValueError("region-layout arrays must be contiguous 1-D [n_dev * split_cap] tensors, each sender's "
                         "on one device")


def card_groups(cards, n_dev: int, sizes: torch.Tensor) -> list[tuple[torch.device, int, int]]:
    """(card, first receiver, end) of each launch: the receivers split in
    contiguous blocks over `cards` (None: every receiver on `sizes`'
    device, one block)."""
    if cards is None:
        return [(sizes.device, 0, n_dev)]
    cards = [torch.device(c) for c in cards]
    if not cards or n_dev % len(cards):
        raise ValueError(f"{n_dev} receivers do not split evenly over {len(cards)} cards")
    if len({c.type for c in cards}) > 1:
        raise ValueError("the receivers' cards mix device types")
    per = n_dev // len(cards)
    return [(c, g * per, (g + 1) * per) for g, c in enumerate(cards)]


def _check_devices(sender_devs, groups, cards) -> str:
    """The one device type of the senders and the receivers' cards;
    without `cards`, every sender lies on the receivers' device."""
    if cards is None:
        kind = groups[0][0].type
        if any(d != groups[0][0] for d in sender_devs):
            raise ValueError("the senders' arrays and sizes must lie on one device, or `cards` must name the "
                             "receivers'")
    else:
        types = {d.type for d in sender_devs} | {c.type for c, _, _ in groups}
        if len(types) != 1:
            raise ValueError(f"the senders and the receivers' cards mix device types: {sorted(types)}")
        (kind,) = types
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind}")
    return kind


_peer_on: set = set()  # (card, peer) pairs with peer access on, in this process


def enable_peer_access(card: torch.device, peers) -> None:
    """Let `card` read the memory of each card of `peers` (once per ordered
    pair; csrc/ragged_shuffle.cu `dft_enable_peer_access`). Raises where a
    pair has no peer path: the kernels never fall back to staged copies."""
    from datafusion_tpu_torch.errors import ExecutionError
    from datafusion_tpu_torch.ops.pallas.cuda_lib import load_library

    for peer in peers:
        pair = (card.index, peer.index)
        if peer == card or pair in _peer_on:
            continue
        rc = load_library().dft_enable_peer_access(*pair)
        if rc != 0:
            raise ExecutionError(f"card {card} cannot read card {peer}'s memory (CUDA error {rc}): K5 / K6 need "
                                 "peer access between the mesh's cards")
        _peer_on.add(pair)


class _CardOrder:
    """The events that order one exchange across cards (module doc)."""

    def __init__(self, sender_devs):
        self.senders = list(dict.fromkeys(sender_devs))
        self.ready = []
        for d in self.senders:
            e = torch.cuda.Event()
            e.record(torch.cuda.current_stream(d))
            self.ready.append(e)
        self.done = []

    def before(self, card: torch.device) -> int:
        """Card `card`'s stream, after every sender card's regions; its
        peer access to them on. Returns the raw stream."""
        enable_peer_access(card, self.senders)
        stream = torch.cuda.current_stream(card)
        for e in self.ready:
            stream.wait_event(e)
        return stream.cuda_stream

    def after(self, card: torch.device) -> None:
        e = torch.cuda.Event()
        e.record(torch.cuda.current_stream(card))
        self.done.append(e)

    def release(self) -> None:
        """Every sender card's stream waits for every receiving card's
        launches before it may reuse a send buffer."""
        for d in self.senders:
            stream = torch.cuda.current_stream(d)
            for e in self.done:
                stream.wait_event(e)


# --- K5 ---------------------------------------------------------------------


def _check_exchange(sends, sizes, n_dev, split_cap, chunk) -> list[torch.device]:
    """Every check in one pass: sender 0's arrays in full, every other
    sender's against sender 0's (dtype, shape, contiguity), each sender's
    on one device. Returns each sender's device."""
    if len(sends) != sizes.shape[0]:
        raise ValueError("one list of arrays per sender")
    if chunk not in CHUNKS or split_cap % chunk:
        raise ValueError(f"chunk must be one of {CHUNKS} and divide split_cap")
    _check_sizes(sizes, len(sends), n_dev, split_cap)
    devs = [arrs[0].device if arrs else sizes.device for arrs in sends]
    for t in sends[0]:
        _check_region(t, n_dev, split_cap, devs[0])
        if t.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"dtype {t.dtype} is not 1, 2, 4 or 8 bytes wide")
    spec = [(t.dtype, t.shape, t.is_contiguous()) for t in sends[0]]
    for arrs, dev in zip(sends[1:], devs[1:]):
        if len(arrs) != len(spec):
            raise ValueError("every sender sends the same arrays")
        if [(t.dtype, t.shape, t.is_contiguous()) for t in arrs] != spec or any(t.device != dev for t in arrs):
            raise ValueError("every sender's arrays must have sender 0's dtypes, shapes and contiguity, on one device")
    return devs


def _sizes_block(sizes: torch.Tensor, lo: int, hi: int, card: torch.device) -> torch.Tensor:
    """The count matrix's columns [lo, hi) on `card`: `sizes` itself for
    every column, else a contiguous copy (one peer copy of the counts
    where `sizes` lies on another card)."""
    if (lo, hi) == (0, sizes.shape[1]) and sizes.device == card:
        return sizes
    block = sizes[:, lo:hi].contiguous()
    return block if block.device == card else block.to(card)


def _regions_from(ts, lo: int, hi: int, split_cap: int):
    """Regions [lo, hi) of region-layout arrays (views; None stays None)."""
    return [None if t is None else t[lo * split_cap: hi * split_cap] for t in ts]


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


@spanned("dft.kernel.K5")
def ragged_exchange(
    sends: Sequence[Sequence[torch.Tensor]],
    sizes: torch.Tensor,
    *,
    n_dev: int,
    split_cap: int,
    chunk: int,
    cards=None,
) -> list[list[torch.Tensor]]:
    """All-to-all of region-layout arrays (K5, module doc): `sends[j]` are
    sender j's `[n_dev * split_cap]` arrays; returns each of the `n_dev`
    receivers' `[len(sends) * split_cap]` arrays, valid in region j's
    first `sizes[j, i]` rows. `cards`: the receivers' cards (module doc;
    None: all on `sizes`' device). On the card they are read-only views
    of one buffer per array and card; one launch per card and
    `exchange_args` entry: the receiving card pulls its rows."""
    sends = [list(s) for s in sends]
    sender_devs = _check_exchange(sends, sizes, n_dev, split_cap, chunk)
    groups = card_groups(cards, n_dev, sizes)
    kind = _check_devices(sender_devs, groups, cards)
    n_send = len(sends)
    out = []
    def part(lo, hi):  # every sender's regions [lo, hi): the arrays themselves for one launch
        return sends if len(groups) == 1 else [_regions_from(a, lo, hi, split_cap) for a in sends]

    if kind == "cpu":
        for card, lo, hi in groups:
            out += ragged_exchange_plain(part(lo, hi), _sizes_block(sizes, lo, hi, card), n_dev=hi - lo,
                                         split_cap=split_cap, chunk=chunk)
        return out
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    order = None if cards is None else _CardOrder(sender_devs)
    for g, (card, lo, hi) in enumerate(groups):
        nr = hi - lo
        bufs = [torch.empty(nr * n_send * split_cap, dtype=t.dtype, device=card) for t in sends[0]]
        if bufs and split_cap:
            block = _sizes_block(sizes, lo, hi, card)
            with torch.cuda.device(card):
                stream = torch.cuda.current_stream(card).cuda_stream if order is None else order.before(card)
                for x in exchange_args(part(lo, hi), bufs):
                    check(lib.dft_ragged_exchange(ctypes.byref(x), block.data_ptr(), n_send, nr, split_cap, chunk,
                                                  stream),
                          "ragged_exchange kernel")
                    ragged_exchange.launches += 1
                    ragged_exchange.card_launches[g] += 1
                if order is not None:
                    order.after(card)
        out += receivers(bufs, nr, n_send, split_cap)
    if order is not None:
        order.release()
    return out


# --- K6 ---------------------------------------------------------------------


def _check_fold(gids, vals, masks, sizes, ops, mask_map, n_dev, split_cap, num_groups) -> list[torch.device]:
    """The fold's checks; returns each sender's device."""
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
    _check_sizes(sizes, n_send, n_dev, split_cap)
    # the ops and value dtypes once; the kernel takes each op's kind from sender 0
    _validate(gids[0], vals[0], [None] * len(ops), ops, num_groups, dense=False)
    dtypes = [None if v is None else v.dtype for v in vals[0]]
    seen, devs = set(), []
    for j in range(n_send):
        if len(vals[j]) != len(ops) or len(masks[j]) != len(masks[0]):
            raise ValueError("every sender sends one value per op and the same masks")
        if gids[j].dtype != torch.int32 or [None if v is None else v.dtype for v in vals[j]] != dtypes:
            raise ValueError("every sender's window ids are int32 and its values have sender 0's dtypes")
        if any(m.dtype != torch.bool for m in masks[j]):
            raise ValueError("masks must be bool")
        devs.append(gids[j].device)
        for t in (gids[j], *vals[j], *masks[j]):  # each distinct array once
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                _check_region(t, n_dev, split_cap, devs[j])
    return devs


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


@spanned("dft.kernel.K6")
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
    cards=None,
    agree=None,
) -> list[tuple[torch.Tensor, ...]]:
    """Exchange fused with a dense fold (K6, module doc). `gids[j]`,
    `vals[j][a]` (None for a COUNT) and `masks[j][u]` are sender j's
    region-layout window ids, per-op values and deduplicated bool masks,
    `[n_dev * split_cap]` each; `mask_map[a]` is 0 (every routed row) or
    1 + the index of op a's mask. `cards`: the receivers' cards (module
    doc). `agree(words)`: this process's largest float-SUM scale words
    (int64, one per float SUM) to the mesh's, where other processes hold
    receivers too. Returns, per each of the `n_dev` receivers, one
    `[num_groups]` table per op, on its card."""
    ops, mask_map = tuple(ops), tuple(mask_map)
    sender_devs = _check_fold(gids, vals, masks, sizes, ops, mask_map, n_dev, split_cap, num_groups)
    groups = card_groups(cards, n_dev, sizes)
    kind = _check_devices(sender_devs, groups, cards)

    def part(lo, hi):  # every sender's regions [lo, hi): the arrays themselves for one launch
        if len(groups) == 1:
            return gids, vals, masks
        return ([_regions_from([g], lo, hi, split_cap)[0] for g in gids],
                [_regions_from(v, lo, hi, split_cap) for v in vals],
                [_regions_from(m, lo, hi, split_cap) for m in masks])

    if kind == "cpu":
        out = []
        for card, lo, hi in groups:
            out += ragged_exchange_fold_plain(*part(lo, hi), _sizes_block(sizes, lo, hi, card), ops=ops,
                                              mask_map=mask_map, n_dev=hi - lo, split_cap=split_cap,
                                              num_groups=num_groups)
        return out
    from datafusion_tpu_torch.ops.pallas.cuda_lib import check, load_library

    lib = load_library()
    k = len(ops)
    if not (k and split_cap and num_groups):  # nothing to launch
        out = []
        for card, lo, hi in groups:
            tables = _finish(ops, vals[0], _identity_tables(ops, vals[0], num_groups, card, lead=(hi - lo,)))
            out += [tuple(t[i] for t in tables) for i in range(hi - lo)]
        return out
    check_fixed_rows(ops, vals[0], len(gids) * split_cap)  # the most rows one receiver's slots fold
    launches = fold_launches(fold_widths(ops, vals[0]), num_groups)
    order = None if cards is None else _CardOrder(sender_devs)
    fts, calls = [], []
    for card, lo, hi in groups:  # each card's tables, pointer tables and launches
        g_p, v_p, m_p = part(lo, hi)
        ft = fold_tables(ops, vals[0], num_groups, card, lead=(hi - lo,), counters=len(launches), fixed=True)
        per_op = [_op_masks(m, mask_map) for m in m_p]
        tables = [fold_pointer_table(g_p, v_p, per_op, range(a, b)) for a, b, _ in launches]
        ptrs = torch.tensor([p for t in tables for p in t], dtype=torch.int64).pin_memory()
        with torch.cuda.device(card):
            ptrs = ptrs.to(card, non_blocking=True)
        fts.append(ft)
        calls.append((card, hi - lo, _sizes_block(sizes, lo, hi, card), ptrs, [len(t) for t in tables]))

    def run(phases):
        for g, (ft, (card, nr, block, ptrs, lens)) in enumerate(zip(fts, calls)):
            with torch.cuda.device(card):
                stream = torch.cuda.current_stream(card).cuda_stream if order is None else order.before(card)
                at = ptrs.data_ptr()
                for (lo, hi, reps), n_ptrs, done in zip(launches, lens, ft.counters):
                    rc = lib.dft_ragged_exchange_fold(at, block.data_ptr(), len(gids), nr, split_cap, num_groups,
                                                      reps, hi - lo, *c_entries(ops, vals[0], ft, lo, hi, fixed=True),
                                                      done, phases, stream)
                    check(rc, "ragged_exchange_fold kernel")
                    if phases & 2:
                        ragged_exchange_fold.launches += 1
                        ragged_exchange_fold.card_launches[g] += 1
                    at += 8 * n_ptrs
                if order is not None:
                    order.after(card)

    fix = [a for a, at in enumerate(fts[0].scale_at) if at is not None]
    if fix and (len(groups) > 1 or agree is not None):
        run(1)  # each card's first pass: its receivers' largest |value| per float SUM
        first = groups[0][0]
        words = torch.stack([torch.cat([ft.scale(a) for a in fix]).to(first) for ft in fts]).amax(0)
        if agree is not None:
            words = agree(words)
        for ft in fts:  # the mesh's scale into every card's words
            for w, a in zip(words.unbind(0), fix):
                ft.scale(a).copy_(w.reshape(1))
        run(2)
    else:
        run(3)
    if order is not None:
        order.release()
    return [r for ft in fts for r in zip(*[t.unbind(0) for t in ft.tables])]


# CUDA kernel launches (K5: one per `exchange_args` entry, K6: one per `fold_launches` entry), in all and by
# logical card
ragged_exchange.launches = 0
ragged_exchange_fold.launches = 0
ragged_exchange.card_launches = collections.Counter()
ragged_exchange_fold.card_launches = collections.Counter()
