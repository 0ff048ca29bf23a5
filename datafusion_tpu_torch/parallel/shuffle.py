"""Repartitioning (shuffle) between the logical shards of a mesh.

Port of datafusion_tpu/parallel/shuffle.py. Rows move to shard
`dst[row]`:

  1. each shard orders its selected rows by destination (a stable sort)
     and counts them per destination (`route`)
  2. the `[n_dev, n_dev]` count matrix is read on the host once, and the
     region capacity `split_cap` is the largest count rounded up to
     K5's largest chunk (`region_capacity`); so no row is ever dropped, and the JAX
     package's static capacity and overflow retry have no counterpart
  3. each shard lays its ordered rows into the `[n_dev * split_cap]`
     region layout by an ascending gather (`build_regions`)
  4. K5 moves the live chunks (ops/pallas/ragged_shuffle.py), and each
     receiver's selection is its regions' valid prefixes

The JAX package's default exchange, a `lax.all_to_all` of the padded
slabs, would be a transpose copy on one card that moves more bytes for
the same rows, so K5 is the only exchange and DFTPU_SHUFFLE is not read.

On a mesh that spans processes the exchange has two levels. The count
matrix is the whole mesh's (every process agrees on `split_cap`), and
each process lays out its own shards' rows. The regions bound for other
processes' shards cross in one `all_to_all_single` of their padded
regions (parallel/collectives.py `exchange_regions`), the counterpart of
the `lax.all_to_all` across hosts of the JAX package's default exchange.
Then one K5 launch (or K6, for the fold) takes every shard of the mesh as
a sender, the local ones from their own buffers and the remote ones from
what arrived, and fills this process's receivers: region j of a receiver
still holds global sender j's rows, so rows arrive in the single card's
order. K6's float-SUM scale is agreed over the processes
(collectives.agreed_max), so every process folds on the mesh's grid.

On a mesh of several cards (parallel/mesh.py) each shard routes and lays
out its rows on its own card, and K5 / K6 take one launch per card over
its receivers, reading every sender's regions where they lie, over
NVLink for a peer card's (ops/pallas/ragged_shuffle.py `cards`). The
count matrix meets on the first card and is read on the host once, as on
one card; each receiver's selection is made on its card. A mesh that
spans processes with several cards in each takes both at once: the
senders are this process's shards, on their own cards, and the remote
senders' regions, on the first card, where `exchange_regions` leaves
them; each card's launch reads both, and the count matrix and each
receiver's selection keep the global shard numbering.
"""

from __future__ import annotations

from typing import Sequence

import torch

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.ops.expr_eval import ColVal, broadcast_col
from datafusion_tpu_torch.ops.pallas.ragged_shuffle import CHUNKS, pick_chunk, ragged_exchange, ragged_exchange_fold
from datafusion_tpu_torch.parallel.collectives import agreed_max, exchange_regions, size_matrix, to_card
from datafusion_tpu_torch.utils.trace import span

REGION_ALIGN = CHUNKS[0]  # split_cap is a multiple of the largest chunk, so K5 copies 1024-row chunks


M32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, c < 2^32: the
    constant goes in two 16-bit halves so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def hash_keys_to_device(keys, n_dev: int, *, salt_r: int = 1, salt=None) -> torch.Tensor:
    """The JAX package's key hash, element for element: each key column
    as uint32 (integers wrap to their low 32 bits, floats truncate toward
    zero), mixed (`* 2654435761`, `^ >> 16`), combined (`h * 31 + m`),
    finished (`^ >> 13`), and taken mod `n_dev`. torch has no uint32
    arithmetic on the card, so it runs in int64 masked to 32 bits after
    every multiply and add.

    Skew salting (`salt_r` > 1): a key's rows spread over `salt_r` shards,
    `h * salt_r + salt`; probe rows pass `salt = row % salt_r`, and the
    build side replicates each row once per salt value."""
    h = None
    for k in keys:
        k = k.to(torch.int64) & M32
        m = _mul_u32(k, 2654435761)
        m = m ^ (m >> 16)
        h = m if h is None else (_mul_u32(h, 31) + m) & M32
    h = h ^ (h >> 13)
    if salt_r > 1:
        s = 0 if salt is None else salt.to(torch.int64) & M32
        h = (_mul_u32(h, salt_r) + s) & M32
    return (h % n_dev).to(torch.int32)


def skew_salt(sizes: torch.Tensor, n_dev: int) -> int:
    """The hash-shuffle join's skew salt, by the JAX package's rule: the
    probe side's largest send cell over 4x the balanced share (its total
    over n_dev^2) gives the need, capped at n_dev; a need above 1 salts
    over max(2, min(n_dev, the next power of two)) shards. One host read."""
    top, total = torch.stack([sizes.max(), sizes.sum()]).tolist() if sizes.numel() else (0, 0)
    bal = max(total // (n_dev * n_dev), 1)
    need = min(-(-top // (4 * bal)), n_dev)
    return 1 if need <= 1 else max(2, min(n_dev, 1 << (need - 1).bit_length()))


def route(dst: torch.Tensor, sel: torch.Tensor, n_dev: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's selected rows, stably ordered by destination, and
    their count per destination."""
    rows = torch.nonzero(sel).squeeze(1)
    d = dst[rows]
    rows = rows[torch.sort(d, stable=True).indices]
    return rows, torch.bincount(d, minlength=n_dev)


def region_capacity(sizes: torch.Tensor) -> tuple[int, int]:
    """(split_cap, chunk): the largest count rounded up to REGION_ALIGN
    (one host read), and the K5 chunk dividing it."""
    top = int(sizes.max()) if sizes.numel() else 0
    split_cap = max(REGION_ALIGN, -(-top // REGION_ALIGN) * REGION_ALIGN)
    return split_cap, pick_chunk(split_cap)


def build_regions(
    arrays: Sequence[torch.Tensor],
    rows: torch.Tensor,
    counts: torch.Tensor,
    n_dev: int,
    split_cap: int,
) -> list[torch.Tensor]:
    """Lay `rows` (ordered by destination, `counts` per destination) of
    each array into the `[n_dev * split_cap]` region layout by an
    ascending gather; the padding rows repeat a live row (or are zero on
    a shard with none)."""
    dev = counts.device
    if rows.shape[0] == 0:
        return [torch.zeros(n_dev * split_cap, dtype=a.dtype, device=dev) for a in arrays]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n_dev * split_cap, device=dev)
    dest = torch.div(slot, split_cap, rounding_mode="floor")
    src = (starts[dest] + slot - dest * split_cap).clamp(max=rows.shape[0] - 1)
    perm = rows[src]
    return [a[perm] for a in arrays]


def receive_selection(sizes: torch.Tensor, i: int, split_cap: int) -> torch.Tensor:
    """Receiver i's selection: region j is valid in its first sizes[j, i] rows."""
    slot = torch.arange(sizes.shape[0] * split_cap, device=sizes.device)
    dest = torch.div(slot, split_cap, rounding_mode="floor")
    return slot - dest * split_cap < sizes[:, i].to(torch.int64)[dest]


def _cards(mesh):
    """The receivers' cards for the kernels: the mesh's, where it has
    several; None where every shard lies on one device."""
    return None if mesh is None or mesh.n_cards == 1 else mesh.devices


def _sizes_on(sizes: torch.Tensor, mesh) -> list[torch.Tensor]:
    """The count matrix on each local shard's card (one copy per card)."""
    if mesh is None:
        return [sizes] * sizes.shape[0]
    on = {c: to_card(sizes, c) for c in dict.fromkeys(mesh.devices)}
    return [on[mesh.card_of(d)] for d in range(mesh.n_local)]


def _local_exchange(regions, sizes: torch.Tensor, split_cap: int, mesh):
    """(senders' arrays, their count matrix, receivers) for the kernels on
    this process: every shard as on one process, or, on a spanning mesh,
    every shard of the mesh as a sender (`exchange_regions`) and this
    process's shards as the receivers."""
    if mesh is None or not mesh.spans:
        return regions, sizes, sizes.shape[0]
    lo = mesh.first
    local_sizes = sizes[:, lo:lo + mesh.n_local].contiguous()
    return exchange_regions(mesh, regions, sizes, split_cap), local_sizes, mesh.n_local


def repartition(
    cols: Sequence[Sequence[ColVal]],
    dsts: Sequence[torch.Tensor],
    sels: Sequence[torch.Tensor],
    n_dev: int,
    routes=None,
    mesh=None,
) -> tuple[list[list[ColVal]], list[torch.Tensor]]:
    """Move every selected row of shard j to shard `dsts[j][row]`.
    `cols[j]` are this process's shard j's columns; returns each of its
    receivers' columns and selection over its `n_dev * split_cap` received
    slots. Rows arrive sender by sender, in each sender's order. `routes`:
    the senders' `route` results, where the caller has them already.
    `mesh`: the mesh, where it spans processes."""
    with span("dft.shuffle.send"):
        if routes is None:
            routes = [route(d, s, n_dev) for d, s in zip(dsts, sels)]
        sizes = size_matrix([c for _, c in routes], mesh)
        split_cap, chunk = region_capacity(sizes)
        sends, spec = [], None
        for shard_cols, sel, (rows, counts) in zip(cols, sels, routes):
            flat, spec = [], []
            for cv in shard_cols:
                d, v = broadcast_col(cv, sel.shape[0])
                # bool rides as bytes, and comes back through `!= 0`
                spec.append((d.dtype == torch.bool, v is not None))
                flat.append(d.view(torch.uint8) if d.dtype == torch.bool else d)
                if v is not None:
                    flat.append(v.view(torch.uint8))
            sends.append(build_regions(flat, rows, counts, n_dev, split_cap))
    first = 0 if mesh is None else mesh.first
    if sends[0]:
        senders, local_sizes, n_recv = _local_exchange(sends, sizes, split_cap, mesh)
        recvs = ragged_exchange(senders, local_sizes, n_dev=n_recv, split_cap=split_cap, chunk=chunk,
                                cards=_cards(mesh))
    else:  # no arrays to move: only the selections
        n_recv = len(cols)
        recvs = [[] for _ in range(n_recv)]
    out_cols = []
    for arrs in recvs:
        it = iter(arrs)
        shard = []
        for is_bool, has_valid in spec:
            d = next(it)
            shard.append((d != 0 if is_bool else d, next(it) != 0 if has_valid else None))
        out_cols.append(shard)
    return out_cols, [receive_selection(sz, first + i, split_cap) for i, sz in enumerate(_sizes_on(sizes, mesh))]


def exchange_fold(gids, vals, masks, *, ops, num_groups, n_dev, mesh=None):
    """The distributed fold as a mesh-wide reduce
    (ops/aggregate.py `_dense_window_aggregate`): shard j's rows with a
    packed id below `num_groups` go to shard `id % n_dev` as window
    `id // n_dev`, each distinct value and mask once, and K6 folds them
    into each receiver's `ceil(num_groups / n_dev)` slots. `vals[j][a]` /
    `masks[j][a]` are this process's shard j's op a value (None for
    COUNT) and mask (None: every routed row). Returns each of this
    process's receivers' per-op tables; on a spanning mesh the remote
    senders' regions arrive first (`exchange_regions`) and the same K6
    launch folds them."""
    with span("dft.shuffle.send"):
        routes, arrays, layouts = [], [], []
        for gid, v, m in zip(gids, vals, masks):
            g = gid.to(torch.int64)
            routes.append(route(g % n_dev, gid < num_groups, n_dev))
            distinct = list({id(t): t for t in list(v) + list(m) if t is not None}.values())
            arrays.append([(g // n_dev).to(torch.int32)] + distinct)
            at = {id(t): k for k, t in enumerate(distinct, 1)}
            uniq = list(dict.fromkeys(id(t) for t in m if t is not None))
            layouts.append(([None if t is None else at[id(t)] for t in v],
                            [at[u] for u in uniq],
                            [0 if t is None else 1 + uniq.index(id(t)) for t in m]))
        if any(lay != layouts[0] for lay in layouts):
            raise ExecutionError("the shards built different fold operands")
        val_at, mask_at, mask_map = layouts[0]
        sizes = size_matrix([c for _, c in routes], mesh)
        split_cap, _ = region_capacity(sizes)
        regions = [build_regions(arrs, rows, counts, n_dev, split_cap) for arrs, (rows, counts) in zip(arrays, routes)]
    senders, local_sizes, n_recv = _local_exchange(regions, sizes, split_cap, mesh)
    agree = (lambda words: agreed_max(words, mesh)) if mesh is not None and mesh.spans else None
    return ragged_exchange_fold([r[0] for r in senders], [[None if k is None else r[k] for k in val_at] for r in senders],
                                [[r[k] for k in mask_at] for r in senders], local_sizes, ops=ops, mask_map=mask_map,
                                n_dev=n_recv, split_cap=split_cap, num_groups=-(-num_groups // n_dev),
                                cards=_cards(mesh), agree=agree)
