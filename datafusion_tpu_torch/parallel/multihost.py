"""Execution over several processes, and the port's one device-to-host path.

Port of datafusion_tpu/parallel/multihost.py. The JAX package stitches
every host's chips into one global mesh with `jax.distributed`, and XLA
inserts the collectives. Here the processes join one `torch.distributed`
group (`initialize_multihost`), and `global_mesh` gives each process a
block of the mesh's logical shards on its own device: the distributed
compiler (parallel/dist.py) runs each stage over the local shards, and
its collectives and exchanges cross the processes (parallel/collectives.py,
parallel/shuffle.py). Every process runs the same statements in the same
order (SPMD), as under JAX's multi-controller runtime.

The backend is NCCL when every process of the host has cards of its
own, else Gloo: NCCL refuses two processes on one card, so processes
that share a card exchange through host memory. A process may hold
several cards (`cards_per_process`, `global_mesh(devices=...)`), as a
TPU host holds four chips of the JAX package's global mesh: its shards
split over them, K5 and K6 read its cards' regions over NVLink and the
remote senders' from its first card, where the transport delivers them.

`to_host` reads every result from the device: one compaction, pinned
host buffers, one synchronize; on a spanning mesh the partitioned rows of
every process meet, as JAX's `process_allgather` gathers them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from datafusion_tpu_torch.utils.trace import spanned

TIMEOUT_S = 300  # a collective that the processes reach out of step fails after this, instead of hanging


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    cards_per_process: int = 1,
) -> str:
    """Join this process to the group (call once per process, before
    `global_mesh`). `coordinator_address` is the "host:port" of process
    0's rendezvous; None reads the torchrun variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK). Each process of this host
    (LOCAL_WORLD_SIZE of them, default `num_processes`; this one
    LOCAL_RANK, default its rank) owns `cards_per_process` cards, from
    card `LOCAL_RANK * cards_per_process`; pass them to `global_mesh` as
    `devices`. `backend` None picks NCCL when those cards exist on this
    host, and makes the process's first card the current one; with one
    card a process and more processes than cards (processes share a
    card, which NCCL refuses) it picks Gloo. Several cards a process that
    the host lacks, or without NCCL, raise: nothing falls back to Gloo or
    to fewer cards. Every collective of the group fails after TIMEOUT_S
    seconds. Returns the backend."""
    import torch.distributed as dist

    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if cards_per_process < 1:
        raise ValueError("a process needs at least one card")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    own_cards = local_world * cards_per_process <= have
    if cards_per_process > 1 and not own_cards:
        raise ValueError(f"{local_world} process(es) of {cards_per_process} cards need "
                         f"{local_world * cards_per_process} cards; this host has {have}")
    if backend is None:
        if cards_per_process > 1 and not dist.is_nccl_available():
            raise ValueError("several cards a process need NCCL, and this torch has none")
        backend = "nccl" if own_cards and dist.is_nccl_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank * cards_per_process)
    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend


def global_mesh(n_local: int = 4, device=None, devices=None):
    """The mesh of `world * n_local` shards over every process of the
    group; this process holds shards `[rank * n_local, (rank + 1) *
    n_local)` on `device` (default: the card; under NCCL, this process's
    first), or split in contiguous blocks over the cards `devices` lists
    (parallel/mesh.py `mesh_cards`: one device type, first `device` where
    both are given; a device may repeat, each entry a logical card of its
    own). Without a group it is `make_mesh(n_local, device, devices)`."""
    import torch.distributed as dist

    from datafusion_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_cards

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(n_local, device, devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev, devs = mesh_cards(device, devices)
    return Mesh(world * n_local, dev, rank=rank, world=world, n_local=n_local, devices=devs)


@spanned("dft.to_host")
def to_host(x, sel: Optional[torch.Tensor] = None, *, mesh=None):
    """Device tensors as host numpy arrays: the port's one device-to-host
    path. `x` is a tensor or a sequence of tensors of one length (None
    entries pass through); with a bool `sel` of that length only the
    selected rows are read. One `nonzero` of `sel`, one `index_select` per
    tensor, each copied with `non_blocking=True` into a pinned host tensor
    from torch's caching host allocator, and one synchronize, of the card
    the tensors lie on (a result of several cards meets there first, in
    `ShardedBatch.merged`, by peer copies that torch orders on both cards'
    streams, so nothing read is still being copied): the first
    call of a size pays `cudaHostAlloc`, later calls reuse the block. The
    numpy arrays share the pinned tensors' memory and keep them alive. On
    the CPU the arrays are the compacted tensors' own. The copy is bitwise.

    On a `mesh` that spans processes every process passes its own rows
    and gets every process's, in rank order: the same arrays everywhere.
    A None entry then stands for an all-true bool mask (a validity) where
    another process has a tensor, and stays None where none has
    (parallel/collectives.py `gather_rows`)."""
    from datafusion_tpu_torch.parallel.collectives import backend, gather_rows

    single = isinstance(x, torch.Tensor)
    xs = [x] if single else list(x)
    if sel is not None:
        idx = torch.nonzero(sel).squeeze(1)
        xs = [None if t is None else t.index_select(0, idx) for t in xs]
    spans = mesh is not None and mesh.spans
    live = next((t for t in xs if t is not None), None)
    if spans and live is not None and live.device.type == "cuda" and backend() == "nccl":
        xs = gather_rows(mesh, xs)  # on the card, then one copy of the gathered rows
        spans = False
    if live is not None and live.device.type == "cuda":
        host = []
        for t in xs:
            if t is not None:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
            host.append(t)
        torch.cuda.current_stream(live.device).synchronize()
        xs = host
    if spans:
        xs = gather_rows(mesh, xs, to_device=False)  # Gloo: host tensors, gathered on the host
    out = [None if t is None else t.numpy() for t in xs]
    return out[0] if single else out


def merge_string_dictionaries(vocab):
    """Merge THIS process's sorted vocabulary with every other process's
    into one globally sorted vocabulary. Returns (merged vocab tuple, int32
    remap with remap[old_code] == new_code), as the JAX package's. The
    vocabularies meet through `torch.distributed.all_gather_object`."""
    import torch.distributed as dist

    vocab = tuple(vocab)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return vocab, np.arange(len(vocab), dtype=np.int32)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, vocab)
    merged = tuple(sorted(set().union(*every)))
    index = {s: i for i, s in enumerate(merged)}
    return merged, np.array([index[s] for s in vocab], dtype=np.int32)


def register_table_shards(ctx, name: str, local) -> None:
    """Register a table of which each process holds its own rows (`local`,
    a Table): the rows keep process order, each Utf8 column's codes move
    onto the merged vocabulary (`merge_string_dictionaries`), and this
    process keeps its rows on its device, split into its `n_local` shards
    (parallel/mesh.py RankTable). Every process learns the global row
    count, and a column has a validity on every process if it has one on
    any. On a mesh of several cards a process's shards are then placed on
    their cards (ShardTable). With one process it is `ctx.register_table`."""
    import torch.distributed as dist

    from datafusion_tpu_torch.columnar.table import Column
    from datafusion_tpu_torch.parallel.mesh import RankTable, shard_bounds

    mesh = ctx.mesh
    if mesh is None or not mesh.spans:
        ctx.register_table(name, local)
        return
    local = local.to(ctx.device)
    facts = [None] * mesh.world
    dist.all_gather_object(facts, (local.num_rows, [c.validity is not None for c in local.columns]))
    total = sum(n for n, _ in facts)
    any_null = [any(f[1][j] for f in facts) for j in range(len(local.columns))]
    cols = []
    for c, has_null in zip(local.columns, any_null):
        data, vocab = c.data, c.dictionary
        if vocab is not None:
            vocab, remap = merge_string_dictionaries(vocab)
            if len(remap):
                data = torch.as_tensor(remap, device=data.device)[data.long()]
        valid = c.validity
        if has_null and valid is None:
            valid = torch.ones(local.num_rows, dtype=torch.bool, device=data.device)
        cols.append(Column(c.dtype, data, valid, vocab))
    rows = tuple(hi - lo for lo, hi in shard_bounds(local.num_rows, mesh.n_local))
    ctx.register_table(name, RankTable(local.schema, tuple(cols), total, rows))


def register_csv_shards(ctx, name: str, path: str, schema, *, has_header: bool = True) -> None:
    """Per-process sharded ingest: each process reads ITS OWN CSV file
    (`path` is process-local) through the native loader and registers
    its rows as its block of one table (`register_table_shards`: global
    dictionaries, rows in process order). With one process it is
    `register_table` of the file."""
    from datafusion_tpu_torch.columnar.csv import read_csv

    register_table_shards(ctx, name, read_csv(path, schema, has_header=has_header, device=ctx.device))
