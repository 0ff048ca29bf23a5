"""The system under test: the port's session over the generated tensors.
This is the only module of the harness that imports the port."""

from __future__ import annotations

from typing import Optional

import datafusion_tpu_torch as port
import torch
from datafusion_tpu_torch.parallel.mesh import ShardTable

from portbench.core.tables import Tables

KIND_TYPES = {"int32": "Int32", "float32": "Float32", "float64": "Float64", "date": "Date32", "str": "Utf8"}


def port_table(tab, shards: int = 0):
    """One generated table as the port's, over the same tensors: a Table
    of its one block, or, on a mesh, a ShardTable of its blocks, one per
    shard, each already on its shard's card."""
    fields = [port.Field(c.name, getattr(port.DataType, KIND_TYPES[c.kind]), False) for c in tab.cols]
    schema = port.Schema(fields)

    def block(i: int):
        cols = tuple(port.Column(f.dtype, c.blocks[i], None, c.vocab) for f, c in zip(fields, tab.cols))
        return port.Table(schema, cols, int(tab.cols[0].blocks[i].shape[0]))

    if not shards:
        return block(0)
    return ShardTable(schema, tuple(block(i) for i in range(len(tab.cols[0].blocks))), tab.rows)


def mesh(shards: Optional[int], cards: list):
    """The port's mesh of `shards` logical shards over `cards`, or None."""
    return port.make_mesh(shards, devices=cards) if shards else None


def homes(m, device) -> list:
    """The device of each row block the tables are made in: each shard's
    card, in shard order, on a mesh; else `device` alone."""
    return [m.card_of(d) for d in range(m.n_local)] if m is not None else [torch.device(device)]


def session(tables: Tables, device, m=None):
    """An ExecutionContext holding every table: on `device`, or over the
    mesh `m`. The session's default routes: no bigdense request, no
    environment setting read here."""
    ctx = port.ExecutionContext(mesh=m) if m is not None else port.ExecutionContext(device=device)
    for name, tab in tables.tabs.items():
        ctx.register_table(name, port_table(tab, m.n_local if m is not None else 0))
    return ctx


def counters() -> dict[str, int]:
    """The port's own counters: each kernel wrapper's launches and the
    bytes the mesh's collectives copy between cards."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.ops.pallas import segreduce as sr
    from datafusion_tpu_torch.parallel import collectives

    return {
        "fused_stage_kernel": fs.run_fused.launches,
        "seg_sorted_kernel": sr.segmented_reduce.sorted_launches,
        "seg_dense_kernel": sr.segmented_reduce.dense_launches,
        "slab_partition_kernel": pt.slab_partition.launches,
        "windowed_reduce_kernel": pt.windowed_reduce.launches,
        "ragged_exchange_kernel": rs.ragged_exchange.launches,
        "ragged_exchange_fold_kernel": rs.ragged_exchange_fold.launches,
        "to_card_bytes": collectives.to_card.bytes,
    }
