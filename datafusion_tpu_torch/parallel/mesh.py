"""The mesh of logical shards a distributed query runs over.

Port of datafusion_tpu/parallel/mesh.py. The JAX package runs one
controller over a 1-D `jax.sharding.Mesh` of chips (single-controller
SPMD). Its counterpart here is one process with `n_dev` logical shards
on one device: a table's rows split into `n_dev` contiguous row blocks,
each stage runs once per shard, and every collective is a function over
the list of per-shard tensors (parallel/collectives.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from datafusion_tpu_torch.columnar.table import Column, Table, resolve_device


@dataclass(frozen=True)
class Mesh:
    """`n_dev` logical shards, all on `device`."""

    n_dev: int
    device: torch.device


def make_mesh(n_dev: int = 8, device=None) -> Mesh:
    """A mesh of `n_dev` logical shards on the card, unless the caller
    names another device (the tests pass "cpu")."""
    if n_dev < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(n_dev, resolve_device(device))


def shard_bounds(n: int, n_dev: int) -> list[tuple[int, int]]:
    """Row block of each shard: shard i holds [i*b, min((i+1)*b, n)) with
    b = ceil(n / n_dev); the last blocks may be short or empty."""
    b = -(-n // n_dev)
    return [(min(i * b, n), min((i + 1) * b, n)) for i in range(n_dev)]


def partition_table(table: Table, mesh: Mesh) -> list[Table]:
    """The table's row blocks (`shard_bounds`), one Table per shard. On
    one device they are views of the table's tensors: nothing is copied."""
    shards = []
    for lo, hi in shard_bounds(table.num_rows, mesh.n_dev):
        cols = tuple(
            Column(c.dtype, c.data[lo:hi], None if c.validity is None else c.validity[lo:hi], c.dictionary)
            for c in table.columns
        )
        shards.append(Table(table.schema, cols, hi - lo))
    return shards
