"""The mesh of logical shards a distributed query runs over.

Port of datafusion_tpu/parallel/mesh.py. The JAX package runs one 1-D
`jax.sharding.Mesh` of chips, over one host or several. Its counterpart
here is `n_dev` logical shards, split over the `world` processes of a
`torch.distributed` group: process `rank` holds the `n_local` shards
`[rank * n_local, (rank + 1) * n_local)` on its own device. A table's
rows split into contiguous row blocks, one per shard; each stage runs
once per local shard, and every collective takes this process's list of
per-shard tensors and returns what every shard would hold afterwards, in
global shard order (parallel/collectives.py). `make_mesh(n)` is the mesh
of one process, all its shards on one device; `global_mesh`
(parallel/multihost.py) spans the processes.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from datafusion_tpu_torch.columnar.table import Column, Table, resolve_device
from datafusion_tpu_torch.schema import Schema


@dataclass(frozen=True)
class Mesh:
    """`n_dev` logical shards; this process holds `n_local` of them, from
    shard `rank * n_local`, on `device`. A mesh of `world > 1` processes
    runs its collectives over torch.distributed's default group."""

    n_dev: int
    device: torch.device
    rank: int = 0
    world: int = 1
    n_local: int = 0  # 0: every shard (one process)

    def __post_init__(self):
        if self.n_local == 0:
            object.__setattr__(self, "n_local", self.n_dev)
        if self.n_local * self.world != self.n_dev:
            raise ValueError(f"{self.world} process(es) of {self.n_local} shard(s) do not make {self.n_dev} shards")

    @property
    def spans(self) -> bool:
        """Whether the shards lie in more than one process."""
        return self.world > 1

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.n_local


def make_mesh(n_dev: int = 8, device=None) -> Mesh:
    """A mesh of `n_dev` logical shards in this process, on the card unless
    the caller names another device (the tests pass "cpu")."""
    if n_dev < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(n_dev, resolve_device(device))


def shard_bounds(n: int, n_dev: int) -> list[tuple[int, int]]:
    """Row block of each shard: shard i holds [i*b, min((i+1)*b, n)) with
    b = ceil(n / n_dev); the last blocks may be short or empty."""
    b = -(-n // n_dev)
    return [(min(i * b, n), min((i + 1) * b, n)) for i in range(n_dev)]


@dataclass(frozen=True)
class RankTable:
    """A table on a mesh that spans processes: this process's rows only,
    as JAX's global arrays keep only the addressable shards on a host.
    `columns` hold the rows of this process's shards, shard after shard,
    `shard_rows[i]` rows for local shard i; `num_rows` counts the rows of
    every process, and each Utf8 column's dictionary is the global one.
    The plan compiler reads `schema`, `columns` (dictionaries and, through
    the mesh's collectives, min / max probes) and `num_rows` as it reads a
    Table's."""

    schema: Schema
    columns: tuple[Column, ...]
    num_rows: int
    shard_rows: tuple[int, ...]

    def __post_init__(self):
        caps = {c.capacity for c in self.columns}
        if caps and caps != {sum(self.shard_rows)}:
            raise ValueError(f"column lengths {sorted(caps)} != the local shards' {sum(self.shard_rows)} rows")

    @property
    def local_rows(self) -> int:
        return sum(self.shard_rows)

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device if self.columns else torch.device("cpu")

    def to(self, device) -> "RankTable":
        return RankTable(self.schema, tuple(c.to(device) for c in self.columns), self.num_rows, self.shard_rows)


def local_blocks(table: Table, mesh: Mesh) -> RankTable:
    """This process's row blocks of a whole table that every process holds
    (`register_table` on a spanning mesh): the rows of shards
    `[first, first + n_local)` of `shard_bounds`, so each shard holds the
    rows it holds on one process. They are copied, so the whole table's
    tensors need not stay alive."""
    bounds = shard_bounds(table.num_rows, mesh.n_dev)[mesh.first:mesh.first + mesh.n_local]
    lo, hi = bounds[0][0], bounds[-1][1]
    cols = tuple(
        Column(c.dtype, c.data[lo:hi].clone(), None if c.validity is None else c.validity[lo:hi].clone(),
               c.dictionary)
        for c in table.columns
    )
    return RankTable(table.schema, cols, table.num_rows, tuple(b - a for a, b in bounds))


def partition_table(table, mesh: Mesh) -> list[Table]:
    """This process's shards of a table, one Table per local shard: the
    row blocks of `shard_bounds` for a whole Table on one process, the
    blocks a RankTable records on a spanning mesh. Both are views of the
    table's tensors: nothing is copied. On a spanning mesh the table must
    be a RankTable already (ExecutionContext.register_table makes it)."""
    if mesh.spans and not isinstance(table, RankTable):
        raise ValueError("a mesh that spans processes partitions a RankTable, not a whole table")
    if isinstance(table, RankTable):
        lo, spans = 0, []
        for r in table.shard_rows:
            spans.append((lo, lo + r))
            lo += r
    else:
        spans = shard_bounds(table.num_rows, mesh.n_dev)
    shards = []
    for lo, hi in spans:
        cols = tuple(
            Column(c.dtype, c.data[lo:hi], None if c.validity is None else c.validity[lo:hi], c.dictionary)
            for c in table.columns
        )
        shards.append(Table(table.schema, cols, hi - lo))
    return shards
