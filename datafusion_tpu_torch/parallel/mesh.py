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
of one process, all its shards on one device; `make_mesh(n, devices=...)`
spreads them over several cards of the process, in contiguous blocks, as
the JAX package's single-process `Mesh` spans every chip of its host;
`global_mesh` (parallel/multihost.py) spans the processes.

On a mesh of several cards every per-shard stage runs on its shard's
card, each table's row blocks are placed there once, at registration
(`ShardTable`), and the collectives meet on the first card (`device`).
The entries of `devices` are logical cards: a list may repeat a device
(the tests use `("cpu",) * 4`; one H100 runs `(cuda:0, cuda:0)`), and the
shards still run and exchange card by card. A mesh that spans processes
may hold several cards in each, as the JAX package's global mesh spans
every chip of every host: each process's shards then split over its own
cards, and the global shard numbering stays `rank * n_local + d`.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from datafusion_tpu_torch.columnar.table import Column, Table, resolve_device
from datafusion_tpu_torch.schema import Schema


@dataclass(frozen=True)
class Mesh:
    """`n_dev` logical shards; this process holds `n_local` of them, from
    shard `rank * n_local`, on the cards `devices` (default: `device`
    alone): local shard d lies on `devices[d * len(devices) // n_local]`.
    `device` is the first card, where merges, host reads and replicated
    results go. A mesh of `world > 1` processes runs its collectives over
    torch.distributed's default group."""

    n_dev: int
    device: torch.device
    rank: int = 0
    world: int = 1
    n_local: int = 0  # 0: every shard (one process)
    devices: tuple = ()  # (): (device,)

    def __post_init__(self):
        if self.n_local == 0:
            object.__setattr__(self, "n_local", self.n_dev)
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))
        if self.n_local * self.world != self.n_dev:
            raise ValueError(f"{self.world} process(es) of {self.n_local} shard(s) do not make {self.n_dev} shards")
        if self.devices[0] != self.device:
            raise ValueError(f"the mesh's device {self.device} is not its first card {self.devices[0]}")
        if self.n_local % len(self.devices):
            raise ValueError(f"{self.n_local} shards do not split evenly over {len(self.devices)} cards")

    @property
    def n_cards(self) -> int:
        return len(self.devices)

    def card_index(self, d: int) -> int:
        """The logical card of local shard `d`."""
        return d * len(self.devices) // self.n_local

    def card_of(self, d: int) -> torch.device:
        """The device of local shard `d`."""
        return self.devices[self.card_index(d)]

    def card_shards(self, c: int) -> range:
        """The local shards on logical card `c`."""
        per = self.n_local // len(self.devices)
        return range(c * per, (c + 1) * per)

    @property
    def spans(self) -> bool:
        """Whether the shards lie in more than one process."""
        return self.world > 1

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.n_local


def mesh_cards(device=None, devices=None) -> tuple:
    """(first card, cards) of a mesh: `device` (the card unless the caller
    names another) alone, or the cards `devices` lists, which must hold
    one device type and start with `device` where both are given; a
    device may repeat."""
    if devices is None:
        dev = resolve_device(device)
        return dev, (dev,)
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("devices lists no card")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"the mesh's cards mix device types: {[str(d) for d in devs]}")
    if device is not None and resolve_device(device) != devs[0]:
        raise ValueError(f"device {device} is not the first of devices {[str(d) for d in devs]}")
    return devs[0], devs


def make_mesh(n_dev: int = 8, device=None, devices=None) -> Mesh:
    """A mesh of `n_dev` logical shards in this process, on the card unless
    the caller names another device (the tests pass "cpu"). `devices`
    lists the cards the shards split over, in contiguous blocks (it must
    divide `n_dev`; `mesh_cards`)."""
    if n_dev < 1:
        raise ValueError("a mesh needs at least one shard")
    dev, devs = mesh_cards(device, devices)
    return Mesh(n_dev, dev, devices=devs)


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


@dataclass(frozen=True)
class ShardTable:
    """A table on a mesh of several cards: one Table per local shard, each
    on its shard's card, placed once at registration (`place_shards`), as
    `jax.device_put` with a `NamedSharding` places a global array's
    blocks. `columns` are shard 0's (types, dictionaries, which columns
    have a validity: every shard's are alike); `num_rows` counts the rows
    of every shard, on a mesh that spans processes every process's too.
    The plan compiler reads `schema`, `columns` and `num_rows` as it reads
    a Table's, and the distributed compiler probes min / max over every
    shard (`DistCompiler._column_range`)."""

    schema: Schema
    shards: tuple[Table, ...]
    num_rows: int

    @property
    def columns(self) -> tuple[Column, ...]:
        return self.shards[0].columns


def _local_shards(table, mesh: Mesh, *, whole: bool = False) -> list[Table]:
    """This process's shards of `table`, one Table per local shard: a
    ShardTable's own shards, the blocks a RankTable records, or a whole
    Table's row blocks `[first, first + n_local)` of `shard_bounds`
    (`whole`: also on a mesh that spans processes, where every process
    holds the whole table). The blocks are views of the table's tensors:
    nothing is copied."""
    if isinstance(table, ShardTable):
        return list(table.shards)
    if isinstance(table, RankTable):
        lo, spans = 0, []
        for r in table.shard_rows:
            spans.append((lo, lo + r))
            lo += r
    elif mesh.spans and not whole:
        raise ValueError("a mesh that spans processes partitions a RankTable, not a whole table")
    else:
        spans = shard_bounds(table.num_rows, mesh.n_dev)[mesh.first:mesh.first + mesh.n_local]
    shards = []
    for lo, hi in spans:
        cols = tuple(
            Column(c.dtype, c.data[lo:hi], None if c.validity is None else c.validity[lo:hi], c.dictionary)
            for c in table.columns
        )
        shards.append(Table(table.schema, cols, hi - lo))
    return shards


def place_shards(table, mesh: Mesh) -> ShardTable:
    """This process's shards of `table` (`_local_shards`: of a whole table,
    of a RankTable, or a ShardTable's again), each on its shard's card.
    On a mesh of one process a block already on its card stays a view and
    the others are copied there once; on a mesh that spans processes every
    block is copied, so neither the whole table nor this process's
    RankTable stays alive through a view."""
    shards = _local_shards(table, mesh, whole=True)
    if len(shards) != mesh.n_local:
        raise ValueError(f"{len(shards)} shards do not fill the mesh's {mesh.n_local} local shards")
    copy = mesh.spans

    def placed(t: Table, card: torch.device) -> Table:
        return Table(t.schema, tuple(
            Column(c.dtype, c.data.to(card, copy=copy),
                   None if c.validity is None else c.validity.to(card, copy=copy), c.dictionary)
            for c in t.columns), t.num_rows)

    return ShardTable(table.schema, tuple(placed(t, mesh.card_of(d)) for d, t in enumerate(shards)), table.num_rows)


def partition_table(table, mesh: Mesh) -> list[Table]:
    """This process's shards of a table, one Table per local shard
    (`_local_shards`). On a spanning mesh the table must be a RankTable
    or a ShardTable already, and on a mesh of several cards a ShardTable
    (ExecutionContext.register_table makes them)."""
    if mesh.n_cards > 1 and not isinstance(table, ShardTable):
        raise ValueError("a mesh of several cards partitions a ShardTable, not a whole table")
    return _local_shards(table, mesh)
