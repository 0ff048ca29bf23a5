"""The generated tables in a form neither side owns: a column is plain
tensors with a type name and, for a string column, its sorted vocabulary
(the column holds the codes, order-preserving as the port's dictionaries
are). A column is made as row blocks, one per shard of the
configuration, each on its shard's card, so that no card holds more than
its own rows; a configuration without shards has one block. The harness
wraps the same tensors as the port's tables; the reference reads the
whole columns (`Tables.joined`) once the port is done with them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


def block_rows(n: int, blocks: int) -> list[int]:
    """Rows of each of `blocks` row blocks of `n` rows: ceil(n / blocks)
    each, the last ones short or empty."""
    b = -(-n // blocks)
    return [max(0, min(b, n - i * b)) for i in range(blocks)]


@dataclass
class Col:
    name: str
    kind: str  # "int32", "float32", "float64", "date" (int32 days since 1970-01-01) or "str" (int32 codes)
    blocks: tuple  # torch.Tensor per row block, in row order
    vocab: Optional[tuple[str, ...]] = None

    @property
    def data(self) -> torch.Tensor:
        """The whole column, where it is one block (`Tables.joined`)."""
        if len(self.blocks) != 1:
            raise ValueError(f"column {self.name} is {len(self.blocks)} blocks: join them first")
        return self.blocks[0]

    @property
    def itemsize(self) -> int:
        return self.blocks[0].element_size()


@dataclass
class Tab:
    name: str
    cols: list[Col] = field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(int(b.shape[0]) for b in self.cols[0].blocks)

    def __getitem__(self, name: str) -> Col:
        for c in self.cols:
            if c.name == name:
                return c
        raise KeyError(name)


@dataclass
class Tables:
    tabs: dict[str, Tab]

    def __getitem__(self, name: str) -> Tab:
        return self.tabs[name]

    def columns(self) -> dict[str, tuple[Tab, Col]]:
        """Every column by name, with its table (names are unique across
        a configuration's tables)."""
        return {c.name: (t, c) for t in self.tabs.values() for c in t.cols}

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for t in self.tabs.values() for c in t.cols for b in c.blocks)

    def joined(self, device) -> "Tables":
        """The same tables with each column's blocks joined into one on
        `device` (a copy where there are several blocks)."""
        def whole(c: Col) -> Col:
            if len(c.blocks) == 1:
                return c
            return Col(c.name, c.kind, (torch.cat([b.to(device) for b in c.blocks]),), c.vocab)

        return Tables({n: Tab(t.name, [whole(c) for c in t.cols]) for n, t in self.tabs.items()})


def days(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    import datetime

    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def iso(day: int) -> str:
    import datetime

    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(day))).isoformat()
