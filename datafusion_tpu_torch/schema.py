"""Schema / Field — the logical row type.

Mirrors the role of Arrow's Schema in the reference (used throughout
sqlplanner.rs / logicalplan.rs); ours is a plain immutable Python value.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Iterable, Optional

from datafusion_tpu_torch.errors import InvalidColumnError
from datafusion_tpu_torch.types import DataType


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self) -> str:
        return f"Field({self.name!r}, {self.dtype!r}, nullable={self.nullable})"


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...] = ()

    def __init__(self, fields: Iterable[Field] = ()):
        object.__setattr__(self, "fields", tuple(fields))

    @staticmethod
    def empty() -> "Schema":
        return Schema(())

    def __len__(self) -> int:
        return len(self.fields)

    def field(self, i: int) -> Field:
        return self.fields[i]

    def index_of(self, name: str) -> int:
        """Position of the column with `name` (first match, like the
        reference's `position()` lookup, sqlplanner.rs:225-233)."""
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise InvalidColumnError(
            f"Invalid identifier '{name}' for schema {self.to_string()}"
        )

    def maybe_index_of(self, name: str) -> Optional[int]:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        return None

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def to_string(self) -> str:
        return ", ".join(f"{f.name}: {f.dtype}" for f in self.fields)

    def __repr__(self) -> str:
        return f"Schema([{', '.join(repr(f) for f in self.fields)}])"

    def project(self, indices: Iterable[int]) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))

    def join(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)
