"""Collectives over a mesh's logical shards.

The single-controller counterparts of the `lax` collectives the JAX
package runs inside `shard_map` (datafusion_tpu/parallel/dist.py): each
takes the list of per-shard tensors, in shard order, and returns the one
tensor every shard would hold afterwards.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`lax.all_gather(..., tiled=True)`: the shards concatenated in order."""
    return torch.cat(list(xs))


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`lax.psum`, summed in shard order."""
    return functools.reduce(torch.add, xs)


def pmin(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`lax.pmin` (NaN propagates, as XLA's min does)."""
    return functools.reduce(torch.minimum, xs)


def pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`lax.pmax` (NaN propagates, as XLA's max does)."""
    return functools.reduce(torch.maximum, xs)


def size_matrix(counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The `[n_dev, n_dev]` int32 matrix of `all_gather`ed per-sender
    counts: row j is what shard j sends to each shard."""
    return torch.stack(list(counts)).to(torch.int32)
