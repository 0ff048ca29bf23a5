"""Multi-key sort, top-k and limit.

Port of datafusion_tpu/ops/sort.py. torch has no multi-operand sort
like `lax.sort(operands, num_keys)`, so a lexicographic order is built
from stable `torch.sort` passes, last key first. Stability keeps equal
keys in original row order, the tie order the JAX package's stable sort
gives. Descending order uses order-reversing key transforms (negation
for floats, bitwise-not for ints), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.ops.expr_eval import ColVal, full


def _directed_key(
    data: torch.Tensor,
    valid: Optional[torch.Tensor],
    asc: bool,
    nulls_first: bool = False,
) -> list[torch.Tensor]:
    """One sort key as ascending sort operands. NULLs sort last
    (regardless of direction) by default; NULLS FIRST flips the
    null-order key."""
    keys = []
    if valid is not None:
        keys.append(valid.to(torch.int8) if nulls_first else torch.logical_not(valid).to(torch.int8))
    if data.dtype.is_floating_point:
        keys.append(data if asc else -data)
    elif data.dtype == torch.bool:
        d = data.to(torch.int8)
        keys.append(d if asc else 1 - d)
    else:
        keys.append(data if asc else torch.bitwise_not(data))
    return keys


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of rows by `keys` (first key most
    significant): one stable sort per key, last key first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_batch(
    keys: Sequence[tuple],
    cols: Sequence[ColVal],
    sel: torch.Tensor,
) -> list[ColVal]:
    """Sort the selected rows by `keys` — `((data, valid), asc[,
    nulls_first])` entries — and gather every column in that order.
    Returns the selected rows only, compacted."""
    n = sel.shape[0]
    rows = torch.nonzero(sel).squeeze(1)
    operands: list[torch.Tensor] = []
    for entry in keys:
        (data, valid), asc = entry[0], entry[1]
        nf = entry[2] if len(entry) > 2 else False
        data = full(data, n)[rows]
        valid = None if valid is None else full(valid, n)[rows]
        operands.extend(_directed_key(data, valid, asc, nf))
    perm = rows[lexsort(operands)] if operands else rows
    return [
        (full(d, n)[perm], None if v is None else full(v, n)[perm])
        for d, v in cols
    ]


def topk_indices(rank: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the `k` largest ranks, largest first, ties broken by
    the lowest index (the order `lax.top_k` gives): one top-k for the
    threshold, then a stable sort of at most k candidates."""
    k = min(k, rank.shape[0])
    if k == 0:
        return torch.zeros(0, dtype=torch.long, device=rank.device)
    thr = torch.topk(rank, k).values[-1]
    above = torch.nonzero(rank > thr).squeeze(1)
    at = torch.nonzero(rank == thr).squeeze(1)[: k - above.shape[0]]
    cand = torch.sort(torch.cat([above, at])).values
    order = torch.sort(rank[cand], descending=True, stable=True).indices
    return cand[order]


def limit_mask(sel: torch.Tensor, limit, offset: int = 0) -> torch.Tensor:
    """Keep selected rows with selected-rank in (offset, offset+limit]
    in current order (reference semantics: Limit over the projected
    stream; OFFSET is beyond the reference). limit=None caps nothing."""
    ranks = torch.cumsum(sel.to(torch.int64), 0)
    m = sel
    if limit is not None:
        m = torch.logical_and(m, ranks <= offset + limit)
    if offset:
        m = torch.logical_and(m, ranks > offset)
    return m
