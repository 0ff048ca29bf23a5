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
from datafusion_tpu_torch.ops.pallas.segreduce import to_sortable_int


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


def sort_operands(data: torch.Tensor, valid: Optional[torch.Tensor], asc: bool, nulls_first: bool = False
                  ) -> list[torch.Tensor]:
    """One sort key as ascending integer operands (`_directed_key`).
    Floats compare on their order-preserving image, with every NaN made
    the canonical one after +inf, where torch.sort puts NaNs; -0.0 and
    0.0 share one image. Rows the sort ties tie here too."""
    out = []
    for o in _directed_key(data, valid, asc, nulls_first):
        if o.dtype.is_floating_point:
            o = to_sortable_int(torch.where(o.isnan(), torch.full((), float("nan"), dtype=o.dtype, device=o.device), o))
        out.append(o)
    return out


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of rows by `keys` (first key most
    significant): one stable sort per key, last key first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


PACK_BITS = 63  # a packed sort key stays a non-negative int64


def pack_layout(widths: Sequence[Optional[int]]) -> list[list[int]]:
    """Sort fields of `widths` bits, most significant first, greedily
    packed into keys of at most PACK_BITS bits; a field of width None (a
    64-bit code, or one whose width is not tracked) is a key of its own.
    Returns the field indices of each key."""
    groups, cur, bits = [], [], 0
    for f, w in enumerate(widths):
        if w is None:
            if cur:
                groups.append(cur)
            groups.append([f])
            cur, bits = [], 0
        elif bits + w > PACK_BITS:
            groups.append(cur)
            cur, bits = [f], w
        else:
            cur.append(f)
            bits += w
    if cur:
        groups.append(cur)
    return groups


def narrow_key(key: torch.Tensor, bits: int) -> torch.Tensor:
    """A packed key in the narrowest integer dtype that holds it: a radix
    sort's passes follow the key's width."""
    for dt, b in ((torch.int8, 7), (torch.int16, 15), (torch.int32, 31)):
        if bits <= b:
            return key.to(dt)
    return key


def packed_order(fields) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The stable order of rows by `fields`, most significant first, each
    (code, width): a code of known width is in [0, 2^width) and shares a
    key (`pack_layout`); one of width None is compared as it is. One
    stable `torch.sort` per key, least significant first, each key in the
    narrowest dtype that holds it. Returns (the permutation, the most
    significant key in sorted order, the bits below its first field, so
    that the first field is `top >> shift`)."""
    perm = top = None
    for group in reversed(pack_layout([w for _, w in fields])):
        code, w = fields[group[0]]
        if w is None:
            key, shift = code, 0
        else:
            key, bits = None, 0
            for f in reversed(group):
                c, wf = fields[f]
                c = c.to(torch.int64)
                key = c if key is None else key + (c << bits)
                bits += wf
            key, shift = narrow_key(key, bits), bits - w
        res = torch.sort(key if perm is None else key[perm], stable=True)
        perm = res.indices if perm is None else perm[res.indices]
        top = res.values
    return perm, top, shift


def sorted_rows(keys: Sequence[tuple], sel: torch.Tensor) -> torch.Tensor:
    """The indices of the selected rows in the order of `keys` —
    `((data, valid), asc[, nulls_first])` entries — ties in row order.
    Returns as many indices as rows are selected (one host read)."""
    n = sel.shape[0]
    rows = torch.nonzero(sel).squeeze(1)
    operands: list[torch.Tensor] = []
    for entry in keys:
        (data, valid), asc = entry[0], entry[1]
        nf = entry[2] if len(entry) > 2 else False
        data = full(data, n)[rows]
        valid = None if valid is None else full(valid, n)[rows]
        operands.extend(_directed_key(data, valid, asc, nf))
    return rows[lexsort(operands)] if operands else rows


def gather_rows(cols: Sequence[ColVal], idx: torch.Tensor, n: int) -> list[ColVal]:
    """Every column of an `n`-row batch at the row indices `idx`."""
    return [(full(d, n)[idx], None if v is None else full(v, n)[idx]) for d, v in cols]


def sort_batch(
    keys: Sequence[tuple],
    cols: Sequence[ColVal],
    sel: torch.Tensor,
) -> list[ColVal]:
    """Sort the selected rows by `keys` (`sorted_rows`) and gather every
    column in that order. Returns the selected rows only, compacted."""
    return gather_rows(cols, sorted_rows(keys, sel), sel.shape[0])


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
