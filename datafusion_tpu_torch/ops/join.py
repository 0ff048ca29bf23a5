"""Equi-joins: sort join, direct-index join, FULL OUTER tail.

Port of datafusion_tpu/ops/join.py. The JAX package computes a join into
a static output capacity and recompiles on overflow; here every shape
is computed eagerly, so the sort join is the JAX package's "expand"
strategy with exact sizes: one stable sort of the selected build keys,
a `searchsorted` range per probe row, and a `repeat_interleave` expand.
Its output rows come in probe order and, within one probe row, in
original build order: the order of both of the JAX package's sort-based
strategies (compact and expand).

Keys with a NULL never match: the callers pass each key's validity and
the rows with a NULL key leave the match (the JAX package reads key data
only, ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.ops.expr_eval import ColVal, full
from datafusion_tpu_torch.ops.pallas.segreduce import to_sortable_int
from datafusion_tpu_torch.ops.sort import lexsort


def _as_int(k: torch.Tensor) -> torch.Tensor:
    """A key column as integers with the same equalities: floats through
    their order-preserving image after `+ 0.0` (so -0.0 equals 0.0),
    bools as int8."""
    if k.dtype.is_floating_point:
        return to_sortable_int(k + 0.0)
    if k.dtype == torch.bool:
        return k.to(torch.int8)
    return k


def _combined_key_ids(probe_keys, build_keys) -> tuple[torch.Tensor, torch.Tensor]:
    """N-column keys -> one dense int64 id per row, equal tuples <=> equal
    ids: both sides' rows in one lexicographic order, distinct-tuple
    boundaries summed into ids, the ids scattered back to row order.
    Returns (probe ids, build ids)."""
    nb = build_keys[0].shape[0]
    cols = [torch.cat([b.to(torch.int64), p.to(torch.int64)]) for b, p in zip(build_keys, probe_keys)]
    n = cols[0].shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.int64, device=cols[0].device),) * 2
    order = lexsort(cols)
    boundary = torch.zeros(n, dtype=torch.bool, device=order.device)
    boundary[0] = True
    for c in cols:
        s = c[order]
        boundary[1:] |= s[1:] != s[:-1]
    ids = torch.empty(n, dtype=torch.int64, device=order.device)
    ids[order] = torch.cumsum(boundary.to(torch.int64), 0)
    return ids[nb:], ids[:nb]


def normalize_keys(probe_keys: Sequence[torch.Tensor], build_keys: Sequence[torch.Tensor]):
    """Join keys -> one integer key per side, in one dtype (searchsorted
    needs it). One key passes (floats through their int image); two keys
    of at most 32 bits pack into int64 `(a << 32) | (b & 0xFFFFFFFF)`, as
    the JAX package packs them under x64; wider pairs and three or more
    keys become dense tuple ids (`_combined_key_ids`), where packing would
    let different tuples collide."""
    pk, bk = [], []
    for p, b in zip(probe_keys, build_keys):
        if p.dtype.is_floating_point != b.dtype.is_floating_point or (
            p.dtype.is_floating_point and p.dtype != b.dtype
        ):
            p, b = p.to(torch.float64), b.to(torch.float64)  # one image for both sides
        pk.append(_as_int(p))
        bk.append(_as_int(b))
    if len(pk) == 1:
        p, b = pk[0], bk[0]
        if p.dtype != b.dtype:
            p, b = p.to(torch.int64), b.to(torch.int64)
        return p, b
    if len(pk) == 2 and all(k.element_size() <= 4 for k in pk + bk):
        def pack(a, b):
            return (a.to(torch.int64) << 32) | (b.to(torch.int64) & 0xFFFFFFFF)

        return pack(*pk), pack(*bk)
    return _combined_key_ids(pk, bk)


def _key_and_mask(keys: Sequence[ColVal], sel: torch.Tensor):
    """Key data and the rows that may match: selected, no NULL key."""
    n = sel.shape[0]
    datas, m = [], sel
    for d, v in keys:
        datas.append(full(d, n))
        if v is not None:
            m = m & full(v, n)
    return datas, m


def join_indices(
    probe_keys: Sequence[ColVal],
    probe_sel: torch.Tensor,
    build_keys: Sequence[ColVal],
    build_sel: torch.Tensor,
    *,
    keep_unmatched_probe: bool = False,
    want_build_matched: bool = False,
):
    """Gather indices of an equi-join. Returns (probe_idx, build_idx,
    matched) over the output rows, and with `want_build_matched` a fourth
    result: per original build row, whether a selected probe row matched
    it (the FULL OUTER / semi-join mark). `keep_unmatched_probe` gives
    LEFT OUTER semantics: a selected probe row without a match emits one
    row, `matched` False, whose build index is any valid row (0 when the
    build side is empty) for the caller to mask.

    Host reads: the output row count, for `repeat_interleave`, and the
    compaction of the selected build rows (`nonzero`)."""
    dev = probe_sel.device
    p_keys, p_ok = _key_and_mask(probe_keys, probe_sel)
    b_keys, b_ok = _key_and_mask(build_keys, build_sel)
    pkey, bkey = normalize_keys(p_keys, b_keys)
    b_rows = torch.nonzero(b_ok).squeeze(1)
    sorted_k, order = torch.sort(bkey[b_rows], stable=True)
    perm = b_rows[order]
    pkey = pkey.contiguous()
    start = torch.searchsorted(sorted_k, pkey)
    end = torch.searchsorted(sorted_k, pkey, right=True)
    match_counts = torch.where(p_ok, end - start, 0)
    if keep_unmatched_probe:
        counts = torch.where(probe_sel, match_counts.clamp(min=1), 0)
    else:
        counts = match_counts
    total = int(counts.sum())
    offsets = torch.cumsum(counts, 0) - counts
    probe_idx = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts, output_size=total)
    within = torch.arange(total, device=dev) - offsets[probe_idx]
    matched = within < match_counts[probe_idx]
    if perm.shape[0] == 0:
        build_idx = torch.zeros(total, dtype=torch.int64, device=dev)
    else:
        build_idx = perm[(start[probe_idx] + within).clamp(max=perm.shape[0] - 1)]
    if not want_build_matched:
        return probe_idx, build_idx, matched
    # each matched probe row covers its sorted run [start, end): a run is
    # hit where the running sum of run starts minus run ends is positive
    hit = match_counts > 0
    edge = torch.zeros(perm.shape[0] + 1, dtype=torch.int64, device=dev)
    edge.index_add_(0, start[hit], torch.ones_like(start[hit]))
    edge.index_add_(0, end[hit], -torch.ones_like(end[hit]))
    build_matched = torch.zeros(build_sel.shape[0], dtype=torch.bool, device=dev)
    build_matched[perm[torch.cumsum(edge, 0)[:-1] > 0]] = True
    return probe_idx, build_idx, matched, build_matched


def direct_index_join(
    probe_key: ColVal,
    probe_sel: torch.Tensor,
    build_key: ColVal,
    build_sel: torch.Tensor,
    build_cols: Sequence[ColVal],
    kmin: int,
    domain: int,
    matched_validity: bool = True,
):
    """Join on one key whose build values lie in [kmin, kmin + domain),
    known at plan time, when the selected build keys are unique: each
    selected build row's index goes into a `domain + 1` slot table (-1 in
    empty slots, the last slot for rows outside the domain), and each
    build column is gathered at the probe keys' slots. Probe rows stay in
    place: output row j is probe row j, with `matched` as its mask.

    Returns (out_build_cols, matched, dups): `dups` is the number of
    slots that more than one selected build row takes (one host read).
    When it is positive the keys are not unique, nothing is gathered,
    and the first two results are None: the caller takes another
    strategy. A build column's own validity is False where no row
    matched; `matched_validity` (LEFT joins) makes `matched` the validity
    of the columns without one, where an INNER join's selection carries it."""
    dev = probe_sel.device
    nb, npr = build_sel.shape[0], probe_sel.shape[0]
    (bk,), b_ok = _key_and_mask([build_key], build_sel)
    (pk,), p_ok = _key_and_mask([probe_key], probe_sel)
    slot = bk.to(torch.int64) - kmin
    b_ok = b_ok & (slot >= 0) & (slot < domain)
    rows = torch.nonzero(b_ok).squeeze(1)
    occupancy = torch.bincount(slot[rows], minlength=domain)
    dups = int((occupancy > 1).sum())
    if dups:
        return None, None, dups
    table = torch.full((domain + 1,), -1, dtype=torch.int64, device=dev)
    table[slot[rows]] = rows
    poff = pk.to(torch.int64) - kmin
    p_in = p_ok & (poff >= 0) & (poff < domain)
    bi = table[torch.where(p_in, poff, domain)]
    matched = bi >= 0
    idx = bi.clamp(min=0)
    out = []
    for d, v in gather_columns(build_cols, idx, nb, npr):
        if v is not None:
            v = v & matched
        elif matched_validity:
            v = matched
        out.append((d, v))
    return out, matched, 0


def gather_columns(cols: Sequence[ColVal], idx: torch.Tensor, n: int, n_out: Optional[int] = None) -> list[ColVal]:
    """Each `n`-row column gathered at `idx`. Over a side with no rows
    the result is zeros and NULL (every such row is masked)."""
    n_out = idx.shape[0] if n_out is None else n_out
    out = []
    for d, v in cols:
        d = full(d, n)
        if n == 0:
            out.append((torch.zeros(n_out, dtype=d.dtype, device=idx.device),
                        torch.zeros(n_out, dtype=torch.bool, device=idx.device)))
            continue
        out.append((d[idx], None if v is None else full(v, n)[idx]))
    return out


def full_merge_tail(
    pcols: Sequence[ColVal],
    bcols: Sequence[ColVal],
    matched: torch.Tensor,
    build_cols: Sequence[ColVal],
    un: torch.Tensor,
):
    """FULL OUTER: the unmatched build rows (mask `un`, original build
    order) appended after the LEFT-join head. Probe columns are NULL on
    the tail; build columns are NULL on the head's unmatched rows and
    keep their own validity on the tail. Returns (pcols, bcols, rows)."""
    rows = torch.nonzero(un).squeeze(1)
    n_tail = rows.shape[0]
    tail = gather_columns(build_cols, rows, un.shape[0])
    dev = matched.device
    out_p = []
    for d, v in pcols:
        head_v = torch.ones_like(matched) if v is None else v
        out_p.append((torch.cat([d, torch.zeros(n_tail, dtype=d.dtype, device=dev)]),
                      torch.cat([head_v, torch.zeros(n_tail, dtype=torch.bool, device=dev)])))
    out_b = []
    for (dh, vh), (dt, vt) in zip(bcols, tail):
        head_v = matched if vh is None else vh & matched
        tail_v = torch.ones(n_tail, dtype=torch.bool, device=dev) if vt is None else vt
        out_b.append((torch.cat([dh, dt]), torch.cat([head_v, tail_v])))
    return out_p, out_b, matched.shape[0] + n_tail
