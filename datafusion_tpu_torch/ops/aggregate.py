"""Grouped and ungrouped aggregation.

Port of the main-path parts of datafusion_tpu/ops/aggregate.py. Per-group
SUM / COUNT / MIN / MAX run on kernel K2 (ops/pallas/segreduce.py) or K4
(ops/pallas/partition.py); AVG is SUM / COUNT. Three grouped paths,
chosen at plan time by the compiler:

  * dense (`grouped_aggregate_dense`): small probed key domains; the
    mixed-radix packed key IS the group id, so K2's dense mode reduces
    the unsorted rows with no sort at all
  * bigdense (`grouped_aggregate_bigdense`, opt-in): probed domains past
    K2's dense window, up to BIGDENSE_MAX_GROUPS slots; K3 partitions the
    rows bucket-major into slabs and K4 reduces them, with no sort
  * sorted (`grouped_aggregate`): a stable co-sort — by the packed id
    when the key domains are probed (packed-gid path), else by every key
    part (not-null flag + value, floats on their sortable image) — then
    K2's sorted mode over the compacted, ascending group ids

The sort is stable on purpose (datafusion_tpu/ops/aggregate.py:900-904):
within a group, rows keep their original order, so the CPU version's
float sums are the same row-order sums the JAX package computes. Groups
come out in ascending key order with NULL keys after the values.

Outputs are exactly `n_groups` long: torch runs eagerly, so the JAX
package's fixed group capacity and overflow retry have no counterpart.
The JAX package's f32 limb-prefix sums and `ieee_sum_cond` were TPU
workarounds: K2 sums in f64/i64 and follows IEEE for NaN and +-inf.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import torch

from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_
from datafusion_tpu_torch.ops.expr_eval import ColVal, full
from datafusion_tpu_torch.ops.pallas.partition import SENTINEL, WINDOW, slab_partition, windowed_reduce
from datafusion_tpu_torch.ops.pallas.segreduce import (
    from_sortable_int,
    segmented_reduce,
    to_sortable_int,
)
from datafusion_tpu_torch.ops.sort import lexsort
from datafusion_tpu_torch.types import DataType, torch_dtype

DENSE_MAX_GROUPS = 2047  # domain + NULL slot within K2's 2048-slot dense mode
BIGDENSE_MAX_GROUPS = 8 * 2048 - 1  # eight K3 buckets of one K4 window each
PACKED_MAX_GROUPS = 1 << 26
GROUPED_FUNCS = ("sum", "avg", "min", "max", "count")


@dataclass(frozen=True)
class AggSpec:
    """One aggregate to compute: function name + argument column value."""

    func: str  # min | max | sum | count | avg
    arg: ColVal
    out_dtype: DataType


def _sentinel(dtype: torch.dtype, minimum: bool):
    if dtype.is_floating_point:
        return float("-inf") if minimum else float("inf")
    if dtype == torch.bool:
        return not minimum
    info = torch.iinfo(dtype)
    return info.min if minimum else info.max


def _avg_dtype(t: torch.Tensor) -> torch.dtype:
    """Dtype of `sum / count` for an integer sum: the JAX package's true
    division promotes integers of up to 32 bits to f32, wider ones to
    f64."""
    if t.dtype.is_floating_point:
        return t.dtype
    return torch.float64 if t.dtype == torch.int64 else torch.float32


def ungrouped_aggregate(specs: Sequence[AggSpec], sel: torch.Tensor) -> list[ColVal]:
    """Whole-column reductions (reference: without_group_by,
    aggregate.rs:703-785). Returns a list of (0-d data, 0-d valid|None)."""
    n_rows = sel.shape[0]
    outs = []
    for spec in specs:
        data, valid = spec.arg
        data = full(data, n_rows)
        mask = sel if valid is None else torch.logical_and(sel, full(valid, n_rows))
        n = mask.sum()
        out_t = torch_dtype(spec.out_dtype)
        if spec.func == "count":
            outs.append((n.to(out_t), None))
            continue
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if spec.func == "min":
            r = torch.where(mask, data, _sentinel(data.dtype, False)).min() if n_rows else zero
        elif spec.func == "max":
            r = torch.where(mask, data, _sentinel(data.dtype, True)).max() if n_rows else zero
        elif spec.func == "sum":
            r = torch.where(mask, data, zero).sum()
        elif spec.func == "avg":
            s = torch.where(mask, data, zero).sum()
            r = s.to(_avg_dtype(s)) / n.to(_avg_dtype(s))
        else:
            raise NotImplementedError_(f"aggregate function {spec.func} is not part of the torch port yet")
        outs.append((r.to(out_t), n > 0))
    return outs


def dense_pack_gid(key_cols: Sequence[ColVal], domain_size, key_offset):
    """Mixed-radix pack of small-domain keys into a dense group id.
    Multiple keys pack major-to-minor (group order = key order); a
    nullable key gets an extra radix slot (NULL after its values).
    `key_offset[i]` shifts raw keys in [offset, offset+domain) onto
    [0, domain). Returns (gid int32, doms, offs, radices, strides,
    nslots)."""
    doms = [int(d) for d in domain_size]
    offs = [int(o) for o in key_offset]
    radices = [d + (1 if kv is not None else 0) for (kd, kv), d in zip(key_cols, doms)]
    nslots = 1
    for r in radices:
        nslots *= r
    strides = []
    acc = nslots
    for r in radices:
        acc //= r
        strides.append(acc)
    gid = None
    for (kd, kv), d, off, r in zip(key_cols, doms, offs, radices):
        code = (kd.to(torch.int64) - off).clamp(0, d - 1)
        if kv is not None:
            code = torch.where(kv, code, d)
        gid = code if gid is None else gid * r + code
    return gid.to(torch.int32), doms, offs, radices, strides, nslots


def _decode_keys(key_cols, slot_ids, doms, offs, radices, strides) -> list[ColVal]:
    """Each key back from packed slot ids; a key's code `d` is its NULL."""
    out = []
    for (kd, kv), d, off, r, stride in zip(key_cols, doms, offs, radices, strides):
        code = torch.div(slot_ids, stride, rounding_mode="floor") % r
        okd = (code.clamp(0, d - 1) + off).to(kd.dtype)
        out.append((okd, None if kv is None else code < d))
    return out


def _k2_value(data: torch.Tensor) -> torch.Tensor:
    """K2 takes f32/f64/i32/i64: narrower ints and bools widen to i32."""
    if data.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        return data.contiguous()
    return data.to(torch.int32)


def _op_list(specs, n_rows, row_of, exists_count):
    """The deduped op list of the grouped paths: one COUNT per distinct
    mask, one value stream per distinct argument. Returns (ops, values,
    masks, plan), `plan[s]` being spec s's (count slot, value slot).

    `row_of(t)` maps a per-row tensor into the order the group ids are in
    (a gather for the sorted path, identity for the dense ones).
    `exists_count` True adds a group-existence COUNT (dense slots: which
    slots exist)."""
    ops, vals, masks, index = [], [], [], {}
    values: dict = {}
    valids: dict = {}

    def value(data):
        if id(data) not in values:
            values[id(data)] = _k2_value(row_of(full(data, n_rows)))
        return values[id(data)]

    def mask(valid):
        if valid is None:
            return None
        if id(valid) not in valids:
            valids[id(valid)] = row_of(full(valid, n_rows)).contiguous()
        return valids[id(valid)]

    def slot(op, data, valid):
        key = (op, None if data is None else id(data), None if valid is None else id(valid))
        if key not in index:
            index[key] = len(ops)
            ops.append(op)
            vals.append(None if data is None else value(data))
            masks.append(mask(valid))
        return index[key]

    if exists_count:
        slot("count", None, None)
    plan = []
    for spec in specs:
        data, valid = spec.arg
        if spec.func not in GROUPED_FUNCS:
            raise NotImplementedError_(f"aggregate function {spec.func} is not part of the torch port yet")
        cnt = slot("count", None, valid) if (spec.func in ("count", "avg") or valid is not None) else None
        val = None if spec.func == "count" else slot("sum" if spec.func == "avg" else spec.func, data, valid)
        plan.append((cnt, val))
    return ops, vals, masks, plan


def _assemble(specs, plan, outs) -> list[ColVal]:
    """Each spec's (data, validity) from the reduced op tables."""
    res = []
    for spec, (cnt, val) in zip(specs, plan):
        out_t = torch_dtype(spec.out_dtype)
        if spec.func == "count":
            res.append((outs[cnt].to(out_t), None))
            continue
        r = outs[val]
        data = spec.arg[0]
        if spec.func == "avg":
            # the JAX package divides the sum in the argument's dtype
            s = r.to(data.dtype)
            r = s.to(_avg_dtype(s)) / outs[cnt].clamp(min=1).to(_avg_dtype(s))
        elif spec.func in ("min", "max") and data.dtype == torch.bool:
            r = r != 0
        res.append((r.to(out_t), None if cnt is None else outs[cnt] > 0))
    return res


def _reduce_specs(specs, gid, n_rows, num_groups, reduce, row_of, exists_count):
    """The op list (`_op_list`) reduced by `reduce` (K2's or K4's contract:
    `segmented_reduce`) once, and each spec's (data, validity)."""
    ops, vals, masks, plan = _op_list(specs, n_rows, row_of, exists_count)
    outs = reduce(gid, vals, masks, ops=ops, num_groups=num_groups)
    return outs, _assemble(specs, plan, outs)


def on_one_shard(reduce):
    """A per-device `reduce` as a mesh-wide one over a single shard."""
    return lambda gids, vals, masks, **kw: [reduce(gids[0], vals[0], masks[0], **kw)]


def _dense_window_aggregate(shards, domain_size, key_offset, reduce, slot_gid=None):
    """Sort-free GROUP BY over probed key domains (the port of
    dense_window_aggregate): the packed key is the group id, `reduce`
    reduces the unsorted rows into one slot per packed key, and the
    existing slots decode back into keys.

    `shards` lists each shard's (key_cols, specs, sel). `reduce(gids,
    vals, masks, ops=, num_groups=)` is mesh-wide: it takes each shard's
    op streams (ids in [0, nslots], nslots = unselected) and returns the
    tables of each output shard. `slot_gid(d, size)` maps output shard
    d's `size` slots to packed ids (default: slot s is id s); the
    distributed fold's shard d holds ids {w * n_dev + d}. Returns, per output shard,
    (out_keys, out_aggs, n_groups) over its existing groups."""
    streams = []
    for key_cols, specs, sel in shards:
        n = sel.shape[0]
        key_cols = [(full(d, n), None if v is None else full(v, n)) for d, v in key_cols]
        gid, doms, offs, radices, strides, nslots = dense_pack_gid(key_cols, domain_size, key_offset)
        # unselected rows route past the table and are dropped by the reduce
        gid = torch.where(sel, gid, torch.full((), nslots, dtype=torch.int32, device=gid.device)).contiguous()
        streams.append((key_cols, gid, _op_list(specs, n, lambda t: t, exists_count=True)))
    ops, plan = streams[0][2][0], streams[0][2][3]
    if any(st[2][0] != ops for st in streams):
        raise ExecutionError("shards built different op lists")
    tables = reduce([st[1] for st in streams], [st[2][1] for st in streams], [st[2][2] for st in streams],
                    ops=ops, num_groups=nslots)
    key_cols, specs = streams[0][0], shards[0][1]
    out = []
    for d, outs in enumerate(tables):
        size = outs[0].shape[0]
        sg = torch.arange(size, device=outs[0].device) if slot_gid is None else slot_gid(d, size)
        exists = torch.nonzero((outs[0] > 0) & (sg < nslots)).squeeze(1)
        keys = _decode_keys(key_cols, sg[exists], doms, offs, radices, strides)
        aggs = [(a[exists], None if v is None else v[exists]) for a, v in _assemble(specs, plan, outs)]
        out.append((keys, aggs, int(exists.shape[0])))
    return out


def grouped_aggregate_dense(
    key_cols: Sequence[ColVal],
    specs: Sequence[AggSpec],
    sel: torch.Tensor,
    domain_size,
    key_offset,
):
    """Sort-free GROUP BY for small probed key domains
    (`DENSE_MAX_GROUPS`): K2's dense mode reduces the unsorted rows."""
    reduce = on_one_shard(functools.partial(segmented_reduce, dense=True))
    return _dense_window_aggregate([(key_cols, specs, sel)], domain_size, key_offset, reduce)[0]


def slab_reduce(gid, vals, masks, *, ops, num_groups):
    """K2's reduce contract on K3 + K4: the rows' ids lie in
    [0, num_groups] (num_groups = unselected rows, dropped). Each distinct
    mask packs as one bit of the gid above `id_mod` (the next power of two
    past num_groups), each distinct value is one K3 payload; the slab's
    gid and mask bits unpack, and K4 reduces the slab."""
    gcap = num_groups + 1
    id_mod = 1 << num_groups.bit_length()
    packed = gid
    bits: dict = {}  # id(mask) -> bit
    for m in masks:
        if m is not None and id(m) not in bits:
            bits[id(m)] = num_groups.bit_length() + len(bits)
            packed = packed | (m.to(torch.int32) << bits[id(m)])
    if id_mod << len(bits) > SENTINEL:
        # the compiler's gate bounds the masks; reaching this is a bug
        raise ExecutionError(f"bigdense: {len(bits)} mask bits above {id_mod} reach SENTINEL")
    payloads = list({id(v): v for v in vals if v is not None}.values())
    slab = slab_partition(packed.contiguous(), payloads, n_buckets=-(-gcap // WINDOW), id_mod=id_mod)
    pg = slab[0]
    moved = {id(v): s for v, s in zip(payloads, slab[1:])}
    # gaps keep SENTINEL (dropped by K4); its bits below 23 are all 0
    gid_k = torch.where(pg >= SENTINEL, pg, pg & (id_mod - 1))
    unpacked = {b: ((pg >> b) & 1).bool() for b in bits.values()}
    return windowed_reduce(
        gid_k,
        [None if v is None else moved[id(v)] for v in vals],
        [None if m is None else unpacked[bits[id(m)]] for m in masks],
        ops=ops,
        num_groups=num_groups,
    )


def grouped_aggregate_bigdense(
    key_cols: Sequence[ColVal],
    specs: Sequence[AggSpec],
    sel: torch.Tensor,
    domain_size,
    key_offset,
):
    """Sort-free GROUP BY for probed key domains past K2's dense window
    (DENSE_MAX_GROUPS < slots <= BIGDENSE_MAX_GROUPS): K3 partitions the
    rows into slabs, one 2048-slot window per 256-row chunk, and K4
    reduces the slab (`slab_reduce`). The compiler's gate keeps the mask
    bits below SENTINEL and the op list within K4's shared memory."""
    return _dense_window_aggregate([(key_cols, specs, sel)], domain_size, key_offset, on_one_shard(slab_reduce))[0]


def grouped_aggregate(
    key_cols: Sequence[ColVal],
    specs: Sequence[AggSpec],
    sel: torch.Tensor,
    dense_domain=None,
    dense_offset=None,
):
    """GROUP BY through a stable co-sort and K2's sorted mode. With
    probed key domains (`dense_domain`/`dense_offset`) the keys pack into
    one id that is the single sort key and decodes back arithmetically
    (the packed-gid path). Returns (out_keys, out_aggs, n_groups)."""
    n = sel.shape[0]
    key_cols = [(full(d, n), None if v is None else full(v, n)) for d, v in key_cols]
    rows = torch.nonzero(sel).squeeze(1)
    if dense_domain is not None:
        gid_raw, doms, offs, radices, strides, _ = dense_pack_gid(key_cols, dense_domain, dense_offset)
        packed = gid_raw[rows]
        order = torch.sort(packed, stable=True).indices
        sorted_keys = [packed[order]]
    else:
        parts = []
        for kd, kv in key_cols:
            if kv is not None:
                parts.append(torch.logical_not(kv[rows]).to(torch.int8))
            k = kd[rows]
            parts.append(k.to(torch.int8) if k.dtype == torch.bool else to_sortable_int(k))
        order = lexsort(parts) if rows.shape[0] else rows
        sorted_keys = [p[order] for p in parts]
    perm = rows[order]
    m = perm.shape[0]
    boundary = torch.zeros(m, dtype=torch.bool, device=sel.device)
    if m:
        boundary[0] = True
        for sk in sorted_keys:
            boundary[1:] |= sk[1:] != sk[:-1]
    gid = (torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1).contiguous()
    starts = torch.nonzero(boundary).squeeze(1)
    n_groups = int(starts.shape[0])
    _, aggs = _reduce_specs(specs, gid, n, n_groups, segmented_reduce, lambda t: t[perm], exists_count=False)
    if dense_domain is not None:
        keys = _decode_keys(key_cols, sorted_keys[0][starts].to(torch.int64), doms, offs, radices, strides)
    else:
        keys = []
        for kd, kv in key_cols:
            at = perm[starts]
            # float keys group on their sortable image (-0.0 joins 0.0)
            kdata = from_sortable_int(to_sortable_int(kd[at]), kd.dtype)
            keys.append((kdata, None if kv is None else kv[at]))
    return keys, aggs, n_groups
