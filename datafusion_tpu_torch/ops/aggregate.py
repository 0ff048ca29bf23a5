"""Grouped and ungrouped aggregation.

Port of datafusion_tpu/ops/aggregate.py. Per-group SUM / COUNT / MIN /
MAX run on kernel K2 (ops/pallas/segreduce.py) or K4
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

The rest of the aggregate family rides on the same reductions:

  * VAR / STDDEV (`_POP`, `_SAMP`) take two passes in f64: one reduce
    gives each group's sum and count, each row reads its group's mean
    (a gather by group id: near-sequential in sorted space, a table of at
    most 2,048 entries on the dense route), and one more reduce sums the
    squared deviations. The dense route keeps them (the JAX package sends
    them to the sorted path, because its dense kernel summed in f32)
  * MEDIAN / PERCENTILE[_CONT] / PERCENTILE_DISC [DESC] need the value
    order: the argument's not-valid flag and order-preserving image ride
    the co-sort after the group keys, so each group's valid values come
    first and ascending, and the result is read at `start + pos` with the
    group's valid count from K2; one such argument per aggregate, the
    JAX package's limit
  * COUNT / SUM / AVG(DISTINCT) sort each argument once more within its
    group (group id, not-valid flag, value image: one packed key where it
    fits in 63 bits), flag the first row of every run of equal values
    (NaN is one value, -0.0 and 0.0 one), and K2 counts and sums the
    flagged rows. The JAX package takes differences of one global prefix
    sum there, so a NaN or +-inf in one group spreads to every later
    group, and it counts every NaN as a value of its own; the port does
    neither

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
from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.errors import ExecutionError, NotImplementedError_
from datafusion_tpu_torch.ops.expr_eval import ColVal, full
from datafusion_tpu_torch.ops.pallas.partition import (
    SENTINEL,
    WINDOW,
    SlabFold,
    scale_pairs,
    slab_partition,
    windowed_reduce,
)
from datafusion_tpu_torch.ops.pallas.segreduce import (
    from_sortable_int,
    segmented_reduce,
    to_sortable_int,
)
from datafusion_tpu_torch.ops.sort import PACK_BITS, packed_order
from datafusion_tpu_torch.types import DataType, torch_dtype

DENSE_MAX_GROUPS = 2047  # domain + NULL slot within K2's 2048-slot dense mode
BIGDENSE_MAX_GROUPS = 8 * 2048 - 1  # eight K3 buckets of one K4 window each
PACKED_MAX_GROUPS = 1 << 26
VAR_FUNCS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
PCT_FUNCS = ("median", "percentile", "percentile_disc", "percentile_disc_desc")
DISTINCT_FUNCS = ("count_distinct", "sum_distinct", "avg_distinct")
DENSE_FUNCS = ("sum", "avg", "min", "max", "count") + VAR_FUNCS  # the sort-free routes' functions
HOLISTIC_FUNCS = VAR_FUNCS + PCT_FUNCS + DISTINCT_FUNCS  # a group's rows must meet in one place
FUNCS = DENSE_FUNCS + PCT_FUNCS + DISTINCT_FUNCS
PCT_LIMIT = ("only one distinct MEDIAN/PERCENTILE argument per aggregate is supported "
             "(it must ride the value sort)")


@dataclass(frozen=True)
class AggSpec:
    """One aggregate to compute: function name + argument column value."""

    func: str  # one of FUNCS
    arg: ColVal
    out_dtype: DataType
    q: float = 0.5  # the percentile fraction (MEDIAN: 0.5)


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


def _sort_code(x: torch.Tensor, canonical_nan: bool) -> tuple[torch.Tensor, Optional[int]]:
    """An int64 code of `x` in `x`'s order (floats on their order-preserving
    image: -0.0 equals 0.0, NaN after +inf), and its width in bits where it
    can share a packed sort key: the code is then in [0, 2^width). None for
    a 64-bit type, whose code is the raw signed image and takes a sort pass
    of its own. `canonical_nan` makes every NaN one value, as a DISTINCT
    needs; the percentile ride keeps the JAX package's image as it is."""
    if x.dtype == torch.bool:
        return x.to(torch.int64), 1
    if x.dtype.is_floating_point:
        if canonical_nan:
            x = torch.where(x.isnan(), torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)
        img = to_sortable_int(x)
        if img.dtype == torch.int64:
            return img, None
        return img.to(torch.int64) + (1 << 31), 32
    bits = {torch.uint8: 8, torch.int8: 8, torch.int16: 16, torch.int32: 32}.get(x.dtype)
    if bits is None:
        return x.to(torch.int64), None
    return x.to(torch.int64) + (0 if x.dtype == torch.uint8 else 1 << (bits - 1)), bits


def _from_code(code: torch.Tensor, bits: Optional[int], dtype: torch.dtype) -> torch.Tensor:
    """The value of a `_sort_code` code in `dtype` (-0.0 comes back as 0.0,
    NaN as the canonical NaN)."""
    if dtype == torch.bool:
        return code != 0
    if dtype.is_floating_point:
        img = code if bits is None else (code - (1 << 31)).to(torch.int32)
        return from_sortable_int(img, dtype)
    if bits is None or dtype == torch.uint8:
        return code.to(dtype)
    return (code - (1 << (bits - 1))).to(dtype)


def _percentile(func: str, q: float, cnt: torch.Tensor, read) -> torch.Tensor:
    """MEDIAN / PERCENTILE (CONT) / PERCENTILE_DISC [DESC] over `cnt`
    ascending valid values, read at positions by `read(pos)` (f64), with
    the JAX package's arithmetic: CONT interpolates `v_lo + (v_hi - v_lo)
    * (rank - lo)` at rank (n - 1) * q in f64, the multiply and the add
    fused into one rounding (`addcmul`), as XLA compiles it; DISC takes
    the ascending position ceil(q * n) - 1, and over a DESC ordering
    n - ceil(q * n) (not the q -> 1 - q flip, which is off by one on
    boundaries)."""
    f64 = torch.float64
    hi_pos = (cnt - 1).clamp(min=0)
    if func in ("percentile_disc", "percentile_disc_desc"):
        pos = torch.minimum(torch.ceil(cnt.to(f64) * q).to(torch.int64).clamp(min=1), cnt.clamp(min=1))
        pos = cnt - pos if func == "percentile_disc_desc" else pos - 1
        return read(torch.minimum(pos.clamp(min=0), hi_pos))
    rank = hi_pos.to(f64) * q
    lo = torch.floor(rank)
    v_lo = read(lo.to(torch.int64))
    v_hi = read(torch.ceil(rank).to(torch.int64))
    return torch.addcmul(v_lo, v_hi - v_lo, rank - lo)


def _var_finish(func: str, ss: torch.Tensor, cnt: torch.Tensor) -> ColVal:
    """VAR / STDDEV from the sum of squared deviations and the count:
    `_POP` divides by n (NULL at n = 0), `_SAMP` by n - 1 (NULL at n <= 1)."""
    if func.endswith("_pop"):
        r, ok = ss / cnt.clamp(min=1).to(ss.dtype), cnt > 0
    else:
        r, ok = ss / (cnt - 1).clamp(min=1).to(ss.dtype), cnt > 1
    return (torch.sqrt(r) if func.startswith("stddev") else r), ok


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
        f64 = torch.float64
        if spec.func == "count":
            outs.append((n.to(out_t), None))
            continue
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        if spec.func in DISTINCT_FUNCS:
            code, bits = _sort_code(data[mask], canonical_nan=True)
            distinct = torch.unique(code)
            cnt = torch.tensor(distinct.shape[0], device=data.device)
            if spec.func == "count_distinct":
                outs.append((cnt.to(out_t), None))
                continue
            vals = _from_code(distinct, bits, data.dtype)
            r = vals.to(f64 if vals.dtype.is_floating_point else torch.int64).sum()
            if spec.func == "avg_distinct":
                r = r.to(f64) / cnt.clamp(min=1).to(f64)
            outs.append((r.to(out_t), cnt > 0))
            continue
        if spec.func in VAR_FUNCS:
            # two passes: the mean, then the squared deviations from it
            mean = torch.where(mask, data, zero).sum() / n.clamp(min=1).to(data.dtype)
            dev = torch.where(mask, data - mean, zero)
            r, ok = _var_finish(spec.func, (dev * dev).sum(), n)
            outs.append((r.to(out_t), ok))
            continue
        if spec.func in PCT_FUNCS:
            img = torch.sort(to_sortable_int(data[mask])).values

            def read(pos, img=img, dtype=data.dtype):
                if img.shape[0] == 0:
                    return torch.zeros(pos.shape, dtype=f64, device=img.device)
                return from_sortable_int(img[pos], dtype).to(f64)

            r = _percentile(spec.func, spec.q, torch.tensor(img.shape[0], device=data.device), read)
            outs.append((r.to(out_t), n > 0))
            continue
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
            raise ExecutionError(f"unknown aggregate function {spec.func}")
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


def _op_list(specs, n_rows, row_of, exists_count, prepared=None):
    """The deduped op list of the grouped paths: one COUNT per distinct
    mask, one value stream per distinct argument. Returns (ops, values,
    masks, plan), `plan[s]` being spec s's (count slot, value slot).

    `row_of(t)` maps a per-row tensor into the order the group ids are in
    (a gather for the sorted path, identity for the dense ones).
    `exists_count` True adds a group-existence COUNT (dense slots: which
    slots exist). `prepared[s]` is a DISTINCT spec's (values, run-start
    flags), already in the group ids' order: its COUNT and SUM take the
    flags as their mask. A percentile needs only its argument's valid
    count; VAR / STDDEV the count and the sum of their first pass."""
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

    def slot(op, data, valid, mapped=False):
        key = (op, mapped, None if data is None else id(data), None if valid is None else id(valid))
        if key not in index:
            index[key] = len(ops)
            ops.append(op)
            if mapped:
                vals.append(None if data is None else _k2_value(data))
                masks.append(valid)
            else:
                vals.append(None if data is None else value(data))
                masks.append(mask(valid))
        return index[key]

    if exists_count:
        slot("count", None, None)
    plan = []
    for s, spec in enumerate(specs):
        data, valid = spec.arg
        f = spec.func
        if f in DISTINCT_FUNCS:
            d_vals, flags = prepared[s]
            cnt = slot("count", None, flags, mapped=True)
            val = None if f == "count_distinct" else slot("sum", d_vals, flags, mapped=True)
        elif f in PCT_FUNCS:
            cnt, val = slot("count", None, valid), None
        elif f in FUNCS:
            needs_cnt = f in ("count", "avg") + VAR_FUNCS or valid is not None
            cnt = slot("count", None, valid) if needs_cnt else None
            val = None if f == "count" else slot("sum" if f in ("avg",) + VAR_FUNCS else f, data, valid)
        else:
            raise ExecutionError(f"unknown aggregate function {f}")
        plan.append((cnt, val))
    return ops, vals, masks, plan


def _var_pass(specs, plan, outs, streams, num_groups):
    """The second pass of VAR / STDDEV: for each distinct (argument,
    validity), every row's squared deviation from its group's mean (the
    first pass's sum over its count, read by group id), for one more SUM.
    `streams` lists each input shard's first-pass (gid, values, masks);
    `outs` are the first pass's tables, which every shard's ids index.
    Returns (values per shard, masks per shard, second-pass slot per VAR
    spec)."""
    vals2, masks2 = [[] for _ in streams], [[] for _ in streams]
    index, slot_of = {}, {}
    for s, (spec, (cnt, val)) in enumerate(zip(specs, plan)):
        if spec.func not in VAR_FUNCS:
            continue
        if val not in index:
            index[val] = len(index)
            mean = outs[val] / outs[cnt].clamp(min=1).to(outs[val].dtype)
            for j, (gid, vals, masks) in enumerate(streams):
                dev = vals[val] - mean[gid.clamp(0, max(num_groups - 1, 0))]
                vals2[j].append((dev * dev).contiguous())
                masks2[j].append(masks[val])
        slot_of[s] = index[val]
    return vals2, masks2, slot_of


def _assemble(specs, plan, outs, done=None) -> list[ColVal]:
    """Each spec's (data, validity) from the reduced op tables; `done[s]`
    is a spec's result computed apart (VAR's second pass, percentiles)."""
    res = []
    for s, (spec, (cnt, val)) in enumerate(zip(specs, plan)):
        if done and s in done:
            res.append(done[s])
            continue
        out_t = torch_dtype(spec.out_dtype)
        if spec.func in ("count", "count_distinct"):
            res.append((outs[cnt].to(out_t), None))
            continue
        r = outs[val]
        data = spec.arg[0]
        if spec.func == "avg":
            # the JAX package divides the sum in the argument's dtype
            s_ = r.to(data.dtype)
            r = s_.to(_avg_dtype(s_)) / outs[cnt].clamp(min=1).to(_avg_dtype(s_))
        elif spec.func == "avg_distinct":
            r = r.to(torch.float64) / outs[cnt].clamp(min=1).to(torch.float64)
        elif spec.func in ("min", "max") and data.dtype == torch.bool:
            r = r != 0
        res.append((r.to(out_t), None if cnt is None else outs[cnt] > 0))
    return res


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
    gids = [st[1] for st in streams]
    tables = reduce(gids, [st[2][1] for st in streams], [st[2][2] for st in streams], ops=ops, num_groups=nslots)
    key_cols, specs = streams[0][0], shards[0][1]
    done = {}
    if any(spec.func in VAR_FUNCS for spec in specs):
        # every shard's ids must index one table: the fold's split tables
        # never meet VAR (the mesh sends it to the repartition aggregate)
        if len(tables) != 1:
            raise ExecutionError("VAR/STDDEV on the dense route needs one merged table")
        (outs,) = tables
        vals2, masks2, slot_of = _var_pass(specs, plan, outs, [(g, st[2][1], st[2][2]) for g, st in zip(gids, streams)],
                                           nslots)
        (outs2,) = reduce(gids, vals2, masks2, ops=["sum"] * len(vals2[0]), num_groups=nslots)
        done = {s: _var_finish(specs[s].func, outs2[k], outs[plan[s][0]]) for s, k in slot_of.items()}
        done = {s: (r.to(torch_dtype(specs[s].out_dtype)), ok) for s, (r, ok) in done.items()}
    out = []
    for d, outs in enumerate(tables):
        size = outs[0].shape[0]
        sg = torch.arange(size, device=outs[0].device) if slot_gid is None else slot_gid(d, size)
        exists = torch.nonzero((outs[0] > 0) & (sg < nslots)).squeeze(1)
        keys = _decode_keys(key_cols, sg[exists], doms, offs, radices, strides)
        aggs = [(a[exists], None if v is None else v[exists]) for a, v in _assemble(specs, plan, outs, done)]
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
    past num_groups), each distinct value is one K3 payload. K3 also
    leaves each float SUM's scale word (one per distinct value and mask)
    and its buckets' chunk counts, and K4 reduces the slab as K3 left it:
    the gid still packed, the masks its bits (`SlabFold`)."""
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
    col = {id(v): c for c, v in enumerate(payloads)}
    mask_bits = tuple(None if m is None else bits[id(m)] for m in masks)
    scales, scale_at = scale_pairs(ops, vals, [None if v is None else col[id(v)] for v in vals], mask_bits)
    *slab, info = slab_partition(packed.contiguous(), payloads, n_buckets=-(-gcap // WINDOW), id_mod=id_mod,
                                 scales=scales, num_groups=num_groups)
    moved = {id(v): s for v, s in zip(payloads, slab[1:])}
    return windowed_reduce(
        slab[0],
        [None if v is None else moved[id(v)] for v in vals],
        [None] * len(masks),
        ops=ops,
        num_groups=num_groups,
        slab=SlabFold(id_mod, mask_bits, info, len(scales), scale_at),
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


def _value_ride(specs):
    """The one MEDIAN / PERCENTILE argument of a grouped aggregate, which
    rides the co-sort; None without one. A second, different argument
    raises, as in the JAX package."""
    ride = None
    for spec in specs:
        if spec.func in PCT_FUNCS:
            if ride is None:
                ride = spec.arg
            elif spec.arg[0] is not ride[0]:
                raise NotImplementedError_(PCT_LIMIT)
    return ride


def _distinct_runs(data, valid, perm, gid, boundary, n_groups, with_values):
    """One DISTINCT argument in sorted space: a stable sort of each group's
    rows by (not-valid flag, value code), packed with the group id where
    they fit; the flag of every valid row that starts a run of equal codes
    (NaN one value, -0.0 and 0.0 one); and, for SUM / AVG, each row's value
    in that order (decoded from its code: no gather). The group ids stay
    ascending, so `gid` is theirs too."""
    m = perm.shape[0]
    x = data[perm]
    code, bits = _sort_code(x, canonical_nan=True)
    fields = [(gid, max(1, (n_groups - 1).bit_length()))]
    bad = None
    if valid is not None:
        bad = torch.logical_not(valid[perm])
        fields.append((bad.to(torch.int8), 1))
    fields.append((code, bits))
    perm2, top, _ = packed_order(fields)
    run = torch.ones(m, dtype=torch.bool, device=perm.device)
    if bits is not None and sum(w for _, w in fields) <= PACK_BITS:
        # one packed key: (gid, flag, code) change together
        low = top.to(torch.int64)
        run[1:] = low[1:] != low[:-1]
        code2 = low & ((1 << bits) - 1)
        if bad is not None:
            run &= ((low >> bits) & 1) == 0
    else:
        code2 = code[perm2]
        run[1:] = code2[1:] != code2[:-1]
        run |= boundary
        if bad is not None:
            run &= torch.logical_not(bad[perm2])
    return (_from_code(code2, bits, x.dtype) if with_values else None), run


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
    (the packed-gid path). A percentile argument rides the co-sort after
    the keys; DISTINCT arguments sort within their groups
    (`_distinct_runs`), packed as `packed_order` packs; every first-pass op folds in one K2 call, and
    VAR / STDDEV's squared deviations in one more. Returns (out_keys,
    out_aggs, n_groups)."""
    n = sel.shape[0]
    key_cols = [(full(d, n), None if v is None else full(v, n)) for d, v in key_cols]
    rows = torch.nonzero(sel).squeeze(1)
    ride = _value_ride(specs)
    if dense_domain is not None:
        gid_raw, doms, offs, radices, strides, nslots = dense_pack_gid(key_cols, dense_domain, dense_offset)
        head = [(gid_raw[rows], max(1, (nslots - 1).bit_length()))]
    else:
        head = []
        for kd, kv in key_cols:
            if kv is not None:
                head.append((torch.logical_not(kv[rows]).to(torch.int8), None))
            k = kd[rows]
            head.append((k.to(torch.int8) if k.dtype == torch.bool else to_sortable_int(k), None))
    fields = list(head)
    if ride is not None:
        vd, vv = ride
        if vv is not None:
            fields.append((torch.logical_not(full(vv, n)[rows]).to(torch.int8), 1))
        fields.append(_sort_code(full(vd, n)[rows], canonical_nan=False))
    order, top, shift = packed_order(fields)
    if dense_domain is not None:
        sorted_keys = [top >> shift if shift else top]
    else:
        sorted_keys = [t[order] for t, _ in head]
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
    prepared, runs = {}, {}
    for s, spec in enumerate(specs):
        if spec.func in DISTINCT_FUNCS:
            data, valid = spec.arg
            key = (id(data), None if valid is None else id(valid))
            if key not in runs:
                sums = any(o.func in ("sum_distinct", "avg_distinct") and o.arg[0] is data for o in specs)
                runs[key] = _distinct_runs(full(data, n), None if valid is None else full(valid, n), perm, gid,
                                           boundary, n_groups, sums)
            prepared[s] = runs[key]
    ops, vals, masks, plan = _op_list(specs, n, lambda t: t[perm], exists_count=False, prepared=prepared)
    outs = segmented_reduce(gid, vals, masks, ops=ops, num_groups=n_groups)
    done = {}
    if any(spec.func in VAR_FUNCS for spec in specs):
        (vals2,), (masks2,), slot_of = _var_pass(specs, plan, outs, [(gid, vals, masks)], n_groups)
        outs2 = segmented_reduce(gid, vals2, masks2, ops=["sum"] * len(vals2), num_groups=n_groups)
        for s, k in slot_of.items():
            r, ok = _var_finish(specs[s].func, outs2[k], outs[plan[s][0]])
            done[s] = (r.to(torch_dtype(specs[s].out_dtype)), ok)
    if ride is not None:
        vd = full(ride[0], n)

        def read(pos):
            # the ride put each group's valid values first, ascending
            at = perm[starts + pos]
            return from_sortable_int(to_sortable_int(vd[at]), vd.dtype).to(torch.float64)

        for s, spec in enumerate(specs):
            if spec.func in PCT_FUNCS:
                cnt = outs[plan[s][0]]
                r = _percentile(spec.func, spec.q, cnt, read)
                done[s] = (r.to(torch_dtype(spec.out_dtype)), cnt > 0)
    aggs = _assemble(specs, plan, outs, done)
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
