"""Window functions: one stable spec sort per (PARTITION BY, ORDER BY).

Port of datafusion_tpu/ops/window.py, with the same contract: results
come back in original row order, values on unselected rows are
don't-care, and the output dtypes follow `physical_np` (Int64 ranks,
UInt64 counts carried in int64, f64 AVG, the argument's dtype for SUM,
MIN and MAX). The design is the card's, not the TPU's:

  * **The spec sort.** The keys (the unselected-last flag, then each
    PARTITION BY and ORDER BY key as its null flag and its data) become
    bit fields of ascending integer codes, packed greedily into as few
    integer keys of at most 63 bits as their widths allow (`sort_layout`):
    a key of known value range (dictionary codes, a scanned or bounded
    integer column) packs into the bits of that range,
    a narrow type into its width, a float into its order-preserving
    integer image (NaN last, -0.0 equal to 0.0, as the JAX sort orders
    them); a 64-bit key without a known range takes a pass of its own.
    One stable `torch.sort` per packed key, least significant first, each
    in the narrowest integer dtype that holds it, gives the order: ties
    keep row order, as the JAX row-id key does.
  * **Boundaries** compare each key's values in sorted order, as the JAX
    package compares its sort operands (a NaN key starts a new peer
    group), with the data under a NULL key zeroed: NULL keys form one
    partition and are peers, as in SQL (the JAX package splits them by
    the data stored under them). Partition and peer starts
    come from one cumsum and one compaction each (`_segments`).
  * **Results go back by scatter:** `out[perm] = res` (`scatter_`), O(n),
    where the JAX package sorts a second time by row id. An aggregate whose
    argument has no NULLs, over a window that holds the current row, is
    valid on every selected row: its validity is None, one scatter less.
  * **Sums are exact integer prefix sums** (the JAX package's f32 limb
    streams and its monotone pos/neg split were TPU workarounds), taken as
    differences of prefixes. One f64 prefix stream would lose the ulp of
    the global prefix at every row, and a float cumsum on the card adds in
    no fixed order (its scan combines blocks as they finish). So each
    float value becomes the fold tile's fixed-point digits
    (segreduce.fixed_digits: three int64 digits on the grid 2^(E-95) of
    the column's largest |value|), each digit stream's int64 cumsum is
    exact in any order, and the window's digit totals are rounded once to
    f64 (segreduce.fixed_decode): within L * 2^(E-96) plus half an ulp of
    the window's exact sum (L rows), the same bits on every run and
    device. NaN and +-inf are counted apart and restored, as in the JAX
    package.
  * **Whole-partition SUM / COUNT / AVG / MIN / MAX** (no ORDER BY, or
    the UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING frame) fold on kernel
    K2's sorted mode: in sorted space the partition ids are ascending, so
    one launch reduces every such call of a spec (sums without prefix
    cancellation), and each row reads its partition's value with one
    gather. K2's MIN/MAX reduce the order-preserving integer image, the
    grouped aggregate's NaN convention (MIN skips NaN unless all are,
    MAX reports it) that the JAX package reaches with a second spec sort
    per call.
  * **Running MIN / MAX** is a segmented doubling scan (Hillis-Steele) on
    the same integer image: log2 of the longest partition steps, each a
    few elementwise passes. torch has no segmented scan, and a cummax of
    a packed (partition, value) key has no bits left for the partition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.errors import NotImplementedError_
from datafusion_tpu_torch.ops.expr_eval import ColVal, full
from datafusion_tpu_torch.ops.pallas.segreduce import (
    fixed_decode,
    fixed_digits,
    from_sortable_int,
    segmented_reduce,
    to_sortable_int,
)
from datafusion_tpu_torch.ops.sort import pack_layout, packed_order

SHIFTS = {"lag", "lead"}
AGGS = {"sum", "count", "avg", "min", "max"}

# the bits of a key's code by data dtype, where no value range is known
_WIDTH = {torch.bool: 1, torch.int8: 8, torch.uint8: 8, torch.int16: 16, torch.int32: 32, torch.float32: 32}


@dataclass(frozen=True)
class WindowCall:
    """One window function instance within a shared spec."""

    kind: str
    arg: Optional[ColVal] = None  # None for row_number/rank/dense_rank/count(*)
    offset: int = 1  # lag/lead/ntile/nth_value
    # explicit ROWS frame (lo, hi) row offsets vs the current row; None
    # end = unbounded; frame=None = default (running with ORDER BY, whole
    # partition without)
    frame: Optional[tuple[Optional[int], Optional[int]]] = None


def whole_partition(call: WindowCall, has_order: bool) -> bool:
    """Does this aggregate call fold on K2 (one value per partition)?"""
    return call.kind in AGGS and (call.frame == (None, None) or (call.frame is None and not has_order))


# ---------------------------------------------------------------------------
# the spec sort
# ---------------------------------------------------------------------------


def key_width(dtype: torch.dtype, domain: Optional[tuple[int, int]]) -> Optional[int]:
    """Bits of one key's data code: its value range's where known, else its
    type's; None for a 64-bit key, which takes a sort pass of its own."""
    if dtype == torch.bool:
        return 1
    if domain is not None and not dtype.is_floating_point:
        return max(1, (domain[1] - domain[0]).bit_length())
    return _WIDTH.get(dtype)


def sort_layout(widths: Sequence[Optional[int]]) -> list[list[int]]:
    """Pack the spec's fields, most significant first, into sort keys: the
    unselected flag (1 bit), then per key its null flag (1 bit) and its
    data (`widths[i]` bits, None for a 64-bit pass). Returns the field
    indices of each key, greedily filled up to PACK_BITS (`pack_layout`)."""
    sizes = [1]
    for w in widths:
        sizes += [1, w]
    return pack_layout(sizes)


def _code(data: torch.Tensor, asc: bool, domain, width: Optional[int]) -> torch.Tensor:
    """Ascending int64 code of a key's data: in [0, 2^width) for a packed
    field, the raw order-preserving value for a 64-bit pass."""
    if data.dtype == torch.bool:
        d = data.to(torch.int64)
        return d if asc else 1 - d
    if data.dtype.is_floating_point:
        d = data if asc else -data
        # every NaN the canonical one: torch and XLA sort NaNs last
        d = torch.where(d.isnan(), torch.full((), float("nan"), dtype=d.dtype, device=d.device), d)
        img = to_sortable_int(d).to(torch.int64)
        return img if width is None else img + (1 << 31)
    d = data.to(torch.int64)
    if width is None:
        return d if asc else torch.bitwise_not(d)
    if domain is not None:
        lo, hi = domain
        return (d - lo if asc else hi - d).clamp(0, (1 << width) - 1)
    half = 0 if data.dtype == torch.uint8 else 1 << (width - 1)
    return d + half if asc else (1 << width) - 1 - (d + half)


def spec_order(sel: torch.Tensor, keys, domains) -> torch.Tensor:
    """The spec's row permutation: selected rows first, then by each key
    `(data, valid, asc, nulls_first)` (NULLs last unless nulls_first),
    ties in row order."""
    cap = sel.shape[0]
    widths = [key_width(d.dtype, dom) for (d, _, _, _), dom in zip(keys, domains)]
    fields = [(torch.logical_not(sel).to(torch.int64), 1)]
    for (data, valid, asc, nf), dom, w in zip(keys, domains, widths):
        if valid is None:
            flag = torch.zeros(cap, dtype=torch.int64, device=sel.device)
        else:
            flag = (valid if nf else torch.logical_not(valid)).to(torch.int64)
        fields += [(flag, 1), (_code(data, asc, dom, w), w)]
    return packed_order(fields)[0]


# ---------------------------------------------------------------------------
# sorted-space helpers
# ---------------------------------------------------------------------------


def _changed(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rows whose value differs from the previous row's in any of `vals`
    (NaN differs from NaN, as the JAX package's compare has it)."""
    ch = torch.zeros(vals[0].shape[0], dtype=torch.bool, device=vals[0].device)
    for a in vals:
        ch[1:] |= a[1:] != a[:-1]
    return ch


def _segments(starts_mask: torch.Tensor):
    """(segment id per row, start row per row, end row per row, segment
    count) of the segments that begin where `starts_mask` is set (row 0
    always is); one cumsum and one compaction."""
    cap = starts_mask.shape[0]
    seg = torch.cumsum(starts_mask, 0) - 1
    starts = torch.nonzero(starts_mask).squeeze(1)
    ends = torch.cat([starts[1:], torch.full((1,), cap, dtype=starts.dtype, device=starts.device)])
    return seg, starts[seg], ends[seg], starts.shape[0]


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] with idx clamped into the rows."""
    return x[idx.clamp(0, max(x.shape[0] - 1, 0))]


def _prefix_before(csum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix `csum` summed over rows [0, idx): exact, where
    `csum - x` would round."""
    return torch.where(idx > 0, _at(csum, idx - 1), torch.zeros((), dtype=csum.dtype, device=csum.device))


def _running_extreme(img: torch.Tensor, starts: torch.Tensor, maximum: bool, max_len: int) -> torch.Tensor:
    """Segmented inclusive running MIN / MAX of the integer image `img`
    (segments begin where `starts` is set): a doubling scan, where row i
    takes row i - d's value until a segment start lies in between."""
    ext = torch.maximum if maximum else torch.minimum
    vals, flags, d = img, starts, 1
    while d < max_len:
        nv = torch.where(flags[d:], vals[d:], ext(vals[d:], vals[:-d]))
        flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
        vals = torch.cat([vals[:d], nv])
        d *= 2
    return vals


# ---------------------------------------------------------------------------
# window_spec
# ---------------------------------------------------------------------------


def window_spec(
    part_keys: Sequence[ColVal],
    order_keys: Sequence[tuple],
    calls: Sequence[WindowCall],
    sel: torch.Tensor,
    domains: Optional[Sequence[Optional[tuple[int, int]]]] = None,
) -> list[ColVal]:
    """Evaluate `calls` sharing one (PARTITION BY, ORDER BY) spec.
    `order_keys` holds `((data, valid), asc[, nulls_first])` entries;
    `domains`, where given, an inclusive (lo, hi) range of every row's data
    per key (part keys, then order keys), or None. Returns one (data,
    valid) per call, in ORIGINAL row order; values on unselected rows are
    don't-care."""
    cap = int(sel.shape[0])
    dev = sel.device

    def key(cv, asc, nf):
        # the data under a NULL is zeroed: NULL keys are one partition and
        # peers, whatever a column stores under them
        d, v = full(cv[0], cap), None if cv[1] is None else full(cv[1], cap)
        return (d if v is None else torch.where(v, d, torch.zeros((), dtype=d.dtype, device=dev))), v, asc, nf

    keys = [key(cv, True, False) for cv in part_keys]
    keys += [key(e[0], e[1], e[2] if len(e) > 2 else False) for e in order_keys]
    domains = list(domains) if domains is not None else [None] * len(keys)
    perm = spec_order(sel, keys, domains)
    n_pk = len(part_keys)

    def key_vals(ks):
        out = []
        for d, v, _, _ in ks:
            out.append(d[perm])
            if v is not None:
                out.append(v[perm])
        return out

    iota = torch.arange(cap, device=dev)
    n_valid = sel.sum()
    sel_s = iota < n_valid
    pb = torch.logical_or(iota == 0, iota == n_valid)  # the first unselected row closes the last partition
    if n_pk:
        pb |= _changed(key_vals(keys[:n_pk]))
    seg, pstart, pend, n_seg = _segments(pb)
    pend_v = torch.minimum(pend, n_valid)  # a partition's end among the selected rows
    last = (pend_v - 1).clamp(0, max(cap - 1, 0))
    psize = (pend_v - pstart).clamp(min=1)
    has_order = len(order_keys) > 0
    peers = None

    def peer_bounds():
        nonlocal peers
        if peers is None:
            ob = pb | _changed(key_vals(keys[n_pk:])) if has_order else pb
            peers = _segments(ob)
        return peers

    args: dict[int, tuple] = {}

    def sorted_arg(c: WindowCall):
        """The call's argument in sorted order: (data, valid|None)."""
        d, v = c.arg
        if id(d) not in args:
            args[id(d)] = full(d, cap)[perm]
        ds = args[id(d)]
        if v is None:
            return ds, None
        if id(v) not in args:
            args[id(v)] = full(v, cap)[perm]
        return ds, args[id(v)]

    oks: dict = {}

    def ok_of(c: WindowCall) -> torch.Tensor:
        """The rows a call's aggregate counts: selected, argument valid."""
        vs = None if c.arg is None else sorted_arg(c)[1]
        if vs is None:
            return sel_s
        if id(vs) not in oks:
            oks[id(vs)] = sel_s & vs
        return oks[id(vs)]

    def all_valid(c: WindowCall) -> bool:
        """Is the aggregate valid on every selected row? Its argument has
        no NULLs and its window holds the current row (or the partition)."""
        lo, hi = c.frame if c.frame is not None else (None, None)
        return (c.arg is None or c.arg[1] is None) and (lo is None or lo <= 0) and (hi is None or hi >= 0)

    def frame_idx(c: WindowCall):
        lo_off, hi_off = c.frame
        lo = pstart if lo_off is None else torch.maximum(pstart, iota + lo_off)
        hi = last if hi_off is None else torch.minimum(last, iota + hi_off)
        return lo, hi, hi >= lo

    def windowed(csum: torch.Tensor, c: WindowCall) -> torch.Tensor:
        """The window's sum of the per-row values whose inclusive prefix
        is `csum`: running [pstart, i] or framed [lo, hi]."""
        if c.frame is not None:
            lo, hi, _ = frame_idx(c)
            return _at(csum, hi) - _prefix_before(csum, lo)
        return csum - _prefix_before(csum, pstart)

    # whole-partition aggregates: one K2 sorted fold for the spec
    k2_ops, k2_vals, k2_masks, k2_slot = [], [], [], {}

    def k2_add(op, val, mask) -> int:
        key = (op, None if val is None else id(val), id(mask))
        if key not in k2_slot:
            k2_slot[key] = len(k2_ops)
            k2_ops.append(op)
            k2_vals.append(val)
            k2_masks.append(mask)
        return k2_slot[key]

    def k2_value(a: torch.Tensor) -> torch.Tensor:
        # K2 takes f32/f64/i32/i64; narrower types reduce as i32
        return a if a.dtype in (torch.float32, torch.float64, torch.int32, torch.int64) else a.to(torch.int32)

    pending: list = []  # (out index, kind, slots, arg dtype) of whole-partition calls
    out_sorted: list = []
    for c in calls:
        kind = c.kind
        if whole_partition(c, has_order):
            ok = ok_of(c)
            cnt = k2_add("count", None, ok)
            slot = None
            dt = None
            if kind != "count":
                a, _ = sorted_arg(c)
                dt = a.dtype
                slot = k2_add("sum" if kind == "avg" else kind, k2_value(a), ok)
            pending.append((len(out_sorted), kind, cnt, slot, dt, all_valid(c)))
            out_sorted.append(None)
            continue
        if kind == "row_number":
            out_sorted.append((iota - pstart + 1, None))
        elif kind in ("rank", "percent_rank", "cume_dist", "dense_rank"):
            oseg, ostart, oend, _ = peer_bounds()
            if kind == "rank":
                out_sorted.append((ostart - pstart + 1, None))
            elif kind == "percent_rank":
                denom = (psize - 1).clamp(min=1).to(torch.float64)
                out_sorted.append(((ostart - pstart).to(torch.float64) / denom, None))
            elif kind == "cume_dist":
                out_sorted.append(((torch.minimum(oend, pend_v) - pstart).to(torch.float64)
                                   / psize.to(torch.float64), None))
            else:
                out_sorted.append((oseg - _at(oseg, pstart) + 1, None))
        elif kind == "ntile":
            nt = max(int(c.offset), 1)
            out_sorted.append((((iota - pstart) * nt) // psize + 1, None))
        elif kind == "nth_value":
            pos = pstart + (c.offset - 1)
            a, av = sorted_arg(c)
            v = pos < pend_v
            if av is not None:
                v = v & _at(av, pos)
            out_sorted.append((_at(a, pos), v))
        elif kind in SHIFTS:
            src = iota - (c.offset if kind == "lag" else -c.offset)
            inside = (src >= pstart) & (src < pend_v) if kind == "lead" else src >= pstart
            a, av = sorted_arg(c)
            out_sorted.append((_at(a, src), inside if av is None else inside & _at(av, src)))
        elif kind in ("first_value", "last_value"):
            # default: whole partition (the JAX package's documented
            # deviation from LAST_VALUE's standard frame); a ROWS frame
            # is honored exactly
            a, av = sorted_arg(c)
            if c.frame is not None:
                lo, hi, nonempty = frame_idx(c)
                pos = lo if kind == "first_value" else hi
                out_sorted.append((_at(a, pos), nonempty if av is None else nonempty & _at(av, pos)))
            else:
                pos = pstart if kind == "first_value" else last
                out_sorted.append((_at(a, pos), None if av is None else _at(av, pos)))
        elif kind in ("sum", "count", "avg"):
            ok = ok_of(c)
            w_cnt = windowed(torch.cumsum(ok, 0), c)
            nonempty = frame_idx(c)[2] if c.frame is not None else None
            if kind == "count":
                out_sorted.append((w_cnt if nonempty is None else torch.where(nonempty, w_cnt, 0), None))
                continue
            a, _ = sorted_arg(c)
            acc = torch.float64 if a.dtype.is_floating_point else torch.int64
            contrib = torch.where(ok, a.to(acc), torch.zeros((), dtype=acc, device=dev))
            if a.dtype.is_floating_point:
                finite = torch.isfinite(contrib)
                *digits, e = fixed_digits(torch.where(finite, contrib, 0.0))
                w_sum = fixed_decode(*(windowed(torch.cumsum(d, 0), c) for d in digits), torch.zeros_like(pstart), e)
                if not bool(finite.all()):
                    # IEEE restore from the non-finite values in the window
                    cls = torch.stack([contrib.isnan(), contrib == float("inf"), contrib == float("-inf")])
                    n_nan, n_pos, n_neg = (windowed(x, c) for x in torch.cumsum(cls.to(torch.int64), 1))
                    w_sum = torch.where(n_pos > 0, float("inf"), w_sum)
                    w_sum = torch.where(n_neg > 0, float("-inf"), w_sum)
                    w_sum = torch.where((n_nan > 0) | ((n_pos > 0) & (n_neg > 0)), float("nan"), w_sum)
            else:
                w_sum = windowed(torch.cumsum(contrib, 0), c)
            if kind == "avg":
                d = w_sum.to(torch.float64) / w_cnt.clamp(min=1)
            else:
                d = w_sum.to(a.dtype)
            v_out = None if all_valid(c) else w_cnt > 0 if nonempty is None else (w_cnt > 0) & nonempty
            out_sorted.append((d, v_out))
        elif kind in ("min", "max"):
            # running extreme (the planner admits only the running and
            # whole-partition frames for MIN / MAX)
            a, _ = sorted_arg(c)
            ok = ok_of(c)
            src = a.to(torch.int8) if a.dtype == torch.bool else a
            img = to_sortable_int(src)
            info = torch.iinfo(img.dtype)
            vals = torch.where(ok, img, info.max if kind == "min" else info.min)
            max_len = int((pend - pstart).max()) if cap else 0
            run = from_sortable_int(_running_extreme(vals, pb, kind == "max", max_len), src.dtype)
            out_sorted.append((run.to(a.dtype), None if all_valid(c) else windowed(torch.cumsum(ok, 0), c) > 0))
        else:
            raise NotImplementedError_(f"window function '{kind}' is not supported")

    if k2_ops:
        tables = segmented_reduce(seg.to(torch.int32), k2_vals, k2_masks, ops=k2_ops, num_groups=n_seg)
        for i, kind, cnt, slot, dt, valid in pending:
            n = tables[cnt][seg]
            if kind == "count":
                out_sorted[i] = (n, None)
            elif kind == "avg":
                out_sorted[i] = (tables[slot][seg].to(torch.float64) / n.clamp(min=1), None if valid else n > 0)
            else:
                out_sorted[i] = (tables[slot][seg].to(dt), None if valid else n > 0)

    # ---- scatter back to original row order ------------------------------
    def back(x):
        return None if x is None else torch.empty_like(x).scatter_(0, perm, x)

    return [(back(d), back(v)) for d, v in out_sorted]
