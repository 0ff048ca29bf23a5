"""Distributed plan compiler: a query over the logical shards of a mesh.

Port of datafusion_tpu/parallel/dist.py for the main path. The JAX
package traces the whole query into one `shard_map` over a mesh of chips;
here one controller runs each stage over the list of shards
(parallel/mesh.py), and a distributed stage maps the shards' envs to a
ShardedBatch (exec/compiler.py):

  * scan / filter / project run once per shard over its row block, with
    the single-card lowering (K1 per shard)
  * GROUP BY, in the JAX package's order: dense per shard (K2 dense) and
    a psum / pmin / pmax merge; the fused exchange + fold (K6); or partial
    aggregates per shard and a merge of their all_gather; ungrouped
    aggregates merge their per-shard scalars. Holistic aggregates
    (DISTINCT, MEDIAN / percentiles, VAR / STDDEV) hash-repartition the
    rows by the group keys through K5 and aggregate per shard, or, without
    GROUP BY, gather the rows and aggregate once
  * ORDER BY: a sample sort whose range exchange is K5
    (parallel/shuffle.py); ORDER BY ... LIMIT k where k fits a shard
    (`topk_fits`): per-shard top-k and a top-k of the gathered candidates
  * LIMIT: global row ranks from the per-shard counts
  * joins: the build side broadcast (all_gather) to every shard, or both
    sides hash-repartitioned by key through K5 (`_lower_join`)
  * windows: rows hash-repartitioned by the PARTITION BY keys through K5,
    or gathered to every shard (`_lower_window`); UNION ALL per shard, or
    over gathered inputs where the children's layouts differ

Routing is decided by the plan alone; the JAX package's DFTPU_* routing
options are not read. Its exchange:fold cost estimate was a TPU v5e
ICI-to-HBM proxy, and one card has no ICI, so the fold's gate is what K6
takes: probed key domains of at most 2048 slots per shard and an op list
within K6's shared memory, decided at plan time.

A stage over a local child (a lowering of the base compiler, one env to
one Batch) stays local until a distributed stage needs its shards; a
stage over a distributed child runs once per shard, and once in all for
a replicated child.

On a mesh of several cards (parallel/mesh.py `make_mesh(devices=...)`)
each shard's stages run on its card. Every per-shard stage is lowered
once per card (`_on_cards`): its compiled expressions, constants,
lookup tables and K1 programs live on that card, as XLA places a
`shard_map` body's constants on every chip, and shard d runs card
`mesh.card_index(d)`'s lowering over its rows. What a stage makes from
every shard (sample-sort splitters, the broadcast join's build side, the
global row ranks, a FULL join's matched marks) is made on the mesh's
first card, where the collectives meet, and copied to each card once
(`_copies`, collectives.to_card). Replicated results stay on the first
card.

On a mesh that spans processes (parallel/multihost.py) each process runs
every stage over its own shards, and a ShardedBatch holds those. The
collectives take the mesh and meet in global shard order, the exchanges
cross the processes (parallel/shuffle.py), and a replicated batch holds
the same rows on every process. A process may hold several cards of such
a mesh: its shards then run on their cards as above, and what a stage
builds from every shard of every process is made on its first card.
Every host read that chooses a route reads a value all processes agree
on: the domain probes take min / max over every process's rows
(`_column_range`), the join ladder's count of repeated build keys is the
largest any process saw (`_agreed`), and the shuffle's skew salt and
region capacity come from the mesh's whole count matrix. So every
process takes the same route and enters the same collectives.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional

import torch

from datafusion_tpu_torch.exec.compiler import (
    Batch,
    CompiledQuery,
    Lowered,
    PlanCompiler,
    ShardedBatch,
    split_host_projection,
    topk_fits,
)
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.ops import aggregate as agg_ops
from datafusion_tpu_torch.ops import join as join_ops
from datafusion_tpu_torch.ops import sort as sort_ops
from datafusion_tpu_torch.ops.expr_eval import broadcast_col
from datafusion_tpu_torch.ops.pallas.partition import MAX_OPS, WINDOW
from datafusion_tpu_torch.ops.pallas.segreduce import from_sortable_int, segmented_reduce, to_sortable_int
from datafusion_tpu_torch.parallel import collectives as C
from datafusion_tpu_torch.parallel.mesh import Mesh, ShardTable
from datafusion_tpu_torch.parallel.shuffle import exchange_fold, hash_keys_to_device, repartition, route, skew_salt
from datafusion_tpu_torch.plan import logical as L
from datafusion_tpu_torch.types import DataType, torch_dtype
from datafusion_tpu_torch.utils.trace import spanned

OVERSAMPLE = 16  # sample-sort samples per shard


def _merge_dense(op: str, tables: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard K2 dense tables into the mesh's: sums and counts add;
    MIN / MAX combine on the order-preserving image, as K2 reduces."""
    if op in ("sum", "count"):
        return C.psum(tables, mesh)
    img = [to_sortable_int(t) for t in tables]
    return from_sortable_int(C.pmin(img, mesh) if op == "min" else C.pmax(img, mesh), tables[0].dtype)


def _float_partial(rt: DataType) -> DataType:
    """Partial-sum type for AVG: accumulate in the argument's float width."""
    return rt if rt.is_float else DataType.Float64


class DistCompiler(PlanCompiler):
    """Lowers plans to stages over the shards of `mesh`."""

    def __init__(self, tables, mesh: Mesh, fn_registry=None):
        super().__init__(tables, fn_registry, mesh.device)
        self.mesh = mesh
        self.n_dev = mesh.n_dev  # shards of the mesh
        self.n_local = mesh.n_local  # shards of this process
        self._card = 0  # the logical card being lowered for (`_on_cards`)
        self._local_plans: dict = {}  # id(local Lowered) -> (plan, first scan slot, the Lowered)

    # -- cards -------------------------------------------------------------
    def lower(self, plan: L.LogicalPlan) -> Lowered:
        """`plan` lowered for the mesh. A distributed stage runs inside its
        span; a local one runs once per shard, so its span is recorded
        where the shards run it, once over all of them (`_as_dist`)."""
        mark = len(self.scan_tables)
        low = self._named(plan)
        if low.layout is not None:
            return replace(low, fn=spanned(low.span)(low.fn))
        if self.mesh.n_cards > 1 and self._card == 0:
            self._local_plans[id(low)] = (plan, mark, low)  # `_as_dist` lowers it again for each card
        return low

    def _on_cards(self, build, first=None, scan_mark: Optional[int] = None) -> list:
        """`build()` once per logical card of the mesh, with that card as
        the compiler's device: entry c runs on card c's shards. Entry 0 is
        `first` where given, else the first card's build, whose notes and
        declines stay; the other cards' builds leave the notes and the
        scan slots as they were (a local plan lowered again from
        `scan_mark` takes the same slots)."""
        if self._card != 0:
            raise ExecutionError("a per-card lowering nested in another")
        out = [build() if first is None else first]
        for c in range(1, self.mesh.n_cards):
            saved = (list(self.notes), list(self.sticky_notes), list(self.scan_tables), list(self.scan_used))
            self.device, self._card = self.mesh.devices[c], c
            if scan_mark is not None:
                del self.scan_tables[scan_mark:]
                del self.scan_used[scan_mark:]
            try:
                out.append(build())
            finally:
                self.device, self._card = self.mesh.device, 0
                self.notes[:], self.sticky_notes[:], self.scan_tables[:], self.scan_used[:] = saved
        return out

    def _local_on_cards(self, low: Lowered) -> list:
        """A local lowering (layout None) for each card: `low` on the first,
        its plan lowered again on the others."""
        if self.mesh.n_cards == 1:
            return [low]
        if id(low) not in self._local_plans:
            raise ExecutionError("a local stage reached the mesh without its plan")
        plan, mark, _ = self._local_plans[id(low)]
        return self._on_cards(lambda: self.lower(plan), first=low, scan_mark=mark)

    def _copies(self, ts) -> list:
        """Tensors made on the mesh's first card, on each local shard's
        card: entry d for shard d, one copy per card (collectives.to_card;
        None stays None)."""
        by: dict = {}
        out = []
        for d in range(self.n_local):
            dev = self.mesh.card_of(d)
            if dev not in by:
                by[dev] = [None if t is None else C.to_card(t, dev) for t in ts]
            out.append(by[dev])
        return out

    def _batch_copies(self, b: Batch) -> list:
        """A Batch on the first card (a replicated side), on each local
        shard's card."""
        flat = [b.sel] + [x for d, v in b.cols for x in (d, v)]
        return [Batch([(c[1 + 2 * j], c[2 + 2 * j]) for j in range(len(b.cols))], c[0]) for c in self._copies(flat)]

    def _column_range(self, tbl, ci: int) -> tuple[int, int]:
        """min and max of a scanned column over its shards' rows (a
        ShardTable's on their cards) and, on a mesh that spans processes,
        over every process's: one all_gather of each process's pair, in
        which a process without rows sends the identities."""
        datas = [t.columns[ci].data for t in tbl.shards] if isinstance(tbl, ShardTable) else [tbl.columns[ci].data]
        datas = [d for d in datas if d.numel()]
        if not self.mesh.spans:
            pairs = [(int(d.min()), int(d.max())) for d in datas]
            return min(a for a, _ in pairs), max(b for _, b in pairs)
        i64 = torch.iinfo(torch.int64)
        pair = torch.tensor([i64.max, i64.min], dtype=torch.int64, device=self.mesh.device)
        for d in datas:
            lo, hi = C.to_card(torch.stack([d.min().to(torch.int64), d.max().to(torch.int64)]), self.mesh.device)
            pair = torch.stack([torch.minimum(pair[0], lo), torch.maximum(pair[1], hi)])
        every = C.all_gather([pair], self.mesh).reshape(-1, 2)
        return int(every[:, 0].min()), int(every[:, 1].max())

    def _agreed(self, value: int) -> int:
        return C.agreed_max(value, self.mesh)

    # -- helpers --------------------------------------------------------
    def _as_dist(self, low: Lowered) -> Lowered:
        """A local lowering run once per shard, over its row block, on its
        card, inside the local node's span (one for every shard)."""
        if low.layout is not None:
            return low
        lows, card = self._local_on_cards(low), self.mesh.card_index

        def fn(envs) -> ShardedBatch:
            return ShardedBatch([lows[card(d)].fn(env) for d, env in enumerate(envs)], "partitioned")

        if low.span:  # a node's local stage; one made inside a lowering runs inside its node's span
            fn = spanned(low.span)(fn)
        return Lowered(low.schema, low.dicts, fn, low.sources, "partitioned", low.capacity, low.bounds)

    def _map(self, child: Lowered, locals_: list) -> Lowered:
        """`locals_[c]` (lowered for card c over a stand-in for `child`'s
        shards) run on each shard of `child`; on a replicated child, once,
        on the first card."""
        layout, card, local = child.layout, self.mesh.card_index, locals_[0]

        def fn(envs) -> ShardedBatch:
            sb = child.fn(envs)
            if layout == "replicated":
                return ShardedBatch([local.fn(sb.shards[0])] * len(sb.shards), layout)
            return ShardedBatch([locals_[card(d)].fn(b) for d, b in enumerate(sb.shards)], layout)

        return Lowered(local.schema, local.dicts, fn, local.sources, layout, local.capacity, local.bounds,
                       route=local.route)

    def _per_shard(self, child: Lowered, build) -> Optional[Lowered]:
        """`build(c)` lowers a single-card stage over `c`: over a local
        child it stays local, over a distributed one it runs per shard,
        lowered for each card (once, for the first card, over a replicated
        child)."""
        if child.layout is None:
            return build(child)
        standin = Lowered(child.schema, child.dicts, lambda b: b, child.sources, None, child.capacity, child.bounds)
        locals_ = [build(standin)] if child.layout == "replicated" else self._on_cards(lambda: build(standin))
        return None if locals_[0] is None else self._map(child, locals_)

    def _gather_batch(self, child: Lowered) -> Lowered:
        """Partitioned -> replicated: every shard holds the concatenation
        of all shards' rows (all_gather)."""
        if child.layout == "replicated":
            return child
        child = self._as_dist(child)
        n, mesh = self.n_local, self.mesh

        def fn(envs) -> ShardedBatch:
            return ShardedBatch([child.fn(envs).merged(mesh)] * n, "replicated")

        return Lowered(child.schema, child.dicts, fn, None, "replicated", child.capacity)

    # -- local stages ----------------------------------------------------
    def _lower_empty(self, plan: L.EmptyRelation) -> Lowered:
        local, n = super()._lower_empty(plan), self.n_local
        return Lowered(local.schema, local.dicts, lambda envs: ShardedBatch([local.fn(None)] * n, "replicated"),
                       None, "replicated", local.capacity)

    def _lower_selection(self, plan: L.Selection) -> Lowered:
        return self._per_shard(self.lower(plan.input), lambda c: self._selection_over(plan, c))

    def _lower_projection(self, plan: L.Projection) -> Lowered:
        fused = self._speculative(lambda: self._try_fused_stage(plan))  # K1, once per shard
        if fused is not None:
            return fused
        return self._per_shard(self.lower(plan.input), lambda c: self._projection_over(plan, c))

    # -- sort --------------------------------------------------------------
    def _lower_sort(self, plan: L.Sort) -> Lowered:
        child = self.lower(plan.input)
        if child.layout == "replicated":
            return self._per_shard(child, lambda c: self._sort_over(plan, c))
        return self._sort_sample(plan, self._as_dist(child))

    def _sort_sample(self, plan: L.Sort, child: Lowered) -> Lowered:
        """Sample sort: each shard sorts its rows; OVERSAMPLE key tuples per
        shard are gathered and sorted, and n_dev - 1 of them split the key
        range; K5 moves every row to its range's shard (equal keys to one
        shard), which sorts what it received. The shards in order are
        then the sorted result. Rows arrive sender by sender and every sort
        is stable, so ties keep the global row order, as on one card."""
        n = self.n_dev
        if len(plan.exprs) == 1:
            self.notes.append("sort: distributed sample sort (splitter all_gather + range exchange over K5 + local sorts)")
        else:
            self.notes.append(
                "sort: distributed multi-key sample sort (tuple splitters, lexicographic range routing, "
                "range exchange over K5)"
            )
        keys = self._on_cards(lambda: [(self.compile(se.expr, child), se.asc, se.nulls_first is True)
                                       for se in plan.exprs])
        n_cols, card = len(child.schema), self.mesh.card_index

        def fn(envs) -> ShardedBatch:
            local = []
            for d, b in enumerate(child.fn(envs).shards):
                ops = []
                for kc, asc, nf in keys[card(d)]:
                    kd, kv = broadcast_col(kc.fn(b.cols), b.capacity)
                    ops.extend(sort_ops.sort_operands(kd, kv, asc, nf))
                cols = sort_ops.sort_batch([((o, None), True) for o in ops], list(b.cols) + [(o, None) for o in ops],
                                           b.sel)
                local.append(cols)
            m = len(local[0]) - n_cols
            samples = [[] for _ in range(m)]
            for cols in local:
                n_sel = cols[0][0].shape[0]
                pos = (torch.arange(OVERSAMPLE, device=cols[0][0].device) + 1) * max(n_sel, 1) // (OVERSAMPLE + 1)
                for t in range(m):
                    o = cols[n_cols + t][0]
                    # an empty shard samples the largest tuple
                    samples[t].append(o[pos] if n_sel else torch.full((OVERSAMPLE,), torch.iinfo(o.dtype).max,
                                                                      dtype=o.dtype, device=o.device))
            gathered = [C.all_gather(s, self.mesh) for s in samples]  # on the first card
            order = sort_ops.lexsort(gathered)
            ranks = (torch.arange(1, n, device=gathered[0].device) * (n * OVERSAMPLE)) // n
            splitters = self._copies([g[order][ranks] for g in gathered])
            dsts = []
            for d, cols in enumerate(local):
                ops = [c[0] for c in cols[n_cols:]]
                dst = torch.zeros(ops[0].shape[0], dtype=torch.int64, device=ops[0].device)
                for j in range(n - 1):
                    # splitter tuple j <= the row's tuple (lexicographic):
                    # equal tuples go right, so equal keys share a shard
                    less = torch.zeros_like(dst, dtype=torch.bool)
                    eq = torch.ones_like(dst, dtype=torch.bool)
                    for t in range(m):
                        less |= eq & (splitters[d][t][j] < ops[t])
                        eq &= splitters[d][t][j] == ops[t]
                    dst += less | eq
                dsts.append(dst)
            sels = [torch.ones(c[0][0].shape[0], dtype=torch.bool, device=c[0][0].device) for c in local]
            recv, recv_sel = repartition(local, dsts, sels, n, mesh=self.mesh)
            out = []
            for cols, sel in zip(recv, recv_sel):
                res = sort_ops.sort_batch([(cv, True) for cv in cols[n_cols:]], cols[:n_cols], sel)
                out.append(Batch(res, torch.ones(res[0][0].shape[0], dtype=torch.bool, device=sel.device)))
            return ShardedBatch(out, "partitioned")

        return Lowered(child.schema, child.dicts, fn, None, "partitioned", child.capacity, route="sample")

    # -- limit ---------------------------------------------------------------
    def _lower_limit(self, plan: L.Limit) -> Lowered:
        """LIMIT / OFFSET over the mesh. Over ORDER BY (NULLS LAST on every
        key, any number and type of keys) whose k + offset fits a shard
        (`topk_fits` over the child's capacity a shard), the per-shard
        top-k (`_topk_dist`) and the offset's rows masked; else the sort's
        stage and the global row ranks (`_limit_global`)."""
        off = plan.offset
        if (
            isinstance(plan.input, L.Sort)
            and all(se.nulls_first is not True for se in plan.input.exprs)
            and plan.limit is not None
        ):
            k = plan.limit + off
            low = self._speculative(lambda: self._topk_dist(plan.input, k))
            if low is not None:
                if low.route == "threshold":
                    self.notes.append(f"sort+limit: per-shard top-k (first-key threshold, {len(plan.input.exprs)} "
                                      f"keys, k={k}) + candidate all_gather")
                else:
                    self.notes.append(f"sort+limit: per-shard top-k + candidate all_gather (k={k})")
                return replace(self._per_shard(low, lambda c: self._skip_rows(c, off)), route="topk")
        child = self.lower(plan.input)
        if child.layout == "replicated":
            return self._per_shard(child, lambda c: self._limit_over(c, plan.limit, off))
        return self._limit_global(self._as_dist(child), plan.limit, off)

    def _topk_dist(self, plan: L.Sort, k: int) -> Optional[Lowered]:
        """ORDER BY ... LIMIT k: the single card's top-k selection on each
        shard (`_topk_over`), the candidates' all_gather to the first card
        (at most k a shard, in shard order), and one selection over them.
        None where k does not fit a shard or the child is replicated.
        Each shard's candidates are its first k rows of the full sort's
        order, ties by lowest index, so the concatenation in shard order
        holds the global first k with ties in global row order, and the
        last selection, stable over it, keeps that order."""
        child = self.lower(plan.input)
        if child.layout == "replicated" or not topk_fits(k, -(-child.capacity // self.n_dev)):
            return None  # the sort's own stage and the LIMIT serve it
        child = self._as_dist(child)
        cands = self._per_shard(child, lambda c: self._topk_over(plan, c, k))
        return self._per_shard(self._gather_batch(cands), lambda c: self._topk_over(plan, c, k))

    def _limit_global(self, child: Lowered, k, off: int) -> Lowered:
        """LIMIT / OFFSET over partitioned rows by global row rank: a
        shard's ranks start after the selected rows of the shards before
        it."""

        mesh = self.mesh

        def fn(envs) -> ShardedBatch:
            sb = child.fn(envs)
            counts = C.all_gather([b.sel.sum().reshape(1) for b in sb.shards], mesh)
            bases = self._copies([torch.cumsum(counts, 0) - counts])
            out = []
            for d, b in enumerate(sb.shards):
                rank = bases[d][0][mesh.first + d] + torch.cumsum(b.sel.to(torch.int64), 0)
                keep = b.sel
                if k is not None:
                    keep = keep & (rank <= off + k)
                if off:
                    keep = keep & (rank > off)
                out.append(Batch(b.cols, keep))
            return ShardedBatch(out, "partitioned")

        return Lowered(child.schema, child.dicts, fn, None, "partitioned", child.capacity)

    # -- window ----------------------------------------------------------------
    def _lower_window(self, plan: L.Window) -> Lowered:
        """The JAX mesh's two window strategies (its dist.py:488-541). When
        every window expression shares one non-empty PARTITION BY over a
        partitioned child, the rows hash-repartition by those keys
        (`hash_keys_to_device`, NULL keys zeroed so that they hash alike,
        no skew salt: a window partition lands whole on one shard) through
        K5 (`repartition`, which sizes its regions exactly), and each shard
        evaluates its windows. Rows reach a receiver sender by sender, in
        row-block order, so ties in a partition keep the single card's
        order. Otherwise (global windows, mixed specs) the rows gather to
        a replicated batch and the windows run once."""
        child = self.lower(plan.input)
        pkeys = plan.window_exprs[0].partition_by
        same_spec = bool(pkeys) and all(wf.partition_by == pkeys for wf in plan.window_exprs)
        if child.layout == "replicated" or not same_spec:
            self.notes.append("window: gather to replicated, local evaluation")
            return replace(self._per_shard(self._gather_batch(child), lambda c: self._window_over(plan, c)),
                           route="gather")
        child = self._as_dist(child)
        n, card = self.n_dev, self.mesh.card_index
        part_c = self._on_cards(lambda: [self.compile(e, child) for e in pkeys])
        self.notes.append(f"window: hash-repartition by PARTITION BY keys over K5 (ragged exchange, {n} shards), "
                          "then the windows per shard")

        def fn(envs) -> ShardedBatch:
            sb = child.fn(envs)
            dsts = []
            for d, b in enumerate(sb.shards):
                keys = []
                for c in part_c[card(d)]:
                    kd, kv = broadcast_col(c.fn(b.cols), b.capacity)
                    keys.append(kd if kv is None else torch.where(kv, kd, torch.zeros((), dtype=kd.dtype,
                                                                                      device=kd.device)))
                dsts.append(hash_keys_to_device(keys, n))
            cols, sels = repartition([b.cols for b in sb.shards], dsts, [b.sel for b in sb.shards], n, mesh=self.mesh)
            return ShardedBatch([Batch(c, s) for c, s in zip(cols, sels)], "partitioned")

        reparted = Lowered(child.schema, child.dicts, fn, child.sources, "partitioned", child.capacity, child.bounds)
        return replace(self._per_shard(reparted, lambda c: self._window_over(plan, c)), route="repartition")

    # -- union -----------------------------------------------------------------
    def _lower_union(self, plan: L.Union) -> Lowered:
        """UNION ALL over the mesh: local children concatenate per shard
        (as one card would, shard by shard); partitioned ones too, shard by
        shard; replicated ones once. Where the children's layouts differ
        (the JAX mesh raises there), the partitioned ones gather to
        replicated first (`_gather_batch`)."""
        children = [self.lower(c) for c in plan.inputs]
        layouts = {c.layout for c in children}
        if layouts == {None}:
            return self._union_over(plan, children)
        if "replicated" in layouts and len(layouts) > 1:
            self.notes.append("union: partitioned inputs gathered to replicated before the concatenation")
            children = [self._gather_batch(c) for c in children]
        rep = all(c.layout == "replicated" for c in children)
        children = [c if rep else self._as_dist(c) for c in children]
        parts = self._on_cards(lambda: self._union_parts(plan, children))  # per card: its remap tables
        dicts = parts[0][0]
        n, card = self.n_local, self.mesh.card_index

        def fn(envs) -> ShardedBatch:
            sbs = [c.fn(envs) for c in children]
            if rep:
                return ShardedBatch([parts[0][1]([sb.shards[0] for sb in sbs])] * n, "replicated")
            return ShardedBatch([parts[card(d)][1]([sb.shards[d] for sb in sbs]) for d in range(n)], "partitioned")

        return Lowered(plan.schema, dicts, fn, None, "replicated" if rep else "partitioned",
                       sum(c.capacity for c in children))

    # -- join ----------------------------------------------------------------
    def _lower_join(self, plan: L.Join) -> Lowered:
        """The JAX mesh's two joins (its dist.py:543-914): the hash-shuffle
        join when both sides are partitioned, with keys, and the right
        side's capacity times 4 exceeds the left side's; else the broadcast
        join. RIGHT joins run as the swapped LEFT join."""
        swapped = self._right_as_left(plan)
        if swapped is not None:
            low = self._lower_join(swapped)
            return replace(self._per_shard(low, lambda c: self._swap_back(plan, c)), route=low.route)
        left, right = self.lower(plan.left), self.lower(plan.right)
        if (
            plan.on
            and "replicated" not in (left.layout, right.layout)
            and right.capacity * 4 > left.capacity
        ):
            return replace(self._join_shuffle(plan, left, right), route="shuffle")
        return replace(self._join_broadcast(plan, left, right), route="broadcast")

    def _join_broadcast(self, plan: L.Join, left: Lowered, right: Lowered) -> Lowered:
        """The build (right) side all_gathered to every shard, and each
        shard's left rows joined against it: the direct join (build = the
        right side only) or the sort join, so rows come in the left side's
        order, as on one card unless that takes the swapped direct join. A
        FULL join ORs the build rows' matched marks over the shards and
        appends the unmatched ones after the last shard's rows, where one
        card puts them (the JAX mesh spreads them over its chips)."""
        n, nl, mesh, card = self.n_local, len(left.schema), self.mesh, self.mesh.card_index
        right_g = self._gather_batch(right)
        runs = self._on_cards(lambda: self._join_runner(plan, left, right, swap_ok=False,
                                                        how="broadcast (build side all_gathered to every shard), "
                                                        "local "))
        run, meta = runs[0]
        is_full = plan.join_type is L.JoinType.Full
        dicts = left.dicts + right.dicts
        if left.layout == "replicated":
            def fn_rep(envs) -> ShardedBatch:
                return ShardedBatch([run(left.fn(envs).shards[0], right_g.fn(envs).shards[0])] * n, "replicated")

            return Lowered(plan.schema, dicts, fn_rep, layout="replicated", **meta)
        left_d = self._as_dist(left)

        def fn(envs) -> ShardedBatch:
            rbs = self._batch_copies(right_g.fn(envs).shards[0])  # the build side on every card
            shards = left_d.fn(envs).shards
            if not is_full:
                return ShardedBatch([runs[card(d)][0](b, rbs[d]) for d, b in enumerate(shards)], "partitioned")
            heads = [runs[card(d)][0](b, rbs[d], tail=False) for d, b in enumerate(shards)]
            hit = C.por([bm for _, _, bm in heads], mesh)
            # the tail's probe columns are NULL; every other shard's get an
            # all-true validity too, so every shard (and every process)
            # holds the same columns and later stages run the same ops
            out = [Batch([(d, torch.ones_like(h.sel) if v is None else v) for d, v in h.cols[:nl]] + h.cols[nl:],
                         h.sel) for h, _, _ in heads]
            if mesh.rank == mesh.world - 1:  # the tail follows the mesh's last shard
                last, matched, _ = heads[-1]
                rb = rbs[-1]
                pcols, bcols, rows = join_ops.full_merge_tail(last.cols[:nl], last.cols[nl:], matched, rb.cols,
                                                              rb.sel & ~C.to_card(hit, rb.sel.device))
                out[-1] = Batch(pcols + bcols, torch.ones(rows, dtype=torch.bool, device=rb.sel.device))
            return ShardedBatch(out, "partitioned")

        return Lowered(plan.schema, dicts, fn, layout="partitioned", **meta)

    def _join_shuffle(self, plan: L.Join, left: Lowered, right: Lowered) -> Lowered:
        """Both sides hash-repartitioned by key (`hash_keys_to_device`, the
        JAX mesh's hash) through K5 (parallel/shuffle.py `repartition`),
        then the sort join on each shard, with a FULL join's unmatched
        build rows appended there: every key lives on one shard. The probe
        side's send counts, read once, give the skew salt (`skew_salt`):
        salted probe rows go to `h * salt_r + row % salt_r`, the build rows
        go once to each of their key's `salt_r` shards. A FULL join's build
        row joins the tail, from its first copy, when no copy matched: the
        copies' marks meet by global row index (the JAX mesh reads only
        the first copy's, ROADMAP Queue 3). The rows come shard by shard,
        in an order the JAX mesh does not specify either."""
        n, nl, mesh, card = self.n_dev, len(left.schema), self.mesh, self.mesh.card_index
        runs = self._on_cards(lambda: self._join_runner(
            plan, left, right, direct_ok=False,
            how="shuffle (both sides hash-repartitioned over K5, skew salt from the probe side's send counts), "
            "local ",
        ))
        meta = runs[0][1]
        is_full = plan.join_type is L.JoinType.Full
        meta["capacity"] = 2 * left.capacity + (2 * right.capacity if is_full else 0)  # the JAX mesh's
        left_d, right_d = self._as_dist(left), self._as_dist(right)
        routes = self.routes

        def fn(envs) -> ShardedBatch:
            lsb, rsb = left_d.fn(envs).shards, right_d.fn(envs).shards
            lkeys = [[d for d, _ in runs[card(i)][0].keys(b, 0)] for i, b in enumerate(lsb)]
            lsel = [b.sel for b in lsb]
            ldst = [hash_keys_to_device(k, n) for k in lkeys]
            lroutes = [route(d, s, n) for d, s in zip(ldst, lsel)]
            salt_r = skew_salt(C.size_matrix([c for _, c in lroutes], mesh), n)
            if salt_r > 1:
                ldst = [hash_keys_to_device(k, n, salt_r=salt_r,
                                            salt=torch.arange(b.capacity, device=b.sel.device) % salt_r)
                        for k, b in zip(lkeys, lsb)]
                lroutes = None
            lrecv, lrsel = repartition([b.cols for b in lsb], ldst, lsel, n, lroutes, mesh=mesh)
            rcols, rsel, rdst = [], [], []
            base, total = 0, sum(b.capacity for b in rsb)
            if is_full and mesh.spans:  # global build row indices: earlier processes' rows come first
                caps = C.all_gather([torch.tensor([total], device=mesh.device)], mesh).tolist()
                base, total = sum(caps[:mesh.rank]), sum(caps)
            for i, b in enumerate(rsb):
                m, dev = b.capacity, b.sel.device
                keys = [d for d, _ in runs[card(i)][0].keys(b, 1)]
                cols = [broadcast_col(c, m) for c in b.cols]
                replica = torch.div(torch.arange(m * salt_r, device=dev), max(m, 1), rounding_mode="floor")
                if salt_r > 1:
                    cols = [(d.repeat(salt_r), None if v is None else v.repeat(salt_r)) for d, v in cols]
                    keys = [k.repeat(salt_r) for k in keys]
                rdst.append(hash_keys_to_device(keys, n, salt_r=salt_r, salt=replica))
                rsel.append(b.sel.repeat(salt_r))
                if is_full:  # each build row's global index, and which copy may join the tail
                    cols += [(base + torch.arange(m, device=dev).repeat(salt_r), None), (replica == 0, None)]
                rcols.append(cols)
                base += m
            rrecv, rrsel = repartition(rcols, rdst, rsel, n, mesh=mesh)
            if not is_full:
                out = [runs[card(i)][0](Batch(lc, ls), Batch(rc, rs))
                       for i, (lc, ls, rc, rs) in enumerate(zip(lrecv, lrsel, rrecv, rrsel))]
            else:
                # a build row's copies land on different shards: it is
                # matched if any copy is, so the marks meet by global row
                # index, on the first card
                heads = [runs[card(i)][0](Batch(lc, ls), Batch(rc[:-2], rs), tail=False)
                         for i, (lc, ls, rc, rs) in enumerate(zip(lrecv, lrsel, rrecv, rrsel))]
                hit = torch.zeros(max(total, 1), dtype=torch.bool, device=mesh.device)
                for (_, _, bm), rc in zip(heads, rrecv):
                    hit[C.to_card(rc[-2][0][bm], mesh.device)] = True
                hits = self._copies([C.por([hit], mesh)])
                out = []
                for i, ((head, matched, _), rc, rs) in enumerate(zip(heads, rrecv, rrsel)):
                    un = rs & rc[-1][0] & ~hits[i][0][torch.where(rs, rc[-2][0], 0)]
                    pcols, bcols, rows = join_ops.full_merge_tail(head.cols[:nl], head.cols[nl:], matched,
                                                                  rc[:-2], un)
                    out.append(Batch(pcols + bcols, torch.ones(rows, dtype=torch.bool, device=rs.device)))
            routes.append(f"join: shuffle, skew salt {salt_r}")
            return ShardedBatch(out, "partitioned")

        return Lowered(plan.schema, left.dicts + right.dicts, fn, layout="partitioned", **meta)

    # -- aggregate -----------------------------------------------------------
    def _aggregate_over(self, plan: L.Aggregate, child: Lowered) -> Lowered:
        """The JAX mesh's aggregate routes (its dist.py:1391-1416). A
        holistic aggregate (DISTINCT, MEDIAN / percentiles, the two-pass
        VAR / STDDEV: no partial of a shard merges) needs each group's rows
        on one shard: grouped, the rows hash-repartition by the group keys
        (`_aggregate_repartition`); ungrouped, they gather to replicated.
        Otherwise: dense per shard and a merge, the K6 fold, or partials
        and an all_gather merge; ungrouped, per-shard scalars merged."""
        if child.layout == "replicated":
            return self._per_shard(child, lambda c: PlanCompiler._aggregate_over(self, plan, c))
        metas = self._on_cards(lambda: self._aggregate_meta(plan, child))  # per card: (group_c, agg_meta, dicts)
        group_c, agg_meta, out_dicts = metas[0]
        holistic = [name.upper() for name, _, _, _ in agg_meta if name in agg_ops.HOLISTIC_FUNCS]
        if holistic and not group_c:
            self.notes.append(f"aggregate: gather to replicated, local evaluation ({holistic[0]} partials do not merge)")
            low = self._per_shard(self._gather_batch(child), lambda c: PlanCompiler._aggregate_over(self, plan, c))
            return replace(low, route="gather")
        child_d = self._as_dist(child)
        if not group_c:
            return self._ungrouped_dist(plan, child_d, metas, out_dicts)
        probe = self._probe_key_domains(group_c, plan.group_exprs, child)
        doms, offs, notes = probe if probe is not None else ([], [], [])
        prod = 0
        if doms:
            prod = 1
            for d in doms:
                prod *= d + 1  # +1 radix per key covers a NULL slot
        if holistic:
            self.note_decline(f"aggregate: dense per shard and exchange-fold declined ({holistic[0]} needs each "
                              "group's rows on one shard)")
            packed = 1 <= prod <= agg_ops.PACKED_MAX_GROUPS
            return self._aggregate_repartition(plan, child_d, metas, out_dicts, doms if packed else None, offs, notes)
        n, n_local, mesh, card = self.n_dev, self.n_local, self.mesh, self.mesh.card_index

        def shards_of(sb: ShardedBatch):
            return [
                ([broadcast_col(c.fn(b.cols), b.capacity) for c in metas[card(d)][0]],
                 self._specs_of(metas[card(d)][1], b), b.sel)
                for d, b in enumerate(sb.shards)
            ]

        def batch(keys, aggs, ng) -> Batch:  # on the keys' card
            return Batch(list(keys) + list(aggs), torch.ones(ng, dtype=torch.bool, device=keys[0][0].device))

        if 1 <= prod <= agg_ops.DENSE_MAX_GROUPS:
            self.notes.append(
                f"aggregate: dense sort-free group-by per shard ({' x '.join(notes)}) + psum/pmin/pmax merge"
            )

            def dense_reduce(gids, vals, masks, *, ops, num_groups):
                per = [segmented_reduce(g, v, m, ops=ops, num_groups=num_groups, dense=True)
                       for g, v, m in zip(gids, vals, masks)]
                return [tuple(_merge_dense(op, [p[a] for p in per], mesh) for a, op in enumerate(ops))]

            def fn_dense(envs) -> ShardedBatch:
                (res,) = agg_ops._dense_window_aggregate(shards_of(child_d.fn(envs)), doms, offs, dense_reduce)
                return ShardedBatch([batch(*res)] * n_local, "replicated")

            return Lowered(plan.schema, out_dicts, fn_dense, None, "replicated", min(child.capacity, prod + 1),
                           route="dense")

        if self._fold_ok(plan, prod):
            self.notes.append(
                f"aggregate: fused ragged-exchange fold, K6 ({' x '.join(notes)}, global slots={prod}, "
                f"{-(-prod // n)}/shard)"
            )

            def fold_reduce(gids, vals, masks, *, ops, num_groups):
                return exchange_fold(gids, vals, masks, ops=ops, num_groups=num_groups, n_dev=n, mesh=mesh)

            def slot_gid(d, size):  # local receiver d is the mesh's shard first + d, on its card
                return torch.arange(size, device=mesh.card_of(d)) * n + mesh.first + d

            def fn_fold(envs) -> ShardedBatch:
                res = agg_ops._dense_window_aggregate(shards_of(child_d.fn(envs)), doms, offs, fold_reduce, slot_gid)
                return ShardedBatch([batch(*r) for r in res], "partitioned")

            return Lowered(plan.schema, out_dicts, fn_fold, None, "partitioned", min(child.capacity, prod + 1),
                           route="fold")

        return self._merge_aggregate(plan, child_d, agg_meta, out_dicts, shards_of, batch,
                                     doms if 1 <= prod <= agg_ops.PACKED_MAX_GROUPS else None, offs, notes)

    def _aggregate_repartition(self, plan, child, metas, out_dicts, doms, offs, notes) -> Lowered:
        """The JAX mesh's repartition aggregate (its dist.py:916-1001):
        every row goes to the shard of its group keys' hash
        (`hash_keys_to_device`, the data under a NULL key zeroed so that
        NULL keys hash alike) through K5 (`repartition`), and each shard
        aggregates what it received (`grouped_aggregate`, on the packed id
        of the global probed domains where every key has one). A group
        lives on one shard, so every aggregate is local there. The result
        is partitioned: groups come shard by shard. `metas[c]` is card c's
        (group keys, aggregates, dictionaries)."""
        n, card = self.n_dev, self.mesh.card_index
        how = f"packed-gid co-sort ({' x '.join(notes)})" if doms is not None else "co-sort"
        self.notes.append(f"aggregate: hash-repartition by group keys over K5 (ragged exchange, {n} shards), then "
                          f"the local {how} + segmented reduce per shard{self._sorted_route_notes(plan)}")

        def fn(envs) -> ShardedBatch:
            sb = child.fn(envs)
            dsts = []
            for i, b in enumerate(sb.shards):
                keys = []
                for c in metas[card(i)][0]:
                    d, v = broadcast_col(c.fn(b.cols), b.capacity)
                    keys.append(d if v is None else torch.where(v, d, torch.zeros((), dtype=d.dtype, device=d.device)))
                dsts.append(hash_keys_to_device(keys, n))
            cols, sels = repartition([b.cols for b in sb.shards], dsts, [b.sel for b in sb.shards], n, mesh=self.mesh)
            out = []
            for i, (c, sel) in enumerate(zip(cols, sels)):
                b = Batch(c, sel)
                group_c, agg_meta, _ = metas[card(i)]
                keys = [broadcast_col(gc.fn(b.cols), b.capacity) for gc in group_c]
                okeys, oaggs, ng = agg_ops.grouped_aggregate(keys, self._specs_of(agg_meta, b), sel,
                                                             dense_domain=doms, dense_offset=offs)
                out.append(Batch(list(okeys) + list(oaggs), torch.ones(ng, dtype=torch.bool, device=sel.device)))
            return ShardedBatch(out, "partitioned")

        groups = self.DEFAULT_GROUP_CAPACITY if doms is None else math.prod(d + 1 for d in doms) + 1
        return Lowered(plan.schema, out_dicts, fn, None, "partitioned", min(child.capacity, groups),
                       route="repartition")

    def _fold_ok(self, plan: L.Aggregate, prod: int) -> bool:
        """The fold's gate: every key probed (`prod` > 0), at most WINDOW
        slots per shard, and the op list within K6's shared memory; both
        are bounded here, so nothing declines at run time. A decline is
        noted."""
        if prod <= 0:
            return False
        n_ops, _ = self._reduce_op_bound(plan)
        per_shard = -(-prod // self.n_dev)
        why = None
        if per_shard > WINDOW:
            why = f"domain {prod} needs {per_shard} slots/shard > {WINDOW}"
        elif n_ops > MAX_OPS:
            why = f"up to {n_ops} reduce ops, K6's shared memory holds {MAX_OPS} windows"
        if why is not None:
            self.note_decline(f"aggregate: exchange-fold declined ({why})")
            return False
        return True

    def _merge_aggregate(self, plan, child, agg_meta, out_dicts, shards_of, batch, doms, offs, notes):
        """Partial aggregates per shard (the co-sort + K2 sorted), their
        all_gather, and one merge by key with each function's combine:
        MIN of MINs, MAX of MAXs, SUM of SUMs and of COUNTs; AVG from its
        (SUM, COUNT) partials. The result is replicated."""
        how = f"packed-gid co-sort ({' x '.join(notes)})" if doms is not None else "co-sort"
        self.notes.append(f"aggregate: per-shard partial aggregate ({how}) + all_gather merge")
        layout = []  # per aggregate: (kind, its partial specs' functions and types)
        for name, _arg, rt, _q in agg_meta:
            if name in ("min", "max", "sum"):
                layout.append((name, [(name, rt), ("count", DataType.Int64)]))
            elif name == "count":
                layout.append((name, [("count", DataType.Int64)]))
            else:  # avg
                layout.append((name, [("sum", _float_partial(rt)), ("count", DataType.Int64)]))
        n_keys = len(plan.group_exprs)
        dev = self.mesh.device  # the merge runs on the first card

        def fn(envs) -> ShardedBatch:
            partials = []
            for keys, specs, sel in shards_of(child.fn(envs)):
                specs1 = [agg_ops.AggSpec(f, spec.arg, t) for spec, (_, parts) in zip(specs, layout) for f, t in parts]
                pk, pa, ng = agg_ops.grouped_aggregate(keys, specs1, sel, dense_domain=doms, dense_offset=offs)
                partials.append(batch(pk, pa, ng))
            g = ShardedBatch(partials, "partitioned").merged(self.mesh)  # all_gather
            gkeys, gaggs = g.cols[:n_keys], g.cols[n_keys:]
            specs2, i = [], 0
            for name, parts in layout:
                for f, t in parts:
                    specs2.append(agg_ops.AggSpec("sum" if f in ("sum", "count") else f, gaggs[i], t))
                    i += 1
            mk, ma, ng = agg_ops.grouped_aggregate(gkeys, specs2, g.sel, dense_domain=doms, dense_offset=offs)
            out, i = [], 0
            for (name, parts), (_, _, rt, _) in zip(layout, agg_meta):
                out_t = torch_dtype(rt)
                if name == "count":
                    out.append((ma[i][0].to(out_t), None))
                else:
                    val, cnt = ma[i][0], ma[i + 1][0]
                    if name == "avg":
                        val = val / cnt.clamp(min=1).to(val.dtype)
                    out.append((val.to(out_t), cnt > 0))
                i += len(parts)
            return ShardedBatch([Batch(list(mk) + out, torch.ones(ng, dtype=torch.bool, device=dev))] * self.n_local,
                                "replicated")

        groups = self.DEFAULT_GROUP_CAPACITY if doms is None else math.prod(d + 1 for d in doms) + 1
        return Lowered(plan.schema, out_dicts, fn, None, "replicated", min(child.capacity, groups), route="merge")

    def _ungrouped_dist(self, plan, child, metas, out_dicts) -> Lowered:
        """Whole-table aggregates: per-shard scalars merged by psum / pmin /
        pmax on the first card. A shard with no counted row joins a MIN /
        MAX as the identity. `metas[c]` is card c's aggregates."""
        dev, n, mesh, card = self.mesh.device, self.n_local, self.mesh, self.mesh.card_index

        def fn(envs) -> ShardedBatch:
            sb = child.fn(envs)
            cols = []
            for k, (name, _arg, rt, _) in enumerate(metas[0][1]):
                part_t = _float_partial(rt) if name == "avg" else rt
                per = []
                for d, b in enumerate(sb.shards):
                    arg = metas[card(d)][1][k][1]
                    argv = broadcast_col(arg.fn(b.cols), b.capacity)
                    specs = [agg_ops.AggSpec("count", argv, DataType.Int64)]
                    if name != "count":
                        specs.append(agg_ops.AggSpec("sum" if name == "avg" else name, argv, part_t))
                    per.append(agg_ops.ungrouped_aggregate(specs, b.sel))
                cnt = C.psum([p[0][0] for p in per], mesh)
                out_t = torch_dtype(rt)
                if name == "count":
                    cols.append((cnt.to(out_t).reshape(1), None))
                    continue
                vals = [p[1][0] for p in per]
                if name in ("min", "max"):
                    ident = agg_ops._sentinel(vals[0].dtype, name == "max")
                    vals = [torch.where(p[0][0] > 0, v, ident) for p, v in zip(per, vals)]
                    r = C.pmin(vals, mesh) if name == "min" else C.pmax(vals, mesh)
                else:
                    r = C.psum(vals, mesh)
                    if name == "avg":
                        r = r / cnt.clamp(min=1).to(r.dtype)
                cols.append((r.to(out_t).reshape(1), (cnt > 0).reshape(1)))
            return ShardedBatch([Batch(cols, torch.ones(1, dtype=torch.bool, device=dev))] * n, "replicated")

        return Lowered(plan.schema, out_dicts, fn, None, "replicated", 8)


def compile_plan_distributed(plan: L.LogicalPlan, tables, mesh: Mesh, fn_registry=None) -> CompiledQuery:
    """Compile `plan` to run over the shards of `mesh`: each scanned
    table's row blocks (parallel/mesh.py partition_table) are its shards.
    The result is the shards' rows in shard order (partitioned) or shard
    0's (replicated)."""
    device_plan, host_post = split_host_projection(plan, fn_registry or {})
    pc = DistCompiler(tables, mesh, fn_registry)
    top = pc._as_dist(pc.lower(device_plan))
    return CompiledQuery(
        schema=top.schema,
        dicts=top.dicts,
        _fn=top.fn,
        _scan_tables=pc.scan_tables,
        _host_post=host_post,
        notes=tuple(pc.notes + pc.sticky_notes),
        _mesh=mesh,
        _routes=pc.routes,
    )
