"""Drive the torch port on one NVIDIA GPU and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit), then the nvcc build of
     the kernels from datafusion_tpu_torch/csrc/ and its time, the
     `-Xptxas -v` report of K1's and K5's kernels (registers, stack frame,
     spills), and the shared and global atomics the fold kernels and the
     fixed-point float SUM's first passes compile to (cuobjdump)
  2. K1 (fused scan/filter/project) against its plain version on the card
     at 2^25 rows, bit for bit: random f64/i32 columns with NULLs for the
     c1 program and a CASE / CAST / integer-divide-by-zero program, a
     program over every value type with its edges (ALL_TYPES: NaN, +-inf,
     -0.0, INT_MIN / -1, zero divisors), and limits_program() at the
     kernel's capacity (64 instructions, 32 registers, 12 inputs and
     outputs, 32 constants)
  3. K2 (segmented reduce) against its plain version on the card at 2^25
     rows, with masks and NaN / +-inf values: sorted mode with 65,536
     groups, every row its own group, one group, 7 groups (runs spanning
     tiles and blocks), a tail of dropped ids, 15 ops and 33 ops (two
     launches; every other sorted call one) over f64 / i32 / f32 / i64;
     dense mode with 1,000 groups, 8 groups with 80% of the rows on one,
     2,048 groups, and 15 ops over 2,048 groups (two launches; every other
     dense call one). Each case runs a second launch that must give the
     same bits, float SUMs included: sorted mode on the same input, dense
     mode on the rows in a random order; dense mode's float SUMs must also
     equal the plain fixed-point function (segreduce.fixed_sum_plain) bit
     for bit
  3b. K3 (slab partition) and K4 (windowed reduce) against their plain
     versions on the card: 10,001 slots uniform at 2^25 rows, K4 also over
     the slab's rows shuffled; 16,383 slots with 80% of the rows on one gid
     and 14 ops at 2^25 - 1000 rows (a ragged last block); 16,001 slots
     with 80% on one gid; masks packed into the gid, NaN / +-inf payloads.
     K3's slabs must be equal element for element; K4's counts and MIN/MAX
     exact, its sums within rtol 1e-9 of the row-order sums and bit-equal
     to the plain fixed-point function, one launch per fold_launches entry
     (a float SUM takes three windows); K4 again over the slab's rows in a
     random order, every output bit-equal; K4's kernel-only time per case
  3c. K5 (ragged exchange) and K6 (ragged exchange + fold) against their
     plain versions on the card, 2^25 rows over 8 shards laid out by the
     shuffle (parallel/shuffle.py): K5 moving i32, f64 and u8 arrays with
     uniform destinations, 80% of every shard's rows to one shard, and
     one shard sending nothing, and 17 arrays of 1, 2, 4 and 8 bytes in two
     launches (valid prefixes bit-equal); K6 over 10,001
     slots (1,251 per shard) with SUM f64, COUNT, MIN f64, MAX i32, two
     masks and NaN / +-inf, for uniform gids and 80% of the rows on one
     gid, then 2,048 slots per shard with 14 ops, and a mesh of one shard
     (one launch per fold_launches entry; counts and MIN/MAX exact, f64
     sums within rtol 1e-9 and bit-equal to the plain fixed-point
     function), then K6 again over each region's routed rows in a random
     order, every output bit-equal
  4. the main path at 2^25 rows, in a context made with bigdense on:
     scan -> filter/project (K1), GROUP BY over a wide key (packed co-sort
     + K2 sorted), GROUP BY over a small key (K2 dense) + ORDER BY + LIMIT,
     and the bigdense GROUP BY (K3 + K4) over a key of TPC-H l_suppkey's
     SF1 domain, [1, 10000], for SUM/AVG/COUNT (q4) and MIN/MAX (q5); each
     checked against a numpy oracle; every kernel's launch count must go
     up during this run, q2 must make one K2 sorted launch and q4 / q5 one
     K3 and one K4 launch each. Then q4 and q5 once more on the packed co-sort +
     K2 (a second context, bigdense off, over the same tables: one K2
     sorted launch each), with both routes' warm walls and profiles
  5. the uk_cities / aggregate_test / numerics CSV queries through
     register_csv, compared byte for byte with the checked-in goldens
  6. the distributed main path: ExecutionContext(mesh=make_mesh(8)), 8
     logical shards on the card, over the phase-4 table plus a Utf8 column
     `mode` of TPC-H l_shipmode's seven values; m1 filter/project (K1 per
     shard), m2 dense GROUP BY + merge (K2 dense), m3 / m4 the fold GROUP
     BY (K6), m5 partials + all_gather merge (K2 sorted), m6 / m7 the
     multi- and single-key sample sorts (K5) with the global-rank LIMIT
     (NULLS FIRST, which the per-shard top-k does not take),
     m8 the per-shard top-k; each against a numpy oracle and the same
     query in a single-card context, with its EXPLAIN route, the K5 / K6
     launches it made (m5: 9 K2 sorted launches, one per shard and the
     merge), its warm wall and profile; then K1 at m1's shard shape (event,
     kernel-only and host time of each of its launches), K5 at m6's shape
     against its padded-transpose library call (and that its wrapper
     makes no call that copies host memory to the device), K6 at m3's
     shape (event and kernel-only time) and K2 dense at m2's per-shard
     shape
  7. joins at 2^25 rows over big plus TPC-H-shaped orders / supplier and a
     1,000-row dim: j1-j3 on one card, m9 / m10 the mesh's broadcast and
     shuffle joins, against a numpy oracle, with the routes EXPLAIN shows
     and the ones taken; a 2^20-row join that keeps big's row order
  8. windows, UNION, grouping sets and INTERSECT ALL at 2^25 rows over
     big, big + mode and orders (WINDOW_QUERIES, MESH_WINDOW_QUERIES):
     w1 top 3 per partition, w2 a running sum and LAG under a GROUP BY, w3
     whole-partition AVG / MAX (one K2 sorted launch, also held to its
     plain version), u1 ROLLUP in a bigdense context (K3 + K4, K2 dense),
     u2 INTERSECT ALL, u3 UNION over two dictionaries; m11-m14 over 8
     shards (the PARTITION BY repartition over K5, the gathered global
     window, ROLLUP on the fold, INTERSECT ALL); each against a numpy
     oracle (counts, ranks, MIN / MAX exact; f64 sums within their stated
     rounding bounds), with its EXPLAIN route, launches, warm wall and
     profile (chiprun_out/profile_windows.txt)
  9. the rest of the aggregate family at 2^25 rows over big and big + mode
     (AGG_QUERIES, MESH_AGG_QUERIES): a1 STDDEV / VARIANCE on the dense
     route (two K2 dense launches), a2 MEDIAN and percentiles riding the
     packed co-sort, a3 COUNT / SUM / AVG(DISTINCT) (one K2 sorted launch
     each), a4 the ungrouped mix, a5 a geometric-mean UDAF (K2 dense), a6
     TPC-H q16 over benchmarks/tpch.py's tables at scale 5 (30M lineitem
     rows); m15-m18 over 8 shards (the repartition aggregate over K5, the
     K6 fold, the gather); each against a numpy oracle, with its EXPLAIN
     route, launches, warm wall and profile
     (chiprun_out/profile_aggregates.txt); a1's and a3's K2 calls held to
     K2's plain version
  10. the date and timestamp functions at 2^25 rows over bigd (big + dt,
     Date32 days over 1900-2099, + ts, Timestamp seconds over the same span
     with 5% NULLs; DATE_QUERIES): d1 every EXTRACT field on K1 (one
     launch), d2 / d2t DATE_TRUNC of every unit, INTERVAL months and hours,
     CAST(ts AS DATE) and a WHERE on dt + 1 MONTH on K1, d3 GROUP BY
     YEAR(dt), QUARTER(dt) (co-sort + K2 sorted), m19 = d1 over 8 shards
     (K1 per shard, equal to one card); each against Python's calendar
     (datetime / isocalendar, once per distinct day) exactly; K1's date
     programs (K1_DATES) over the calendar's edges (date_edge_table:
     INT_MIN / INT_MAX days, +-2^62 seconds, leap days, ISO years of 53
     weeks) against the plain version bit for bit, and d1's program timed
     against its bound. Then TPC-H: the 22 shapes of benchmarks/tpch.py
     over gen_tables(1.0) (6M lineitem rows) on the card, t1-t22, each
     held to the same query through the port on the CPU over the same
     tables (floats at rtol 1e-9, all else exact) and to a second
     evaluation of itself byte for byte, and m20 = q1 over 8 shards
     against one card; each query's route, launches, warm wall and device
     busy share (chiprun_out/profile_dates_tpch.txt)
  11. ingest and the session API (run right after phase 5): a CSV of
     big's five columns at 2^23 rows (floats as `repr`) through the native
     C++ loader (built with g++ on first use; its count pass must give
     2^23 rows and an eager register_csv columns equal to the source bit
     for bit, with the parse rate), then a default (lazy) register_csv
     that parses nothing until i1 (K1, one launch; parses k, d, lat, lng
     only), i2 (K2 dense, one launch) and i3 (K2 sorted, one launch; parses
     g), each equal to the eager table's result_str and a numpy oracle, with
     its first wall (its parse included; the parses are also timed alone),
     warm wall, last_stats and profile (chiprun_out/profile_ingest.txt); i2's
     serialized plan run in a fresh context; an NDJSON file of 2^20 rows
     (a Utf8 mode with 5% NULLs) through STORED AS NDJSON, GROUP BY mode on
     K2 dense against a numpy oracle; `python -m datafusion_tpu_torch.console
     --script smoketest.sql --ref-output` on one card and with --mesh 8,
     stdout equal to tests/data/smoketest-expected.txt; and, where pyarrow
     imports (a line says which of pyarrow and pandas do), the CSV's rows
     written as Parquet and read by register_parquet, i1-i3 over it equal
     to the lazy CSV scan
  13. determinism (run after phase 10): TPC-H q15ish, which compares its
     revenue view with that view's own MAX, 30 times at scale 0.05 on the
     card, each equal to the CPU's rows, and the revenue view's f64 sums
     bit-equal in 5 runs; then q1-q5 and TPC-H's 22 shapes once under
     torch.use_deterministic_algorithms(True, warn_only=True), every
     nondeterminism warning logged (chiprun_out/determinism_warnings.txt)
  14. one mesh over several cards of one process (run after phase 9):
     `cards: N` and every card's name and power limit, then
     make_mesh(8, devices=...) over 4 or 2 cards (`cards_used`; two
     shards a card on four; with one card, (cuda:0, cuda:0): two logical cards, every
     per-card launch, event and agreed scale on the one card) over big +
     mode + o and orders, each shard's rows placed on its card at
     registration; m1-m8, m10, m11 and m15, each result_str byte-equal to
     the one-card 8-shard mesh and to the result phases 6-9 held to the
     numpy oracle, with its EXPLAIN route, K5 / K6 launches where phase 6
     had them, and warm walls beside the one-card mesh's (in turns with
     several cards); then K5 at m6's and K6 at m3's shapes across the
     cards, bit-equal to K5's plain version over the senders' arrays on
     one card and to K6's one-card launch and plain fixed-point sums,
     also with the first card's values 2^50 below the others'; with
     several cards, each one's event, kernel-only and host time, bytes
     over NVLink, bound (per card the larger of peer bytes over NVLink
     and own bytes over HBM) and the yardstick of one peer `copy_` per
     live region (`cross_card` in the kernels' line)
  12. several processes as one mesh (run last): on one card
     `python3 chip_smoke.py --rank R PORT DIR 2 1` twice, joined by
     torch.distributed (Gloo: NCCL refuses two processes on one card);
     on two cards two processes, one a card, over NCCL; on four, first
     four processes of one card each, then two processes of two cards
     each (`--rank R PORT DIR 2 2`, initialize_multihost's
     cards_per_process), over NCCL (`multi_rounds`). Each process runs
     everything over two meshes of 8 // world shards a process: "one",
     global_mesh(8 // world) on its card, and "cards", global_mesh(...,
     devices=...) over its two cards, or over two logical cards
     (cuda:i, cuda:i) of its one; each mesh holds its share of big's 2^24
     rows (k, d, lat, lng, g, mode, o; register_table_shards, placed on
     the shards' cards) and its blocks of orders, and its own 2^21-row CSV
     file with a Utf8 vocabulary the others lack (register_csv_shards);
     m1-m8, m10, m11, m15 and tests/multiproc_driver.py's five shard
     queries, each equal on every rank and mesh to the same query on one
     card over the whole tables (floats at rtol 1e-9), with equal routes
     and EXPLAIN on every rank, K6 launched by m3 / m4 and K5 by m6, m7,
     m10, m11, m15 on every logical card of each rank (`card_launches`),
     the backend, the bytes that crossed processes; `exchange_fold` over
     the mesh with the first process's receivers' values 2^50 below the
     others', each rank's tables bit-equal to one launch over all 8
     shards; an INSERT into a rank table of 2^20 rows, then m1 and m3,
     equal to one card after the same INSERT; each query's warm wall (the
     two meshes in turns where a process has two cards, beside one
     process over four cards before and after the groups), and, on a
     process's own two cards, K5's and K6's event, kernel-only time by
     card, host time, bytes over NVLink and bound by card
     (chiprun_out/phase12_w<world>c<cards>_rank*.txt hold the processes'
     output); then q1's and d1's results materialized by `to_host`
     (pinned) against the old per-column pageable `.cpu()`, first and
     warm, in ms and GB/s, equal bit for bit
Every kernel's kernel-only time comes from torch.profiler (kernel_only_ms),
its wrapper's host time from host_only_ms (`host_ms` in the kernels' line).
The reduce kernels' `library_ms` is one PyTorch call per op of the
kernel's op list, summed (LIBRARY). Then one JSON line per kernel set (times, bounds, launches on the main
paths, the joins, the windows, the aggregates, the dates and TPC-H, and
ingest) and, last,
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero.
There is no CPU path: without CUDA the script exits with an error.
`python3 chip_smoke.py --phase14` (or `--phase12`) runs the build and
phase 14 (or 12) alone: a rehearsal that prints neither the kernels'
line nor the last line.
"""

import collections
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 25  # the repo's c1/c2 scale
SEED = 20260
F32_OPS_PER_S = 67e12  # H100 SXM non-tensor f32 peak (no f64 rate in the guide's table)
ROOT = os.path.dirname(os.path.abspath(__file__))
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")  # TPC-H l_shipmode


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def hbm_bytes_per_s():
    """The card's memory rate, from the port's roofline table
    (utils/roofline.py): NVIDIA's published HBM figure for its name."""
    from datafusion_tpu_torch.utils.roofline import chip_hbm_gbps

    return chip_hbm_gbps() * 1e9


def time_ms(fn, reps=5):
    """Median CUDA-event time of `fn` over `reps` runs after a warm-up
    (utils/benchtime.py, one call a batch). Inputs are hundreds of MB, far
    past the 50 MB L2, so each run reads them cold."""
    from datafusion_tpu_torch.utils.benchtime import time_pipeline

    return time_pipeline(lambda _: fn(), None, depths=(1,), repeats=reps, trials=1, device="cuda") * 1e3


def fused_program(ctx, table_name, sql, build=None):
    """The K1 program the compiler builds for `sql` (Projection over
    Selection over TableScan), with the scanned input tensors. `build`
    replaces fused_stage.compile_program (the same arguments)."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.plan import logical as L
    from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection

    plan = push_down_projection(push_down_filters(ctx.plan(sql)))
    sel = plan.input
    scan = sel.input
    check(isinstance(sel, L.Selection) and isinstance(scan, L.TableScan), f"plan shape of {sql}")
    table = ctx.table(table_name)
    idx = list(range(len(table.schema))) if scan.projection is None else list(scan.projection)
    cols = [table.columns[i] for i in idx]
    computed = [e for e in plan.exprs if not isinstance(e, L.Column)]
    prog = (build or fs.compile_program)(
        table.schema.project(idx), [c.dictionary for c in cols], [c.validity is not None for c in cols],
        sel.expr, computed,
    )
    ins = ([cols[i].data for i in prog.inputs], [cols[i].validity for i in prog.inputs])
    return prog, ins


def program_bytes(prog, ins, n):
    b = sum(d.element_size() + (0 if v is None else 1) for d, v in zip(*ins))
    from datafusion_tpu_torch.ops.pallas.fused_stage import _storage

    b += sum(torch.empty(0, dtype=_storage(t)).element_size() + (1 if nl else 0) for _, t, nl in prog.outputs)
    b += 1 if prog.sel_reg >= 0 else 0
    return b * n


def same_bits(a, b):
    """Bit for bit, any NaN equal to any NaN (payloads carry no meaning)."""
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    same = a.view(bits) == b.view(bits)
    if a.dtype.is_floating_point:
        same |= a.isnan() & b.isnan()
    return bool(same.all())


def compare_k1(prog, ins, n, dev, run=None):
    """Kernel vs plain on the same inputs: sel, validity and valid data
    must be identical (same IEEE operations). `run` replaces
    fused_stage.run_fused (the same arguments). Returns max |diff| over
    the valid values (NaN against NaN as 0)."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    ks, ko = (run or fs.run_fused)(prog, *ins, n, dev)
    ps, po = fs.evaluate_plain(prog, *ins, n)
    torch.cuda.synchronize()
    check((ks is None) == (ps is None) and (ks is None or torch.equal(ks, ps)),
          "K1 selection differs from the plain version")
    err = 0.0
    for (kd, kv), (pd, pv) in zip(ko, po):
        check((kv is None) == (pv is None) and (kv is None or torch.equal(kv, pv)), "K1 validity differs")
        valid = torch.ones(n, dtype=torch.bool, device=dev) if kv is None else kv
        a, b = kd[valid], pd[valid]
        check(a.dtype == b.dtype and same_bits(a, b), "K1 data differs from the plain version")
        if a.numel() and a.dtype != torch.bool:
            a, b = a.double(), b.double()
            diff = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
            err = max(err, float(diff.max()))
    return err


def permuted(perm, tensors):
    """Each tensor (None stays None) with its rows in `perm`'s order; a
    tensor given twice is permuted once."""
    done = {}
    for t in tensors:
        if t is not None and id(t) not in done:
            done[id(t)] = t[perm].contiguous()
    return [None if t is None else done[id(t)] for t in tensors]


def check_same_bits(name, got, again):
    """A second launch's outputs against the first's, every one bit for
    bit (float SUMs included: the contract of csrc/reduce_common.cuh)."""
    for a, (x, y) in enumerate(zip(got, again)):
        check(x.dtype == y.dtype and torch.equal(x.view(torch.int64 if x.element_size() == 8 else torch.int32),
                                                 y.view(torch.int64 if y.element_size() == 8 else torch.int32)),
              f"{name}: output {a} differs between two launches")


def check_fixed(name, got, want):
    """The fold tile's float SUMs against the plain fixed-point function, bit for bit."""
    for a, w in want.items():
        check(torch.equal(got[a].view(torch.int64), w.view(torch.int64)),
              f"{name}: float SUM {a} differs from segreduce.fixed_sum_plain")


def compare_k2(gid, vals, masks, ops, g, dense):
    """K2 against its plain version (counts and MIN/MAX exact, f64 sums
    within rtol 1e-9 of its row-order sums), then a second launch with the
    same bits: dense mode over the rows in a random order, its float SUMs
    also bit-equal to the plain fixed-point function; sorted mode over the
    same rows. Returns (the sums' max_abs_err, the first call's launches)."""
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    before = sr.segmented_reduce.dense_launches + sr.segmented_reduce.sorted_launches
    k = sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g, dense=dense)
    launches = sr.segmented_reduce.dense_launches + sr.segmented_reduce.sorted_launches - before
    p = sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g)
    torch.cuda.synchronize()
    err = 0.0
    for op, a, b in zip(ops, k, p):
        if op == "sum" and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-6, equal_nan=True)
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                err = max(err, float((a[fin] - b[fin]).abs().max()))
            check(torch.equal(torch.isnan(a), torch.isnan(b)), "K2 NaN sums differ")
        else:
            check(torch.equal(a.nan_to_num(0.5), b.nan_to_num(0.5)), f"K2 {op} differs from the plain version")
    del p
    if dense:
        check_fixed("K2 dense", k, fixed_sums(gid, vals, masks, ops, g))
        perm = torch.randperm(gid.numel(), device=gid.device)
        again = sr.segmented_reduce(gid[perm].contiguous(), permuted(perm, vals), permuted(perm, masks), ops=ops,
                                    num_groups=g, dense=True)
    else:
        again = sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g)
    check_same_bits(f"K2 {'dense, rows permuted' if dense else 'sorted'}", k, again)
    return err, launches


def fixed_sums(gid, vals, masks, ops, num_groups):
    """{op index: the fold tile's f64 sum of each float SUM op} by the plain
    fixed-point function (segreduce.fixed_sum_plain), which the fold-tile
    kernels (K2 dense, K4, K6) equal bit for bit."""
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    return {a: sr.fixed_sum_plain(gid, v, m, num_groups) for a, (op, v, m) in enumerate(zip(ops, vals, masks))
            if sr.float_sum(op, v)}


def k6_fixed_sums(args, kw):
    """fixed_sums over K6's launch: every receiver's routed rows as one
    flat fold, receiver i's windows at slots i * num_groups + w (the
    scale is the launch's, over every receiver); each float SUM's
    [n_dev, num_groups] sums."""
    gids, vals, masks, sizes = args
    n_dev, cap, g = kw["n_dev"], kw["split_cap"], kw["num_groups"]
    sz = sizes.tolist()
    spans = [(i, j, i * cap, i * cap + sz[j][i]) for i in range(n_dev) for j in range(len(gids))]

    def cat(ts):
        return torch.cat([ts[j][lo:hi] for _, j, lo, hi in spans])

    w = torch.cat([gids[j][lo:hi] for _, j, lo, hi in spans])
    recv = torch.cat([torch.full((hi - lo,), i, dtype=torch.int32, device=w.device) for i, _, lo, hi in spans])
    flat = torch.where((w >= 0) & (w < g), recv * g + w, -1).int()
    v = [None if vals[0][a] is None else cat([x[a] for x in vals]) for a in range(len(kw["ops"]))]
    m = [None if u == 0 else cat([x[u - 1] for x in masks]) for u in kw["mask_map"]]
    return {a: t.view(n_dev, g) for a, t in fixed_sums(flat, v, m, kw["ops"], n_dev * g).items()}


def k2_bytes(gid, vals, masks, outs_groups, ops):
    b = gid.numel() * 4
    b += sum(v.numel() * v.element_size() for v in {id(v): v for v in vals if v is not None}.values())
    b += sum(m.numel() for m in {id(m): m for m in masks if m is not None}.values())
    return b + outs_groups * 8 * len(ops)


def fold_rows(gid, vals, masks, num_groups, offset=0):
    """Per op, the (int64 slot, value) rows a library call reduces: the
    ids in [0, num_groups) plus `offset`, and the values in the table's
    dtype (None for COUNT), each op's mask applied beforehand."""
    rows = []
    for v, m in zip(vals, masks):
        keep = (gid >= 0) & (gid < num_groups)
        if m is not None:
            keep &= m
        idx = gid[keep].long() + offset
        if v is not None:
            v = v[keep]
            v = v.double() if v.dtype.is_floating_point else v.long()
        rows.append((idx, v))
    return rows


LIBRARY = "one PyTorch call per op, summed: bincount (COUNT), index_add_ (SUM), scatter_reduce_ amin/amax (MIN/MAX)"


def library_ms(rows, ops, num_groups, dev):
    """The yardstick of a fold over `ops` (LIBRARY): one PyTorch call per
    op on `fold_rows`' rows, timed together."""
    def run():
        for op, (idx, v) in zip(ops, rows):
            if op == "count":
                torch.bincount(idx, minlength=num_groups)
            elif op == "sum":
                torch.zeros(num_groups, dtype=v.dtype, device=dev).index_add_(0, idx, v)
            else:
                fill = float("inf") if op == "min" else float("-inf")
                if not v.dtype.is_floating_point:
                    fill = torch.iinfo(v.dtype).max if op == "min" else torch.iinfo(v.dtype).min
                torch.full((num_groups,), fill, dtype=v.dtype, device=dev).scatter_reduce_(
                    0, idx, v, "amin" if op == "min" else "amax")
    return time_ms(run)


def traced_kernels(fn, names, reps=5):
    """For each of `names`, (launches, device ms) a call of `fn` of the
    kernels whose name holds it, from one torch.profiler trace of `reps`
    calls after a warm-up. A trace that misses names[0] is taken once more;
    None if that misses it too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {}
        for name in names:
            ev = [e for e in events if name in e.key]
            got[name] = (sum(e.count for e in ev) / reps, sum(e.self_device_time_total for e in ev) / reps / 1e3)
        if got[names[0]][0]:
            return got
    return None


def kernel_only_ms(fn, name, per_call=1, reps=5):
    """Device time of one call of `fn`, which launches `per_call` kernels
    named `name`: their mean time in torch.profiler over `reps` calls after
    a warm-up, times `per_call` (the mean stands even if the trace misses
    a launch). On the H100 the tracer has missed every launch of K5's
    kernel and some of K1's (both take a struct of pointers by value), and
    some traces recorded no device activity at all: a trace without the
    kernel is taken once more, and if that misses it too the time is
    `queued_ms`'s, said so in the log."""
    got = traced_kernels(fn, [name], reps)
    if got:
        launched, ms = got[name]
        return ms / launched * per_call
    ms = queued_ms(fn)
    log(f"torch.profiler recorded no {name} launch in two traces; its device time is from queued events: {ms:.3f} ms")
    return ms


def fold_kernel_ms(fn, name, launches, scale_name, ops, vals):
    """Kernel-only ms of a call of a fold-tile kernel (K2 dense, K4, K6)
    over `ops` of `vals`, in `launches` (segreduce.fold_launches) of the
    kernel `name`: theirs, plus the first pass's (`scale_name`) in each
    launch that holds a float SUM. Returns (total, first pass)."""
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    ms = kernel_only_ms(fn, name, len(launches))
    scaled = sum(any(sr.float_sum(op, v) for op, v in zip(ops[lo:hi], vals[lo:hi])) for lo, hi, _ in launches)
    first = kernel_only_ms(fn, scale_name, scaled) if scaled else 0.0
    return ms + first, first


def queued_ms(fn, reps=20):
    """Device time of one call of `fn` without the tracer or host time
    (utils/benchtime.py `time_queued`: the calls enqueued behind a sleep
    kernel, timed by CUDA events)."""
    from datafusion_tpu_torch.utils.benchtime import time_queued

    return time_queued(lambda _: fn(), None, reps=reps) * 1e3


def host_copies(fn):
    """The calls `fn` makes that copy host memory to the card, found by
    wrapping, for the call, every PyTorch call that can: torch.tensor and
    torch.as_tensor naming a device, and Tensor.to / .cuda / .copy_ /
    .pin_memory (any call of these counts). The tracer on this card misses
    launches and whole traces, so the calls are checked, not a trace."""
    seen, patched = [], []

    def spy_on(owner, name, copies):
        real = getattr(owner, name)

        def spy(*a, **kw):
            if copies(kw):
                seen.append(name)
            return real(*a, **kw)

        patched.append((owner, name, real, name in vars(owner)))
        setattr(owner, name, spy)

    for name in ("tensor", "as_tensor"):
        spy_on(torch, name, lambda kw: kw.get("device") is not None and torch.device(kw["device"]).type != "cpu")
    for name in ("to", "cuda", "copy_", "pin_memory"):
        spy_on(torch.Tensor, name, lambda kw: True)
    try:
        fn()
    finally:
        for owner, name, real, own in patched:
            if own:
                setattr(owner, name, real)
            else:
                delattr(owner, name)
    return seen


def host_only_ms(fn, reps=20):
    """Host time of one call of `fn` (argument checks, tables, launch),
    without waiting for the card: the mean over `reps` calls enqueued back
    to back after a synchronize. The card runs behind, so the event time
    of a call is about its host time plus its kernels' time."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def slab_bytes(n, slab_rows, cols):
    """Bytes K3 must move: the gid and payloads read once, the slab written once."""
    width = 4 + sum(c.element_size() for c in cols)
    return (n + slab_rows) * width


def compare_k4(gid, vals, masks, ops, num_groups, want_launches, slab=None):
    """K4 against its plain version in `want_launches` launches (a float
    SUM takes three of a block's 14 windows): counts and MIN/MAX exact,
    f64 sums within rtol 1e-9 of the row-order sums and bit-equal to the
    plain fixed-point function. With `slab` (a SlabFold), K4 reads K3's
    packed gid and scale words, as the main path launches it. Returns the
    sums' max_abs_err and K4's outputs."""
    from datafusion_tpu_torch.ops.pallas import partition as pt

    before = pt.windowed_reduce.launches
    k = pt.windowed_reduce(gid, vals, masks, ops=ops, num_groups=num_groups, slab=slab)
    launches = pt.windowed_reduce.launches - before
    check(launches == want_launches, f"K4 made {launches} launch(es), not {want_launches}")
    if slab is not None:
        gid, masks = slab.unpacked(gid)
    p = pt.windowed_reduce_plain(gid, vals, masks, ops=ops, num_groups=num_groups)
    torch.cuda.synchronize()
    err = 0.0
    for op, a, b in zip(ops, k, p):
        if op == "sum" and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-6, equal_nan=True)
            check(torch.equal(torch.isnan(a), torch.isnan(b)), "K4 NaN sums differ")
            fin = torch.isfinite(a) & torch.isfinite(b)
            if fin.any():
                err = max(err, float((a[fin] - b[fin]).abs().max()))
        else:
            check(torch.equal(a.nan_to_num(0.5), b.nan_to_num(0.5)), f"K4 {op} differs from the plain version")
    check_fixed("K4", k, fixed_sums(gid, vals, masks, ops, num_groups))
    return err, k


def compare_k3k4(gid, cols, id_mod, n_buckets, num_groups, mask_bits, ops, value_of, want_launches):
    """K3 against its plain version: every slab equal bit for bit, and
    K3's info (each float SUM's scale word, each bucket's chunk count).
    Then K4 over the slab as K3 left it, as the main path launches it
    (`SlabFold`: the gid packed, the masks its bits, K3's scale words, the
    blocks split by K3's chunk counts), against its plain version and
    bit-equal to K4 over the unpacked slab with its own first pass; and
    that over the slab's rows in a random order: the same bits, float
    SUMs included (any row order gives the same result). `value_of[a]` is
    the payload index of op a (None for COUNT); op a's mask is gid bit
    `mask_bits[a]` (None: no mask); K4 makes `want_launches` launches.
    Returns (K3's max_abs_err over every slab, with NaN against NaN as 0;
    K4's sum max_abs_err; K4's kernel-only ms over the slab as K3 left it)."""
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    scales, scale_at = pt.scale_pairs(ops, [None if i is None else cols[i] for i in value_of], value_of, mask_bits)
    kw = dict(n_buckets=n_buckets, id_mod=id_mod, scales=scales, num_groups=num_groups)
    ks = pt.slab_partition(gid, cols, **kw)
    ps = pt.slab_partition_plain(gid, cols, **kw)
    torch.cuda.synchronize()
    k3_err = 0.0
    for a, b in zip(ks, ps):
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        check(a.shape == b.shape and torch.equal(a.view(bits), b.view(bits)),
              "K3 slab or info differs from the plain version")
        ad, bd = a.double(), b.double()
        same = (ad == bd) | (ad.isnan() & bd.isnan())
        k3_err = max(k3_err, float(torch.where(same, 0.0, (ad - bd).abs()).max()))
        del ad, bd, same
    del ps
    pg, info = ks[0], ks[-1]
    fold = pt.SlabFold(id_mod, tuple(mask_bits), info, len(scales), scale_at)
    vals = [None if i is None else ks[1 + i] for i in value_of]
    none = [None] * len(ops)
    err, k = compare_k4(pg, vals, none, ops, num_groups, want_launches, slab=fold)
    gid_k, masks = fold.unpacked(pg)
    e1, own = compare_k4(gid_k, vals, masks, ops, num_groups, want_launches)
    check_same_bits("K4 given K3's scale words against its own first pass", k, own)
    ms = kernel_only_ms(lambda: pt.windowed_reduce(pg, vals, none, ops=ops, num_groups=num_groups, slab=fold),
                        "windowed_reduce_kernel", len(sr.fold_launches(sr.fold_widths(ops, vals), pt.WINDOW)))
    # the same bits for the slab's rows in a random order
    perm = torch.randperm(pg.numel(), device=pg.device)
    e2, again = compare_k4(gid_k[perm].contiguous(), permuted(perm, vals), permuted(perm, masks), ops, num_groups,
                           want_launches)
    check_same_bits("K4, rows permuted", k, again)
    return k3_err, max(err, e1, e2), ms


def shard_regions(arrays, dst, sel, n_dev=8):
    """Each shard's arrays laid out by destination, as the shuffle does
    (parallel/shuffle.py): (send arrays per shard, sizes, split_cap, chunk)."""
    from datafusion_tpu_torch.parallel import collectives as C
    from datafusion_tpu_torch.parallel import shuffle as sh

    routes = [sh.route(d, s, n_dev) for d, s in zip(dst, sel)]
    sizes = C.size_matrix([c for _, c in routes])
    split_cap, chunk = sh.region_capacity(sizes)
    sends = [sh.build_regions(a, rows, counts, n_dev, split_cap) for a, (rows, counts) in zip(arrays, routes)]
    return sends, sizes, split_cap, chunk


def k5_bytes(sends, sizes, chunk):
    """Bytes K5 must move: every live chunk read once and written once."""
    chunks = int(((sizes.long() + chunk - 1) // chunk).sum())
    return 2 * chunks * chunk * sum(t.element_size() for t in sends[0])


def k6_bytes(gids, vals, masks, sizes, num_groups, n_ops):
    """Bytes K6 must move: each routed row's window id, distinct values and
    masks read once, and every receiver's tables written once."""
    width = 4 + sum(t.element_size() for t in {id(t): t for t in vals[0] if t is not None}.values())
    width += len(masks[0])
    return int(sizes.sum()) * width + len(gids) * num_groups * 8 * n_ops


def compare_k5(sends, sizes, split_cap, chunk):
    """K5 against its plain version: every valid prefix bit-equal. Returns
    the max_abs_err over the float prefixes (NaN against NaN as 0)."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    n_dev = len(sends)
    k = rs.ragged_exchange(sends, sizes, n_dev=n_dev, split_cap=split_cap, chunk=chunk)
    p = rs.ragged_exchange_plain(sends, sizes, n_dev=n_dev, split_cap=split_cap, chunk=chunk)
    torch.cuda.synchronize()
    sz = sizes.tolist()
    err = 0.0
    for i in range(n_dev):
        for a, b in zip(k[i], p[i]):
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            for j in range(n_dev):
                span = slice(j * split_cap, j * split_cap + sz[j][i])
                check(torch.equal(a[span].view(bits), b[span].view(bits)), "K5 differs from the plain version")
            if a.dtype.is_floating_point:
                same = (a == b) | (a.isnan() & b.isnan())
                live = torch.cat([torch.arange(j * split_cap, j * split_cap + sz[j][i], device=a.device)
                                  for j in range(n_dev)])
                err = max(err, float(torch.where(same, 0.0, (a - b).abs())[live].max()) if live.numel() else 0.0)
    return err


def compare_k6(args, kw):
    """K6 against its plain version: counts and MIN/MAX exact, f64 sums
    within rtol 1e-9 of the row-order sums and bit-equal to the plain
    fixed-point function; then a second call over every region's routed
    rows in a random order, every output bit-equal. Returns (the sums'
    max_abs_err, the first call's launches)."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    before = rs.ragged_exchange_fold.launches
    k = rs.ragged_exchange_fold(*args, **kw)
    launches = rs.ragged_exchange_fold.launches - before
    p = rs.ragged_exchange_fold_plain(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for ki, pi in zip(k, p):
        for op, a, b in zip(kw["ops"], ki, pi):
            if op == "sum" and a.dtype.is_floating_point:
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-6, equal_nan=True)
                check(torch.equal(torch.isnan(a), torch.isnan(b)), "K6 NaN sums differ")
                fin = torch.isfinite(a) & torch.isfinite(b)
                if fin.any():
                    err = max(err, float((a[fin] - b[fin]).abs().max()))
            else:
                check(torch.equal(a.nan_to_num(0.5), b.nan_to_num(0.5)), f"K6 {op} differs from the plain version")
    del p
    tables = [torch.stack([ki[a] for ki in k]) for a in range(len(kw["ops"]))]
    check_fixed("K6", tables, k6_fixed_sums(args, kw))
    gids, vals, masks, sizes = args
    cap, sz = kw["split_cap"], sizes.tolist()
    perms = []
    for j in range(len(gids)):  # each region's valid prefix shuffled in place
        perm = torch.arange(gids[j].numel(), device=gids[j].device)
        for i in range(kw["n_dev"]):
            c = sz[j][i]
            perm[i * cap: i * cap + c] = i * cap + torch.randperm(c, device=perm.device)
        perms.append(perm)
    again = rs.ragged_exchange_fold([permuted(q, [g])[0] for g, q in zip(gids, perms)],
                                    [permuted(q, v) for v, q in zip(vals, perms)],
                                    [permuted(q, m) for m, q in zip(masks, perms)], sizes, **kw)
    check_same_bits("K6, routed rows permuted", tables, [torch.stack([ki[a] for ki in again])
                                                         for a in range(len(kw["ops"]))])
    return err, launches


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    from datafusion_tpu_torch.ops.pallas import cuda_lib

    _, secs, ptxas = cuda_lib.build_library(verbose=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas.txt"), "w") as f:
        f.write(ptxas)
    regs = [ln.strip() for ln in ptxas.splitlines() if "registers" in ln]
    log(f"phase 1 build: nvcc sm_90a, {len(cuda_lib.SOURCES)} sources in parallel, {secs:.2f} s; "
        f"{len(regs)} kernel register reports (chiprun_out/ptxas.txt)")
    for name, props in ptxas_reports(ptxas, ("fused_stage_kernel", "ragged_exchange_kernel")).items():
        log(f"phase 1 ptxas {name}: {props}")
    cuda_lib.load_library()
    log_shared_atomics(cuda_lib)
    return smi


def ptxas_reports(log_text, kernels):
    """Per compiled kernel whose name contains one of `kernels`: its
    `-Xptxas -v` lines (stack frame, spills; registers, shared memory)."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        elif name and any(k in name for k in kernels) and ("stack frame" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip() if "Used" in line else line.strip())
    return {k: "; ".join(v) for k, v in out.items()}


def log_shared_atomics(cuda_lib):
    """Which shared-memory atomics (ATOMS) and global atomics and
    reductions (ATOM, ATOMG, RED, REDG) the fold kernels compile to, from
    `cuobjdump -sass` of the built library: a native op shows as
    ATOMS.<op>, a CAS loop as ATOMS.CAS / ATOMS.CAST. Full list per kernel
    in chiprun_out/sass_atoms.txt."""
    import re

    cuobjdump = os.path.join(os.path.dirname(cuda_lib.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(cuda_lib.library_path())], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        for op in re.findall(r"\b(ATOMS(?:\.[A-Z0-9_]+)*|ATOMG?(?:\.[A-Z0-9_]+)+|REDG?(?:\.[A-Z0-9_]+)+)", line):
            found.setdefault(fn, set()).add(op)
    with open(os.path.join(ROOT, "chiprun_out", "sass_atoms.txt"), "w") as f:
        f.writelines(f"{k}: {' '.join(sorted(v))}\n" for k, v in sorted(found.items()))
    for kernel in ("seg_sorted_kernel", "seg_dense_kernel", "ragged_exchange_fold_kernel", "windowed_reduce_kernel",
                   "fold_scale_kernel", "ragged_scale_kernel"):
        ops = set().union(*[v for k, v in found.items() if kernel in k])
        log(f"phase 1 SASS {kernel}: shared atomics {sorted(o for o in ops if o.startswith('ATOMS'))}; "
            f"global {sorted(o for o in ops if not o.startswith('ATOMS'))}")


# every value type of K1, for the all-types program: (name, type, numpy
# dtype); `nv` and `j` carry NULLs
ALL_TYPES = (("b", "Boolean", np.bool_), ("i8", "Int8", np.int8), ("i16", "Int16", np.int16),
             ("i32", "Int32", np.int32), ("i64", "Int64", np.int64), ("u8", "UInt8", np.uint8),
             ("u16", "UInt16", np.uint16), ("u32", "UInt32", np.uint32), ("f32", "Float32", np.float32),
             ("f64", "Float64", np.float64), ("nv", "Float64", np.float64), ("j", "Int32", np.int32))
K1_ALL_TYPES = ("SELECT i8 + i8, i16 * i16, i32 / j, u8 - u8, u16 * u16, u32 + u32, f32 * 2 + f32, f64 - nv, "
                "CAST(i64 AS INT), CAST(f64 AS BIGINT), CAST(u32 AS DOUBLE), i64 % 7 FROM t WHERE b OR f64 > 0")


def edge_column(rng, dtype, n):
    """Values of `dtype` with its edges: zeros, -1, the extremes, and for
    floats NaN, +-inf and -0.0."""
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(max(info.min, -1000), min(info.max, 1000) + 1, n).astype(dtype)
        x[::7], x[3::11], x[5::13] = info.min, info.max, 0
        if info.min < 0:
            x[6::17] = -1
        return x
    x = (rng.standard_normal(n) * 100).astype(dtype)
    x[::19], x[4::23], x[8::29], x[9::31] = np.nan, np.inf, -np.inf, -0.0
    return x


def limits_program():
    """A K1 program at the kernel's capacity: 64 instructions over 32
    registers, 12 inputs of every value type, 32 constants, 12 outputs and
    a predicate, with registers reused as allocation reuses them and every
    opcode that is exact on every device (the transcendental functions
    are left to SQL programs)."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    types = (fs.T_BOOL, fs.T_I8, fs.T_I16, fs.T_I32, fs.T_I64, fs.T_U8, fs.T_U16, fs.T_U32, fs.T_F32, fs.T_F64,
             fs.T_F64, fs.T_I32)
    consts = [(1.5, fs.T_F64), (2.0, fs.T_F64), (7.5, fs.T_F64), (300, fs.T_I16), (-7, fs.T_I64), (200, fs.T_U8),
              (0.1, fs.T_F32), (0.5, fs.T_F64), (5, fs.T_I32), (-1, fs.T_I32), (0, fs.T_I64), (123456789012, fs.T_I64),
              (1000, fs.T_U16), (1 << 31, fs.T_U32)]
    consts += [(k / 3, fs.T_F64) for k in range(fs.MAX_CONST - len(consts))]
    code = []

    def op(o, t, d, a=0, b=0, c=0, k=None):  # k: operand b is the immediate consts[k]
        code.append((o, t, d, a, b if k is None else k, c, 0 if k is None else 1, 0 if k is None else consts[k][1]))

    for i, t in enumerate(types):  # r0-r11: the inputs
        op(fs.OP_LOAD, t, i, i)
    for i, t in enumerate(types):  # r12-r23: each input as f64
        op(fs.OP_CAST, fs.T_F64, 12 + i, i, c=t)
    op(fs.OP_ADD, fs.T_F64, 24, 21, 22)
    op(fs.OP_MUL, fs.T_F64, 25, 20, k=0)
    op(fs.OP_SUB, fs.T_F64, 26, 15, 16)
    op(fs.OP_DIV, fs.T_F64, 27, 16, 23)  # by zero: +-inf, NaN
    op(fs.OP_MATH1, fs.T_F64, 28, 24, c=fs.MATH1["abs"])
    op(fs.OP_MATH1, fs.T_F64, 29, 25, c=fs.MATH1["floor"])
    op(fs.OP_MATH2, fs.T_F64, 30, 26, c=fs.MATH2["round"], k=1)
    op(fs.OP_MOD, fs.T_F64, 31, 26, k=2)  # all 32 registers live
    op(fs.OP_ADD, fs.T_I8, 12, 1, 1)  # integer wrap at every width
    op(fs.OP_MUL, fs.T_I16, 13, 2, k=3)
    op(fs.OP_DIV, fs.T_I32, 14, 3, 11)  # NULL on a zero divisor, INT_MIN / -1
    op(fs.OP_MOD, fs.T_I64, 15, 4, k=4)
    op(fs.OP_SUB, fs.T_U8, 16, 5, k=5)
    op(fs.OP_ADD, fs.T_U16, 17, 6, 6)
    op(fs.OP_MUL, fs.T_U32, 18, 7, 7)
    op(fs.OP_ADD, fs.T_F32, 19, 8, k=6)
    op(fs.OP_DIV, fs.T_F32, 20, 19, 8)
    op(fs.OP_GT, fs.T_F64, 21, 9, k=7)
    op(fs.OP_LE, fs.T_I32, 22, 3, k=8)
    op(fs.OP_AND, fs.T_BOOL, 23, 21, 22)
    op(fs.OP_OR, fs.T_BOOL, 21, 23, 0)
    op(fs.OP_ISNULL, fs.T_BOOL, 22, 10)
    op(fs.OP_SELECT, fs.T_F64, 23, 21, 24, c=27)
    op(fs.OP_SELECT, fs.T_I32, 24, 22, c=14, k=9)
    op(fs.OP_CAST, fs.T_I64, 25, 23, c=fs.T_F64)  # float -> int saturates
    op(fs.OP_CAST, fs.T_U8, 26, 28, c=fs.T_F64)
    op(fs.OP_CAST, fs.T_F32, 27, 15, c=fs.T_I64)
    op(fs.OP_CAST, fs.T_I16, 28, 14, c=fs.T_I32)
    op(fs.OP_CAST, fs.T_BOOL, 29, 29, c=fs.T_F64)
    op(fs.OP_KEEPV, fs.T_F64, 30, 30, 14)
    op(fs.OP_EQ, fs.T_I64, 31, 15, k=10)
    op(fs.OP_ISNOTNULL, fs.T_BOOL, 22, 14)
    op(fs.OP_CONST, fs.T_I64, 21, 11)
    op(fs.OP_MUL, fs.T_I64, 21, 21, 4)
    op(fs.OP_NULL, fs.T_F64, 0)
    op(fs.OP_SELECT, fs.T_F64, 1, 31, 0, c=30)
    op(fs.OP_NE, fs.T_F32, 2, 20, 19)
    op(fs.OP_LT, fs.T_U16, 3, 17, k=12)
    op(fs.OP_GE, fs.T_U32, 4, 18, k=13)
    op(fs.OP_AND, fs.T_BOOL, 5, 2, 22)
    outs = ((12, fs.T_I8), (13, fs.T_I16), (24, fs.T_I32), (21, fs.T_I64), (16, fs.T_U8), (17, fs.T_U16),
            (18, fs.T_U32), (27, fs.T_F32), (1, fs.T_F64), (25, fs.T_I64), (29, fs.T_BOOL), (26, fs.T_U8))
    return fs.Program(code=code, consts=[fs._const_bits(v, t) for v, t in consts], inputs=list(range(fs.MAX_IN)),
                      input_types=list(types), outputs=[(r, t, True) for r, t in outs], sel_reg=5, n_regs=fs.MAX_REGS)


def limits_inputs(prog, n, dev, rng):
    """One edge column per input type of limits_program(), each with a
    validity."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    np_of = {fs.T_BOOL: np.bool_, fs.T_I8: np.int8, fs.T_I16: np.int16, fs.T_I32: np.int32, fs.T_I64: np.int64,
             fs.T_U8: np.uint8, fs.T_U16: np.uint16, fs.T_U32: np.uint32, fs.T_F32: np.float32, fs.T_F64: np.float64}
    data = [torch.from_numpy(edge_column(rng, np_of[t], n)).to(dev).to(fs._storage(t)) for t in prog.input_types]
    return data, [torch.from_numpy(rng.random(n) > 0.1).to(dev) for _ in data]


# K1's date opcodes over the calendar's edges (phase 10; also
# tests/test_torch_kernel_emu.py and tests/test_torch_cuda.py): the int32
# extremes of days, the day before and of the epoch, year 0's March 1 and
# year 1's January 1 (-719468, -719469, -719162), leap days and their
# neighbours, month ends, ISO years of 53 weeks and the days around their
# ends; seconds at the int64 extremes, +-2^62, around 0 and around these
# days' midnights
I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
DAY_1900, DAY_2100 = -25567, 47482  # 1900-01-01 and 2100-01-01, days since the epoch
DAY_1905, DAY_1925, DAY_2095 = -23741, -16436, 45656  # 1905-01-01, 1925-01-01, 2095-01-01
EDGE_DAYS = (I32.min, I32.min + 1, I32.max - 1, I32.max, -1, 0, 1, -719468, -719469, -719162) + tuple(
    int(np.datetime64(s_, "D").astype(np.int64)) for s_ in (
        "1900-02-28", "1900-03-01", "2000-02-29", "2000-03-01", "2024-02-29", "2100-02-28", "2100-03-01",
        "2021-01-31", "2021-02-28", "2004-12-31", "2005-01-02", "2009-12-31", "2010-01-03", "2015-12-31",
        "2016-01-03", "2020-12-31", "2021-01-03", "2021-01-04", "2026-12-31", "2027-01-03", "1908-12-31",
        "1909-01-03", "1969-12-29", "1999-12-31", "1900-01-01", "2099-12-31"))
EDGE_SECONDS = (I64.min, I64.min + 1, I64.max - 1, I64.max, -(1 << 62), 1 << 62, -1, 0, 1, -59, -60, -61, -3599,
                -3600, -86399, -86400, -86401, 86399, 86400) + tuple(
    d_ * 86400 + o for d_ in EDGE_DAYS[4:] for o in (-1, 0, 3599))
# three programs (at most 12 computed columns each) over every field, unit
# and INTERVAL function; t holds dt (Date32) and ts (Timestamp)
K1_DATES = (
    "SELECT YEAR(dt), MONTH(dt), DAY(dt), EXTRACT(DOW FROM dt), EXTRACT(DOY FROM dt), EXTRACT(QUARTER FROM dt), "
    "EXTRACT(WEEK FROM dt), EXTRACT(EPOCH FROM dt), DATE_TRUNC('year', dt), DATE_TRUNC('quarter', dt), "
    "DATE_TRUNC('month', dt), DATE_TRUNC('week', dt) FROM t WHERE dt + INTERVAL '1' MONTH > DATE '1950-01-01' "
    "OR ts IS NULL",
    "SELECT YEAR(ts), MONTH(ts), DAY(ts), HOUR(ts), MINUTE(ts), SECOND(ts), EXTRACT(DOW FROM ts), "
    "EXTRACT(DOY FROM ts), EXTRACT(QUARTER FROM ts), EXTRACT(WEEK FROM ts), EXTRACT(EPOCH FROM ts), "
    "CAST(ts AS DATE) FROM t WHERE ts IS NOT NULL OR dt > DATE '2000-01-01'",
    "SELECT DATE_TRUNC('year', ts), DATE_TRUNC('quarter', ts), DATE_TRUNC('month', ts), DATE_TRUNC('week', ts), "
    "DATE_TRUNC('day', ts), DATE_TRUNC('hour', ts), DATE_TRUNC('minute', ts), DATE_TRUNC('second', ts), "
    "dt + INTERVAL '1' MONTH, ts - INTERVAL '13' MONTH, ts + INTERVAL '3' HOUR, dt - INTERVAL '2' WEEK "
    "FROM t WHERE DATE_TRUNC('day', dt) <> DATE '2000-01-01'",
)


def date_edge_table(port, n, seed, device=None):
    """Table `t` of K1_DATES: dt (Date32 days) and ts (Timestamp seconds),
    a quarter of each over its whole integer range and the rest within
    1900-2099, every edge at the start and every 97th row after it, 5%
    NULLs each."""
    rng = np.random.default_rng(seed)
    wide = rng.random(n) < 0.25
    dt = np.where(wide, rng.integers(I32.min, I32.max, n, endpoint=True), rng.integers(DAY_1900, DAY_2100, n))
    ts = np.where(wide, rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True),
                  rng.integers(DAY_1900 * 86400, DAY_2100 * 86400, n))
    cols = []
    for a, edges, dtype in ((dt, EDGE_DAYS, np.int32), (ts, EDGE_SECONDS, np.int64)):
        a = a.astype(dtype)
        e = np.asarray(edges, dtype)
        a[: len(e)] = e[:n]
        at = np.arange(len(e), n, 97)
        a[at] = e[np.arange(at.size) % len(e)]
        cols.append(a)
    P = port.DataType
    return port.Table.from_arrays(port.Schema([port.Field("dt", P.Date32, True), port.Field("ts", P.Timestamp, True)]),
                                  cols, validity=[rng.random(n) > 0.05, rng.random(n) > 0.05], device=device)


def phase_k1(dev):
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    rng = np.random.default_rng(SEED)
    P = port.DataType
    schema = port.Schema([
        port.Field("i", P.Int32, True), port.Field("j", P.Int32, False),
        port.Field("a", P.Float64, True), port.Field("b", P.Float64, False),
    ])
    arrays = [
        rng.integers(-1000, 1000, N).astype(np.int32), rng.integers(-3, 4, N).astype(np.int32),
        rng.random(N) * 10 + 48, rng.standard_normal(N) * 100,
    ]
    validity = [rng.random(N) > 0.1, None, rng.random(N) > 0.2, None]
    ctx = port.ExecutionContext(device=dev)
    ctx.register_table("nt", port.Table.from_arrays(schema, arrays, validity=validity, device=dev))
    typed = port.Schema([port.Field(name, P[t], name in ("nv", "j")) for name, t, _ in ALL_TYPES])
    ctx.register_table("t", port.Table.from_arrays(
        typed, [edge_column(rng, dt, N) for _, _, dt in ALL_TYPES],
        validity=[rng.random(N) > 0.2 if name in ("nv", "j") else None for name, _, _ in ALL_TYPES], device=dev))
    cases = [(name, fused_program(ctx, table, sql)) for name, table, sql in (
        ("c1", "nt", "SELECT i, a, b, a + b FROM nt WHERE a > 51.0 AND a < 53"),
        ("case_cast_div0", "nt", "SELECT CASE WHEN a > 52 THEN CAST(i AS DOUBLE) ELSE b / 3 END, i / j, i % j, "
                                 "CAST(a * 100 AS INT) FROM nt WHERE a IS NULL OR i > 0"),
        ("all types", "t", K1_ALL_TYPES),
    )]
    limits = limits_program()
    cases.append(("limits", (limits, limits_inputs(limits, N, dev, rng))))
    res = {}
    for name, (prog, ins) in cases:
        err = compare_k1(prog, ins, N, dev)
        ms = time_ms(lambda: fs.run_fused(prog, *ins, N, dev))
        plain = time_ms(lambda: fs.evaluate_plain(prog, *ins, N), reps=3)
        log(f"phase 2 K1 {name}: kernel == plain at {N} rows (max_abs_err {err}), "
            f"{len(prog.code)} instructions over {prog.n_regs} registers ({fs.tile_rows(prog.n_regs)} rows a "
            f"thread), kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {program_bytes(prog, ins, N) / hbm_bytes_per_s() * 1e3:.3f} ms")
        res[name] = err
    return res


# K2 dense mode's and K6's edge op list: 15 ops, more than one launch's
# shared memory holds at 2048 slots
EDGE_OPS = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum", "min",
            "max")


def edge_streams(ops, f, i, m1, m2):
    """Op a's value (None for COUNT; the i32 stream where a % 3 == 2,
    else the f64 one) and mask (m1, none, m2 by a % 3)."""
    vals = [None if op == "count" else (i if a % 3 == 2 else f) for a, op in enumerate(ops)]
    return vals, [(m1, None, m2)[a % 3] for a in range(len(ops))]


def phase_k2(dev):
    rng = np.random.default_rng(SEED + 1)
    out = {"sorted": 0.0, "dense": 0.0}
    # (mode, slots, ops, share of rows on one slot)
    # the hot slots (every row, and nine rows in ten, on one slot) cross
    # the fold tile's checks: their shared words move in mid-range
    cases = (("sorted", 65536, None, 0.0), ("dense", 1000, None, 0.0), ("dense", 8, None, 0.8),
             ("dense", 2048, None, 0.0), ("dense", 2048, EDGE_OPS, 0.0), ("dense", 1000, None, 1.0),
             ("dense", 1000, None, 0.9))
    for mode, g, edge_ops, skew in cases:
        ids = rng.integers(0, g, N)
        if skew:
            ids[rng.random(N) < skew] = 3
        gid = torch.from_numpy((np.sort(ids) if mode == "sorted" else ids).astype(np.int32)).to(dev)
        f = torch.from_numpy(rng.standard_normal(N) * 100).to(dev)
        f[::1_000_003] = float("nan")
        f[7::2_000_003] = float("inf")
        f[11::3_000_017] = float("-inf")
        i = torch.from_numpy(rng.integers(-10**6, 10**6, N).astype(np.int32)).to(dev)
        m = torch.from_numpy(rng.random(N) < 0.9).to(dev)
        if edge_ops is None:
            vals, masks = [f, None, f, f, i, f.float()], [m, m, None, m, m, None]
            ops = ("sum", "count", "min", "max", "max", "min")
        else:
            ops = edge_ops
            vals, masks = edge_streams(ops, f, i, m, torch.from_numpy(rng.random(N) < 0.4).to(dev))
        err, launches = compare_k2(gid, vals, masks, ops, g, mode == "dense")
        if mode == "dense":
            check(launches == (2 if len(ops) > 14 else 1),
                  f"K2 dense made {launches} launches for {len(ops)} ops over {g} slots")
        log(f"phase 3 K2 {mode}: kernel == plain at {N} rows, {g} groups, {len(ops)} ops"
            f"{f', {skew:.0%} of rows on one slot' if skew else ''}, masks + NaN/inf"
            f"{f', {launches} launch(es)' if mode == 'dense' else ''} (sum max_abs_err {err}); "
            + ("float SUMs == fixed_sum_plain bit for bit, and bit-equal over the rows permuted" if mode == "dense"
               else "bit-equal in a second launch"))
        out[mode] = max(out[mode], err)
    return out


def value_pool(f, i):
    """The four value types from the f64 and i32 streams: f64, i32, f32,
    i64 (wide enough that an i32 sum would overflow)."""
    return f, i, f.float(), i.long() * 1_000_003


def phase_k2_sorted(dev):
    """K2 sorted mode's edge cases at N rows against its plain version:
    every row its own group, one group, 7 groups (runs spanning many tiles
    and blocks), a tail of dropped ids, and 15 and 33 ops (two launches),
    each with two masks and f64 / i32 / f32 / i64 values with NaN / +-inf.
    Every call must make len(sorted_launch_ops) launches."""
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    f = torch.randn(N, generator=gen, device=dev, dtype=torch.float64) * 100
    f[::1_000_003] = float("nan")
    f[7::2_000_003] = float("inf")
    f[11::3_000_017] = float("-inf")
    i = torch.randint(-10**6, 10**6, (N,), generator=gen, device=dev, dtype=torch.int32)
    pool = value_pool(f, i)
    m1 = torch.rand(N, generator=gen, device=dev) < 0.9
    m2 = torch.rand(N, generator=gen, device=dev) < 0.4
    err = 0.0
    # (case, groups; None: every row its own, dropped tail, ops)
    for case, g, tail, n_ops in (("every row its own group", None, 0, 5), ("one group", 1, 0, 5),
                                 ("7 groups", 7, 0, 5), ("dropped tail", 65536, 1_234_567, 5),
                                 ("15 ops", 65536, 0, 15), ("33 ops", 65536, 0, 33)):
        if g is None:
            gid, g = torch.arange(N, device=dev, dtype=torch.int32), N
        else:
            gid = torch.randint(0, g, (N,), generator=gen, device=dev).sort().values.int()
        if tail:
            gid[-tail:] = g
        ops = tuple(EDGE_OPS[a % len(EDGE_OPS)] for a in range(n_ops))
        vals = [None if op == "count" else pool[a % 4] for a, op in enumerate(ops)]
        masks = [(m1, None, m2)[a % 3] for a in range(n_ops)]
        e, launches = compare_k2(gid, vals, masks, ops, g, False)
        check(launches == len(sr.sorted_launch_ops(n_ops)) == (2 if n_ops > 32 else 1),
              f"K2 sorted made {launches} launches for {n_ops} ops")
        err = max(err, e)
        log(f"phase 3 K2 sorted: kernel == plain at {N} rows, {case} ({g} groups), {n_ops} ops, masks, "
            f"f64/i32/f32/i64 + NaN/inf, {launches} launch(es) (sum max_abs_err {e}); bit-equal in a second launch")
        del gid
    return err


# K4's op lists over the payloads [f64, i32, f32, bool]: (ops, payload of
# each op, mask bit of each op as an offset past the ids' bits)
K4_OPS8 = (("count", "sum", "min", "max", "max", "min", "sum", "count"), (None, 0, 0, 0, 1, 2, 1, None),
           (None, 0, 1, 0, None, 1, 0, 1))
K4_OPS14 = tuple(x + y for x, y in zip(K4_OPS8, (("sum", "max", "min", "count", "sum", "max"), (2, 0, 1, None, 0, 2),
                                                  (0, None, 1, 0, None, 1))))


def phase_k3k4(dev):
    rng = np.random.default_rng(SEED + 3)
    k3_err, k4_err = 0.0, 0.0
    # (rows, slots, share of the rows on one gid, op list, launches):
    # 2,048-slot windows of 5 buckets; the widest op list (one block's
    # shared memory before float SUMs took three windows; its three float
    # SUMs make 20 windows, two launches) over 16,383 slots with a ragged
    # last block; one bucket taking most rows; every row, and nine in ten,
    # on one gid (hot slots whose shared words move at the checks)
    for n, nslots, skew, (ops, value_of, mask_off), want in ((N, 10_001, 0.0, K4_OPS8, 1),
                                                             (N - 1000, 16_383, 0.8, K4_OPS14, 2),
                                                             (N, 16_001, 0.8, K4_OPS8, 1),
                                                             (N, 10_001, 1.0, K4_OPS8, 1),
                                                             (N, 10_001, 0.9, K4_OPS8, 1)):
        # ids in [0, nslots]; nslots is the unselected rows' slot
        ids = rng.integers(0, nslots + 1, n)
        if skew:
            ids[rng.random(n) < skew] = 12_345 if nslots > 12_345 else 4_321
        id_mod = 1 << nslots.bit_length()
        b0 = nslots.bit_length()
        m1 = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        m2 = torch.from_numpy(rng.random(n) < 0.5).to(dev)
        gid = torch.from_numpy(ids.astype(np.int32)).to(dev)
        gid = gid | (m1.int() << b0) | (m2.int() << (b0 + 1))
        f = torch.from_numpy(rng.standard_normal(n) * 100).to(dev)
        f[::1_000_003] = float("nan")
        f[7::2_000_003] = float("inf")
        f[11::3_000_017] = float("-inf")
        i = torch.from_numpy(rng.integers(-10**6, 10**6, n).astype(np.int32)).to(dev)
        f32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        flag = torch.from_numpy(rng.random(n) < 0.3).to(dev)
        mask_bits = tuple(None if o is None else b0 + o for o in mask_off)
        nb = -(-(nslots + 1) // 2048)
        e3, e4, ms = compare_k3k4(gid, [f, i, f32, flag], id_mod, nb, nslots, mask_bits, ops, value_of, want)
        k3_err, k4_err = max(k3_err, e3), max(k4_err, e4)
        log(f"phase 3b K3/K4: {n} rows, {nslots} slots ({nb} buckets{f', {skew:.0%} on one gid' if skew else ''}), "
            f"{len(ops)} ops: K3 slab and scale words == plain (max_abs_err {e3}), K4 over K3's slab == plain, "
            f"{want} launch(es) (sum max_abs_err {e4}), float SUMs == fixed_sum_plain bit for bit, bit-equal to K4 "
            f"with its own first pass and over the slab's rows permuted; K4 kernel only {ms:.3f} ms")
    return k3_err, k4_err


def phase_k5k6(dev):
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    n_dev, n = 8, N // 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    k5_err = 0.0
    # uniform destinations, 80% of every shard's rows to shard 3, shard 5
    # sending nothing, and 17 arrays of 1, 2, 4 and 8 bytes (two launches:
    # one holds 16)
    for layout in ("uniform", "skew", "empty", "batched"):
        dst, sel, arrays = [], [], []
        for j in range(n_dev):
            d = torch.randint(0, n_dev, (n,), generator=gen, device=dev)
            if layout == "skew":
                d = torch.where(torch.rand(n, generator=gen, device=dev) < 0.8, 3, d)
            dst.append(d)
            sel.append(torch.full((n,), not (layout == "empty" and j == 5), dtype=torch.bool, device=dev))
            cols = [
                torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev, dtype=torch.int32),
                torch.randn(n, generator=gen, device=dev, dtype=torch.float64),
                torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8),
            ]
            if layout == "batched":
                cols += [torch.randint(-2**15, 2**15, (n,), generator=gen, device=dev, dtype=torch.int16),
                         torch.randint(-2**40, 2**40, (n,), generator=gen, device=dev, dtype=torch.int64)]
                cols = (cols * 4)[:17]
            arrays.append(cols)
        sends, sizes, split_cap, chunk = shard_regions(arrays, dst, sel)
        before = rs.ragged_exchange.launches
        e = compare_k5(sends, sizes, split_cap, chunk)
        launches = rs.ragged_exchange.launches - before
        check(launches == (2 if layout == "batched" else 1), f"K5 made {launches} launches for {len(sends[0])} arrays")
        k5_err = max(k5_err, e)
        log(f"phase 3c K5 {layout}: {N} rows over {n_dev} shards, {len(sends[0])} arrays, split_cap {split_cap}, "
            f"chunk {chunk}, {launches} launch(es): kernel == plain on every valid prefix (max_abs_err {e})")
        del sends, arrays
    k6_err = 0.0
    # (shards, slots over all shards, 80% of rows on one gid, ops,
    # launches): m3's shape uniform and skewed, 2048 slots per shard with
    # 14 ops (three float SUMs: 20 tables, two launches), one shard
    for n_dev, slots, skew, n_ops, want in ((8, 10_001, False, 5, 1), (8, 10_001, True, 5, 1),
                                            (8, 8 * 2048, False, 14, 2), (1, 1251, False, 5, 1)):
        n = N // 8
        dst, sel, arrays = [], [], []
        for j in range(n_dev):
            g = torch.randint(0, slots, (n,), generator=gen, device=dev)
            if skew:
                g = torch.where(torch.rand(n, generator=gen, device=dev) < 0.8, 4321, g)
            f = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 100
            f[::1_000_003] = float("nan")
            f[7::2_000_003] = float("inf")
            f[11::3_000_017] = float("-inf")
            dst.append(g % n_dev)
            sel.append(torch.ones(n, dtype=torch.bool, device=dev))
            arrays.append([(g // n_dev).int(), f,
                           torch.randint(-10**6, 10**6, (n,), generator=gen, device=dev, dtype=torch.int32),
                           torch.rand(n, generator=gen, device=dev) < 0.9,
                           torch.rand(n, generator=gen, device=dev) < 0.5])
        sends, sizes, split_cap, _ = shard_regions(arrays, dst, sel, n_dev)
        if n_ops == 5:
            ops, mask_map = ("sum", "count", "min", "max", "count"), (1, 1, 2, 0, 0)
            vals = [[s[1], None, s[1], s[2], None] for s in sends]
        else:
            ops, mask_map = EDGE_OPS[:n_ops], tuple((1, 0, 2)[a % 3] for a in range(n_ops))
            vals = [edge_streams(ops, s[1], s[2], None, None)[0] for s in sends]
        args = ([s[0] for s in sends], vals, [[s[3], s[4]] for s in sends], sizes)
        kw = dict(ops=ops, mask_map=mask_map, n_dev=n_dev, split_cap=split_cap, num_groups=-(-slots // n_dev))
        e, launches = compare_k6(args, kw)
        check(launches == want, f"K6 made {launches} launches, not {want}")
        k6_err = max(k6_err, e)
        log(f"phase 3c K6: {n * n_dev} rows over {n_dev} shard(s), {slots} slots ({kw['num_groups']}/shard"
            f"{', 80% on one gid' if skew else ''}), {n_ops} ops, split_cap {split_cap}, {launches} launch(es): "
            f"counts and MIN/MAX == plain, f64 sum max_abs_err {e}, float SUMs == fixed_sum_plain bit for bit and "
            "bit-equal over the routed rows permuted")
        del sends, arrays, args, vals
    return k5_err, k6_err


def main_arrays(n=N):
    """The main path's table as numpy columns, from the seed: k, d, lat,
    lng, g (phase 4), then the codes of `mode` (phase 6); `n` rows."""
    rng = np.random.default_rng(SEED + 2)
    k = rng.integers(0, 65536, n).astype(np.int32)
    d = rng.integers(0, 1000, n).astype(np.int32)
    lat = rng.random(n) * 10 + 48
    lng = rng.random(n) * 12 - 9
    g = rng.integers(1, 10_001, n).astype(np.int32)  # TPC-H l_suppkey's domain at SF1
    mode = rng.integers(0, len(SHIPMODES), n).astype(np.int32)
    return k, d, lat, lng, g, mode


# the main paths' queries: (name, SQL, what EXPLAIN VERBOSE must show)
MAIN_QUERIES = (
    ("q1", "SELECT k, lat, lng, lat + lng FROM big WHERE lat > 51.0 AND lat < 53", "fused CUDA stage"),
    ("q2", "SELECT k, MIN(lat), MAX(lat), SUM(lng), COUNT(lat) FROM big GROUP BY k", "packed-gid co-sort"),
    ("q3", "SELECT d, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM big GROUP BY d ORDER BY d LIMIT 10",
     "dense sort-free"),
    ("q4", "SELECT g, SUM(lng), AVG(lat), COUNT(*) FROM big GROUP BY g", "bigdense radix-partition"),
    ("q5", "SELECT g, MIN(lat), MAX(lng), COUNT(lat) FROM big WHERE lat > 51.0 GROUP BY g", "bigdense radix-partition"),
)
MESH_QUERIES = (
    ("m1", "SELECT k, lat, lng, lat + lng FROM big WHERE lat > 57.9", "fused CUDA stage"),
    ("m2", "SELECT mode, SUM(lng), AVG(lat), MIN(lat), COUNT(*) FROM big GROUP BY mode",
     "dense sort-free group-by per shard"),
    ("m3", "SELECT g, SUM(lng), AVG(lat), MIN(lat), MAX(lng), COUNT(*) FROM big GROUP BY g",
     "fused ragged-exchange fold"),
    ("m4", "SELECT g, MIN(lat), COUNT(lat) FROM big WHERE lat > 51.0 GROUP BY g", "fused ragged-exchange fold"),
    ("m5", "SELECT k, SUM(lng), COUNT(*) FROM big GROUP BY k", "all_gather merge"),
    # NULLS FIRST (lat has no NULLs, so the same rows) keeps m6 and m7 on the sample sort and K5: without
    # it their k fits a shard and they take the per-shard top-k
    ("m6", "SELECT k, d, lat FROM big ORDER BY k, d, lat NULLS FIRST LIMIT 10000", "multi-key sample sort"),
    ("m7", "SELECT lat, g FROM big ORDER BY lat NULLS FIRST LIMIT 5000", "distributed sample sort"),
    ("m8", "SELECT k, lat FROM big ORDER BY lat DESC LIMIT 10", "per-shard top-k"),
)


def main_table(port, arrays):
    """Phase 4's table on the card: k, d, lat, lng, g of `main_arrays`."""
    P = port.DataType
    schema = port.Schema([port.Field("k", P.Int32, False), port.Field("d", P.Int32, False),
                          port.Field("lat", P.Float64, False), port.Field("lng", P.Float64, False),
                          port.Field("g", P.Int32, False)])
    return port.Table.from_arrays(schema, list(arrays[:5]))


def mesh_table(port, big, mode):
    """Phase 6's table: phase 4's columns (no copy) and `mode`, a Utf8
    column of TPC-H l_shipmode's values from their codes."""
    P = port.DataType
    mode_col = port.Column(P.Utf8, torch.from_numpy(mode).to(big.columns[0].data.device), None, SHIPMODES)
    return port.Table(port.Schema(list(big.schema.fields) + [port.Field("mode", P.Utf8, False)]),
                      big.columns + (mode_col,), big.num_rows)


def phase_main_path(dev, kernel_stats, arrays):
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    k, d, lat, lng, g, _mode = arrays
    ctx = port.ExecutionContext(bigdense=True)  # the card, by default
    check(ctx.device.type == "cuda", "ExecutionContext() is not on the card")
    t0 = time.perf_counter()
    ctx.register_table("big", main_table(port, arrays))
    torch.cuda.synchronize()
    log(f"phase 4 table: {N} rows, {sum(c.data.nbytes for c in ctx.table('big').columns) / 1e9:.2f} GB "
        f"resident, loaded in {time.perf_counter() - t0:.2f} s")
    queries = MAIN_QUERIES
    q1, q4, q5 = (next(q for n, q, _ in queries if n == name) for name in ("q1", "q4", "q5"))
    for _, q, note in queries:
        check(note in ctx.sql(f"EXPLAIN VERBOSE {q}").result_str(), f"{q} does not route to {note}")

    counters = {"fused_stage": (fs.run_fused, "launches"), "segreduce_sorted": (sr.segmented_reduce, "sorted_launches"),
                "segreduce_dense": (sr.segmented_reduce, "dense_launches"),
                "slab_partition": (pt.slab_partition, "launches"), "windowed_reduce": (pt.windowed_reduce, "launches")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    results, walls, per_query = {}, {}, {}
    for name, q, _ in queries:
        before = {c: getattr(f, a) for c, (f, a) in counters.items()}
        t = time.perf_counter()
        results[name] = ctx.sql(q)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) * 1e3
        per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
    launches = {c: getattr(f, a) for c, (f, a) in counters.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    # one launch for all of a query's ops: K2 sorted in q2, K3 and K4 in q4 / q5
    check(per_query["q2"]["segreduce_sorted"] == 1, f"q2 made {per_query['q2']['segreduce_sorted']} K2 sorted launches")
    for name in ("q4", "q5"):
        check(per_query[name]["slab_partition"] == 1 and per_query[name]["windowed_reduce"] == 1,
              f"{name} made {per_query[name]} launches, not one K3 and one K4")

    # numpy oracle: exact keys, counts, MIN and MAX; rtol=1e-9 for sums
    mask = (lat > 51.0) & (lat < 53)
    c = [col for col, _ in results["q1"].cols]
    for got, want in zip(c, (k[mask], lat[mask], lng[mask], lat[mask] + lng[mask])):
        check(np.array_equal(got, want), "q1 differs from the numpy oracle")
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    c = [col for col, _ in results["q2"].cols]
    check(np.array_equal(c[0], ks[starts]), "q2 keys")
    check(np.array_equal(c[1], np.minimum.reduceat(lat[order], starts)), "q2 MIN")
    check(np.array_equal(c[2], np.maximum.reduceat(lat[order], starts)), "q2 MAX")
    check(np.allclose(c[3], np.add.reduceat(lng[order], starts), rtol=1e-9, atol=0), "q2 SUM")
    check(np.array_equal(c[4], np.diff(np.r_[starts, N])), "q2 COUNT")
    c = [col for col, _ in results["q3"].cols]
    cnt = np.bincount(d, minlength=1000)[:10]
    check(np.array_equal(c[0], np.arange(10)), "q3 keys")
    check(np.allclose(c[1], np.bincount(d, weights=lng, minlength=1000)[:10], rtol=1e-9, atol=0), "q3 SUM")
    check(np.allclose(c[2], np.bincount(d, weights=lat, minlength=1000)[:10] / cnt, rtol=1e-9, atol=0), "q3 AVG")
    dmin = np.full(1000, np.inf)
    np.minimum.at(dmin, d[d < 10], lat[d < 10])
    check(np.array_equal(c[3], dmin[:10]), "q3 MIN")
    check(np.array_equal(c[4], cnt), "q3 COUNT")
    gcnt = np.bincount(g, minlength=10_001)[1:]
    gsel = lat > 51.0
    sel_g = g[gsel]
    order = np.argsort(sel_g, kind="stable")
    sg = sel_g[order]
    gstarts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
    oracle = {
        "q4": (np.arange(1, 10_001), np.bincount(g, weights=lng, minlength=10_001)[1:],
               np.bincount(g, weights=lat, minlength=10_001)[1:] / gcnt, gcnt),
        "q5": (sg[gstarts], np.minimum.reduceat(lat[gsel][order], gstarts),
               np.maximum.reduceat(lng[gsel][order], gstarts), np.diff(np.r_[gstarts, len(sg)])),
    }

    def check_bigdense_shape(name, res):
        c = [col for col, _ in res.cols]
        want = oracle[name]
        check(np.array_equal(c[0], want[0]), f"{name} keys")
        exact = (3,) if name == "q4" else (1, 2, 3)  # q4's SUM and AVG are float sums
        for j in (1, 2, 3):
            ok = np.array_equal(c[j], want[j]) if j in exact else np.allclose(c[j], want[j], rtol=1e-9, atol=0)
            check(ok, f"{name} column {j} differs from the numpy oracle")

    for name in ("q4", "q5"):
        check_bigdense_shape(name, results[name])

    # the same two queries on the packed co-sort + K2: a second context,
    # bigdense off, over the same Table objects (no copy)
    ctx0 = port.ExecutionContext(device=dev, bigdense=False)
    ctx0.register_table("big", ctx.table("big"))
    for name, q in (("q4", q4), ("q5", q5)):
        check("packed-gid co-sort" in ctx0.sql(f"EXPLAIN VERBOSE {q}").result_str(), f"{name} packed route")
        before = sr.segmented_reduce.sorted_launches
        check_bigdense_shape(name, ctx0.sql(q))
        packed = sr.segmented_reduce.sorted_launches - before
        check(packed == 1, f"{name} on the packed route made {packed} K2 sorted launches")

    runs = [(name, ctx, q) for name, q, _ in queries] + [("q4 packed", ctx0, q4), ("q5 packed", ctx0, q5)]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 4 main path: q1-q5 match the numpy oracle (q4/q5 on the bigdense and the packed route); "
        "wall ms first " + json.dumps({n: round(v, 3) for n, v in walls.items()}) + " warm (median of 5) "
        + json.dumps({n: round(v, 3) for n, v in warm.items()}) + f"; launches per query {json.dumps(per_query)}; "
        "q4 / q5 on the packed route 1 K2 sorted launch each")
    profile_queries(runs)

    # each kernel timed at the shape the main path gives it
    prog, ins = fused_program(ctx, "big", q1)
    kernel_stats["fused_stage"].update(
        launches=launches["fused_stage"],
        ms=time_ms(lambda: fs.run_fused(prog, *ins, N, dev)),
        kernel_ms=kernel_only_ms(lambda: fs.run_fused(prog, *ins, N, dev), "fused_stage_kernel"),
        host_ms=host_only_ms(lambda: fs.run_fused(prog, *ins, N, dev)),
        plain_ms=time_ms(lambda: fs.evaluate_plain(prog, *ins, N), reps=3),
        bound_ms=program_bytes(prog, ins, N) / hbm_bytes_per_s() * 1e3,
        ops_bound_ms=sum(op > fs.OP_NULL for op, *_ in prog.code) * N / F32_OPS_PER_S * 1e3,
        library_ms=None,
    )
    big = ctx.table("big")
    lat_t, lng_t = big.columns[2].data, big.columns[3].data
    kk = big.columns[0].data
    perm = torch.sort(kk, stable=True).indices
    gs = kk[perm]
    bnd = torch.ones_like(gs, dtype=torch.bool)
    bnd[1:] = gs[1:] != gs[:-1]
    sgid = (torch.cumsum(bnd.int(), 0, dtype=torch.int32) - 1).contiguous()
    g2 = int(bnd.sum())
    slat, slng = lat_t[perm].contiguous(), lng_t[perm].contiguous()
    dd = big.columns[1].data
    for name, gid, vals, ops, g, dense in (
        ("segreduce_sorted", sgid, [slat, slat, slng, None], ("min", "max", "sum", "count"), g2, False),
        ("segreduce_dense", dd, [None, lng_t, lat_t, lat_t], ("count", "sum", "sum", "min"), 1001, True),
    ):
        masks = [None] * len(ops)
        call = lambda: sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g, dense=dense)  # noqa: E731
        if dense:
            kms, first = fold_kernel_ms(call, "seg_dense", sr.fold_launches(sr.fold_widths(ops, vals), g),
                                        "fold_scale_kernel", ops, vals)
            kernel_stats[name]["first_pass_ms"] = first
        else:
            kms = kernel_only_ms(call, "seg_sorted", len(sr.sorted_launch_ops(len(ops))))
        kernel_stats[name].update(
            launches=launches[name],
            ms=time_ms(call),
            kernel_ms=kms,
            host_ms=host_only_ms(call),
            plain_ms=time_ms(lambda: sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g), reps=3),
            bound_ms=k2_bytes(gid, vals, masks, g, ops) / hbm_bytes_per_s() * 1e3,
            ops_bound_ms=len(ops) * N / F32_OPS_PER_S * 1e3,
            library_ms=library_ms(fold_rows(gid, vals, masks, g), ops, g, dev),
            library=LIBRARY,
        )
    # K3 and K4 at q4's shape, as q4 launches them (ops/aggregate.py
    # slab_reduce): K3 over the gid of g (slots 0..9999, 10000 unselected)
    # with lng and lat, leaving the two float SUMs' scale words and the
    # buckets' chunk counts; K4 over the slab as K3 left it, no first pass
    from datafusion_tpu_torch.ops import aggregate as agg

    (a3, kw3), = capture(agg, "slab_partition", lambda: ctx.sql(q4))
    (a4, kw4), = capture(agg, "windowed_reduce", lambda: ctx.sql(q4))
    gid4, cols = a3
    k3 = lambda: pt.slab_partition(gid4, cols, **kw3)  # noqa: E731
    k4 = lambda: pt.windowed_reduce(*a4, **kw4)  # noqa: E731
    pg, vals4 = a4[0], a4[1]
    rows = pg.numel()
    kernel_stats["slab_partition"].update(
        launches=launches["slab_partition"],
        ms=time_ms(k3),
        kernel_ms=kernel_only_ms(k3, "slab_partition_kernel"),
        host_ms=host_only_ms(k3),
        plain_ms=time_ms(lambda: pt.slab_partition_plain(gid4, cols, **kw3), reps=3),
        bound_ms=slab_bytes(N, rows, cols) / hbm_bytes_per_s() * 1e3,
        # per row: the bucket (and, shift), the histogram add, the rank add,
        # and each scale word's max
        ops_bound_ms=(4 + len(kw3["scales"])) * N / F32_OPS_PER_S * 1e3,
        library_ms=None,  # no one PyTorch call makes a gap-aligned per-block partition
    )
    ops4, masks4, fold, nslots = kw4["ops"], [None] * len(kw4["ops"]), kw4["slab"], kw4["num_groups"]
    gid_k, _ = fold.unpacked(pg)
    # K4 must read every slab row's gid, but a payload only where the row
    # is live: a SENTINEL gap is never reduced
    live = int((pg < pt.SENTINEL).sum())
    # K4's fold and its first pass (fold_scale_kernel) from one trace: over
    # K3's slab the first pass must not launch, as K3 left the scale words
    got = traced_kernels(k4, ["windowed_reduce_kernel", "fold_scale_kernel"])
    check(got is not None, "phase 4: torch.profiler recorded no windowed_reduce_kernel launch in two traces, "
          "so K4's first pass cannot be read")
    (n_fold, fold_ms), (n_first, first4) = got["windowed_reduce_kernel"], got["fold_scale_kernel"]
    check(n_first == 0, f"phase 4: K4 over K3's slab launched fold_scale_kernel {n_first} times a call")
    kms4 = fold_ms / n_fold * len(sr.fold_launches(sr.fold_widths(ops4, vals4), pt.WINDOW)) + first4
    k34 = kernel_stats["slab_partition"]["kernel_ms"] + kms4
    kernel_stats["windowed_reduce"].update(
        launches=launches["windowed_reduce"],
        ms=time_ms(k4),
        kernel_ms=kms4,
        first_pass_ms=first4,
        k3_plus_k4_ms=k34,
        host_ms=host_only_ms(k4),
        plain_ms=time_ms(lambda: pt.windowed_reduce_plain(gid_k, vals4, masks4, ops=ops4, num_groups=nslots), reps=3),
        bound_ms=(rows * 4 + live * (8 + 8) + nslots * 8 * len(ops4)) / hbm_bytes_per_s() * 1e3,
        ops_bound_ms=len(ops4) * live / F32_OPS_PER_S * 1e3,
        library_ms=library_ms(fold_rows(gid_k, vals4, masks4, nslots), ops4, nslots, dev),
        library=LIBRARY,
    )
    log(f"phase 4 K3 + K4 at q4's shape: K3 {kernel_stats['slab_partition']['kernel_ms']:.3f} ms (with "
        f"{len(kw3['scales'])} scale words) + K4 {kms4:.3f} ms = {k34:.3f} ms, kernel only; K4's first pass "
        f"launched {n_first} times a call ({first4:.3f} ms)")
    return big


def warm_wall_ms(ctx, q, reps=5, devices=None):
    """Median host-clock wall of `ctx.sql(q)` plus a synchronize (of every
    card of `devices`; default the current one) over `reps` runs after a
    warm-up run: the host's share of a wall varies from run to run by more
    than a kernel's time."""
    def sync():
        for d in dict.fromkeys(devices or [None]):
            torch.cuda.synchronize(d)

    ctx.sql(q)
    walls = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        ctx.sql(q)
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def profile_queries(runs, phase="phase 4", out="profile.txt"):
    """Where a warm query's time goes: torch.profiler over one run of
    each (name, context, query); prints the device-busy share of the wall
    time and the device time of the top operations (full tables in
    chiprun_out/`out`)."""
    from torch.profiler import ProfilerActivity, profile

    tables = []
    for name, ctx, q in runs:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            t = time.perf_counter()
            ctx.sql(q)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        # device-side entries only (kernels, memcpys): an aten op's own
        # entry repeats the device time of the kernels it launched, and the
        # profiler's device-side copies of the port's spans (dft.*) are not work
        dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("dft.")]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        top = sorted(dev_events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        log(f"{phase} profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"({100 * busy / wall:.1f}%); top device ops (ms): "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}" for e in top))
        tables.append(f"== {name}: {q}\n" + events.table(sort_by="self_device_time_total", row_limit=25))
    with open(os.path.join(ROOT, "chiprun_out", out), "w") as f:
        f.write("\n".join(tables))


def capture(module, name, run):
    """The arguments of every call `run()` makes to `module.name`, as
    (args, kwargs) in call order."""
    real, box = getattr(module, name), []

    def spy(*a, **kw):
        box.append((a, kw))
        return real(*a, **kw)

    spy.__dict__ = real.__dict__  # the launch counters the function keeps on itself
    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, real)
    return box


def phase_mesh(dev, big, arrays, kernel_stats):
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.ops.pallas import segreduce as sr
    from datafusion_tpu_torch.parallel import shuffle as sh

    k, d, lat, lng, g, mode = arrays
    table = mesh_table(port, big, mode)
    mesh = port.make_mesh(8)
    check(mesh.device.type == "cuda", "make_mesh() is not on the card")
    ctx = port.ExecutionContext(mesh=mesh)
    single = port.ExecutionContext()
    ctx.register_table("big", table)
    single.register_table("big", table)
    queries = MESH_QUERIES
    for name, q, note in queries:
        check(note in ctx.sql(f"EXPLAIN VERBOSE {q}").result_str(), f"{name} does not route to {note}")

    counters = {"fused_stage": (fs.run_fused, "launches"), "segreduce_sorted": (sr.segmented_reduce, "sorted_launches"),
                "segreduce_dense": (sr.segmented_reduce, "dense_launches"),
                "ragged_exchange": (rs.ragged_exchange, "launches"),
                "ragged_exchange_fold": (rs.ragged_exchange_fold, "launches")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    results, walls, per_query = {}, {}, {}
    for name, q, _ in queries:
        before = {c: getattr(f, a) for c, (f, a) in counters.items()}
        t = time.perf_counter()
        results[name] = ctx.sql(q)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) * 1e3
        per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
    launches = {c: getattr(f, a) for c, (f, a) in counters.items()}
    for name in ("m6", "m7"):
        check(per_query[name]["ragged_exchange"] > 0, f"{name} did not launch K5")
    for name in ("m3", "m4"):
        check(per_query[name]["ragged_exchange_fold"] > 0, f"{name} did not launch K6")
    check(per_query["m1"]["fused_stage"] > 0 and per_query["m2"]["segreduce_dense"] > 0,
          "m1 / m2 did not launch K1 / K2 dense")
    # K2 sorted: one launch per shard's partials plus one for the merge
    check(per_query["m5"]["segreduce_sorted"] == 9, f"m5 made {per_query['m5']['segreduce_sorted']} K2 sorted launches")

    def cols(res):
        return [c for c, _ in res.cols]

    def same(got, want, name, floats=()):
        """Column for column; the float SUM / AVG columns at rtol 1e-9."""
        check(len(got) == len(want), f"{name}: column count")
        for j, (a, b) in enumerate(zip(got, want)):
            ok = (np.allclose(a, b, rtol=1e-9, atol=0) if j in floats
                  else a.shape == b.shape and np.array_equal(a, b))
            check(ok, f"{name}: column {j} differs")

    def by_key(res):
        c = cols(res)
        order = np.argsort(c[0], kind="stable")
        return [x[order] for x in c]

    # the numpy oracle
    m1 = lat > 57.9
    same(cols(results["m1"]), [k[m1], lat[m1], lng[m1], lat[m1] + lng[m1]], "m1")
    cnt7 = np.bincount(mode, minlength=7)
    mmin = np.full(7, np.inf)
    np.minimum.at(mmin, mode, lat)
    same(cols(results["m2"]), [np.arange(7), np.bincount(mode, weights=lng, minlength=7),
                               np.bincount(mode, weights=lat, minlength=7) / cnt7, mmin, cnt7], "m2", (1, 2))
    gkeys = np.arange(1, 10_001)
    gcnt = np.bincount(g, minlength=10_001)[1:]
    gmin, gmax = np.full(10_001, np.inf), np.full(10_001, -np.inf)
    np.minimum.at(gmin, g, lat)
    np.maximum.at(gmax, g, lng)
    same(by_key(results["m3"]), [gkeys, np.bincount(g, weights=lng, minlength=10_001)[1:],
                                 np.bincount(g, weights=lat, minlength=10_001)[1:] / gcnt, gmin[1:], gmax[1:], gcnt],
         "m3", (1, 2))
    m4 = lat > 51.0
    g4min = np.full(10_001, np.inf)
    np.minimum.at(g4min, g[m4], lat[m4])
    c4 = np.bincount(g[m4], minlength=10_001)
    present = np.flatnonzero(c4)
    same(by_key(results["m4"]), [present, g4min[present], c4[present]], "m4")
    kcnt = np.bincount(k, minlength=65536)
    kp = np.flatnonzero(kcnt)
    same(by_key(results["m5"]), [kp, np.bincount(k, weights=lng, minlength=65536)[kp], kcnt[kp]], "m5", (1,))
    o6 = np.lexsort((lat, d, k))[:10_000]
    same(cols(results["m6"]), [k[o6], d[o6], lat[o6]], "m6")
    o7 = np.argsort(lat, kind="stable")[:5000]
    same(cols(results["m7"]), [lat[o7], g[o7]], "m7")
    o8 = np.argsort(-lat, kind="stable")[:10]
    same(cols(results["m8"]), [k[o8], lat[o8]], "m8")
    ORACLE_HELD.update({name: results[name].result_str() for name, _, _ in queries})  # for phase 14
    # the single-card context, the same queries
    floats = {"m2": (1, 2), "m3": (1, 2), "m5": (1,)}
    for name, q, _ in queries:
        want = single.sql(q)
        if name in ("m3", "m4", "m5"):
            same(by_key(results[name]), by_key(want), f"{name} vs one card", floats.get(name, ()))
        else:
            same(cols(results[name]), cols(want), f"{name} vs one card", floats.get(name, ()))

    runs = [(name, ctx, q) for name, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 6 mesh: m1-m8 over 8 logical shards match the numpy oracle and the single-card context; "
        "wall ms first " + json.dumps({n: round(v, 3) for n, v in walls.items()}) + " warm (median of 5) "
        + json.dumps({n: round(v, 3) for n, v in warm.items()}) + f"; launches per query {json.dumps(per_query)}")
    profile_queries(runs, "phase 6", "profile_mesh.txt")

    # K1 at m1's shard shape: each of its launches (one per shard) timed
    calls = capture(fs, "run_fused", lambda: ctx.sql(queries[0][1]))
    check(len(calls) == per_query["m1"]["fused_stage"], "m1's K1 calls")
    rows = []
    for (prog1, ind, inv, n1, dev1), _ in calls:
        call1 = lambda: fs.run_fused(prog1, ind, inv, n1, dev1)  # noqa: E731
        rows.append((n1, time_ms(call1), kernel_only_ms(call1, "fused_stage_kernel"), host_only_ms(call1),
                     program_bytes(prog1, (ind, inv), n1) / hbm_bytes_per_s() * 1e3))
    log(f"phase 6 K1 at m1's shard shape, {len(rows)} launches, {len(prog1.code)} instructions over "
        f"{prog1.n_regs} registers: " + "; ".join(
            f"{n1} rows: event {ms:.3f} / kernel {km:.3f} / host {hm:.3f} ms, bound {bd:.3f}"
            for n1, ms, km, hm, bd in rows)
        + f"; sums: event {sum(r[1] for r in rows):.3f}, kernel {sum(r[2] for r in rows):.3f}, "
        f"bound {sum(r[4] for r in rows):.3f} ms")

    # K5 and K6 timed on the inputs the main path gave them (m6, m3)
    (a5, kw5) = capture(sh, "ragged_exchange", lambda: ctx.sql(queries[5][1]))[-1]
    check(kw5.pop("cards") is None, "one card's mesh passed cards to K5")  # the plain version takes none
    sends, sizes = a5
    n_dev, split_cap, chunk = kw5["n_dev"], kw5["split_cap"], kw5["chunk"]
    stacked = [torch.stack([s_[a] for s_ in sends]) for a in range(len(sends[0]))]
    kernel_stats["ragged_exchange"].update(
        launches=launches["ragged_exchange"],
        ms=time_ms(lambda: rs.ragged_exchange(sends, sizes, **kw5)),
        kernel_ms=kernel_only_ms(lambda: rs.ragged_exchange(sends, sizes, **kw5), "ragged_exchange_kernel"),
        host_ms=host_only_ms(lambda: rs.ragged_exchange(sends, sizes, **kw5)),
        plain_ms=time_ms(lambda: rs.ragged_exchange_plain(sends, sizes, **kw5), reps=3),
        bound_ms=k5_bytes(sends, sizes, chunk) / hbm_bytes_per_s() * 1e3,
        ops_bound_ms=0.0,
        # the fixed-slab all-to-all of the padded send buffers
        library_ms=time_ms(lambda: [x.view(n_dev, n_dev, split_cap).transpose(0, 1).contiguous() for x in stacked]),
    )
    del stacked
    copies = host_copies(lambda: rs.ragged_exchange(sends, sizes, **kw5))
    check(not copies, f"K5's wrapper copied host memory to the device: {copies}")
    s5 = kernel_stats["ragged_exchange"]
    log(f"phase 6 K5 at m6's shape against the padded transpose, same run: event {s5['ms']:.3f} ms, kernel only "
        f"{s5['kernel_ms']:.3f} ms, library {s5['library_ms']:.3f} ms (library / event "
        f"{s5['library_ms'] / s5['ms']:.3f}); K5 {'loses' if s5['ms'] > s5['library_ms'] else 'does not lose'}")
    (a6, kw6) = capture(sh, "ragged_exchange_fold", lambda: ctx.sql(queries[2][1]))[-1]
    check(kw6.pop("cards") is None and kw6.pop("agree") is None, "one card's mesh passed cards or agree to K6")
    gids, vals, masks, sizes6 = a6
    L_, S_ = kw6["num_groups"], kw6["split_cap"]
    ops6 = kw6["ops"]
    # the yardstick's rows: every routed row, by global slot i * L_ + window
    sz6 = sizes6.tolist()
    per_op = [[None if u == 0 else masks[j][u - 1] for u in kw6["mask_map"]] for j in range(n_dev)]
    parts = []
    for j in range(n_dev):
        for i in range(n_dev):
            span = slice(i * S_, i * S_ + sz6[j][i])
            parts.append(fold_rows(gids[j][span], [None if v is None else v[span] for v in vals[j]],
                                   [None if m is None else m[span] for m in per_op[j]], L_, offset=i * L_))
    rows6 = [(torch.cat([p[a][0] for p in parts]), None if vals[0][a] is None else torch.cat([p[a][1] for p in parts]))
             for a in range(len(ops6))]
    del parts
    call6 = lambda: rs.ragged_exchange_fold(gids, vals, masks, sizes6, **kw6)  # noqa: E731
    kms6, first6 = fold_kernel_ms(call6, "ragged_exchange_fold_kernel",
                                  sr.fold_launches(sr.fold_widths(ops6, vals[0]), L_), "ragged_scale_kernel", ops6,
                                  vals[0])
    kernel_stats["ragged_exchange_fold"].update(
        launches=launches["ragged_exchange_fold"],
        ms=time_ms(call6),
        kernel_ms=kms6,
        first_pass_ms=first6,
        host_ms=host_only_ms(call6),
        plain_ms=time_ms(lambda: rs.ragged_exchange_fold_plain(gids, vals, masks, sizes6, **kw6), reps=3),
        bound_ms=k6_bytes(gids, vals, masks, sizes6, L_, len(ops6)) / hbm_bytes_per_s() * 1e3,
        ops_bound_ms=len(ops6) * int(sizes6.sum()) / F32_OPS_PER_S * 1e3,
        library_ms=library_ms(rows6, ops6, n_dev * L_, dev),
        library=LIBRARY + ", over the routed rows by global slot",
    )
    del rows6
    s6 = kernel_stats["ragged_exchange_fold"]
    log(f"phase 6 K6 at m3's shape: {int(sizes6.sum())} routed rows, {L_} slots x {n_dev} receivers, ops {ops6}: "
        f"event {s6['ms']:.3f} ms, kernel only {s6['kernel_ms']:.3f} ms (torch.profiler; the first pass "
        f"{s6['first_pass_ms']:.3f})")

    # K2 dense at m2's per-shard shape: the last shard's call
    from datafusion_tpu_torch.parallel import dist

    a2, kw2 = capture(dist, "segmented_reduce", lambda: ctx.sql(queries[1][1]))[-1]
    gid2, vals2, masks2 = a2
    call2 = lambda: sr.segmented_reduce(gid2, vals2, masks2, **kw2)  # noqa: E731
    ms2 = time_ms(call2)
    kms2, first2 = fold_kernel_ms(call2, "seg_dense", sr.fold_launches(sr.fold_widths(kw2["ops"], vals2),
                                                                       kw2["num_groups"]),
                                  "fold_scale_kernel", kw2["ops"], vals2)
    lib2 = library_ms(fold_rows(gid2, vals2, masks2, kw2["num_groups"]), kw2["ops"], kw2["num_groups"], dev)
    bound2 = k2_bytes(gid2, vals2, masks2, kw2["num_groups"], kw2["ops"]) / hbm_bytes_per_s() * 1e3
    log(f"phase 6 K2 dense at m2's shard shape: {gid2.numel()} rows, {kw2['num_groups']} slots, ops {kw2['ops']}, "
        f"{len(sr.fold_launches(sr.fold_widths(kw2['ops'], vals2), kw2['num_groups']))} launch(es): event "
        f"{ms2:.3f} ms, kernel only {kms2:.3f} ms (the first pass {first2:.3f}), bound {bound2:.3f} ms, library "
        f"{lib2:.3f} ms ({LIBRARY}); m2 launched it "
        f"{per_query['m2']['segreduce_dense']} times")


PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")  # TPC-H o_orderpriority
PREFIX = 1 << 20  # rows of the row-order case


def join_arrays(n=N, seed=SEED + 7):
    """Phase 7's columns as numpy arrays, from the seed. `o`, lineitem's
    l_orderkey for big's n rows: dbgen's sparse keys (order i's key is
    (i // 8) * 32 + i % 8 + 1, so 8 of every 32 keys are used, TPC-H
    4.2.3) with 1-7 lines an order; about 1/16 of the orders get no line.
    `line_order` is each line's order index; orders holds every order up
    to the one the cut at n rows falls in."""
    rng = np.random.default_rng(seed)
    m = int(n / 3.5) + 64
    lines = rng.integers(1, 8, m)
    lines[rng.random(m) < 1 / 16] = 0
    ends = np.cumsum(lines)
    m = int(np.searchsorted(ends, n)) + 1
    lines = lines[:m]
    lines[-1] -= int(ends[m - 1]) - n
    idx = np.arange(m)
    keys = ((idx // 8) * 32 + idx % 8 + 1).astype(np.int32)
    line_order = np.repeat(idx, lines)
    return {
        "o": keys[line_order], "line_order": line_order,
        "o_orderkey": keys, "o_totalprice": np.round(rng.uniform(857.71, 555285.16, m), 2),
        "o_orderpriority": rng.integers(0, len(PRIORITIES), m).astype(np.int32),
        "s_suppkey": np.arange(1, 10_001, dtype=np.int32),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, 10_000), 2),  # about 9% negative
        "pk": np.arange(1000, dtype=np.int32), "w": rng.random(1000),
    }


def join_tables(port, big, ja, dev):
    """Phase 7's tables on the card: big plus `o` (phase 4's columns, no
    copy), orders, supplier and dim."""
    P = port.DataType

    def col(dt, a, vocab=None):
        return port.Column(dt, torch.from_numpy(a).to(dev), None, vocab)

    def table(fields, cols):
        return port.Table(port.Schema([port.Field(f, c.dtype, False) for f, c in zip(fields, cols)]), tuple(cols),
                          cols[0].data.shape[0])

    bigo = port.Table(port.Schema(list(big.schema.fields) + [port.Field("o", P.Int32, False)]),
                      big.columns + (col(P.Int32, ja["o"]),), big.num_rows)
    orders = table(("o_orderkey", "o_totalprice", "o_orderpriority"),
                   [col(P.Int32, ja["o_orderkey"]), col(P.Float64, ja["o_totalprice"]),
                    col(P.Utf8, ja["o_orderpriority"], PRIORITIES)])
    supplier = table(("s_suppkey", "s_acctbal"), [col(P.Int32, ja["s_suppkey"]), col(P.Float64, ja["s_acctbal"])])
    dim = table(("pk", "w"), [col(P.Int32, ja["pk"]), col(P.Float64, ja["w"])])
    return {"big": bigo, "orders": orders, "supplier": supplier, "dim": dim}


# phase 7's queries: (name, SQL, what EXPLAIN VERBOSE must show)
JOIN_QUERIES = (
    ("j1", "SELECT big.k, COUNT(big.lat), MAX(dim.w) FROM big JOIN dim ON big.k = dim.pk WHERE big.lat > 53 "
     "GROUP BY k", ("join: direct", "dense sort-free group-by (int[0,999])")),
    ("j2", "SELECT o_orderpriority, COUNT(big.lat), SUM(big.lat) FROM orders LEFT JOIN big "
     "ON orders.o_orderkey = big.o GROUP BY o_orderpriority", ("join: direct", "sort (stable build sort",
                                                              "dense sort-free")),
    ("j3", "SELECT COUNT(*), SUM(lat) FROM big WHERE g NOT IN (SELECT s_suppkey FROM supplier WHERE s_acctbal < 0)",
     ("Join: type=Left", "join: sort (")),
)
MESH_JOIN_QUERIES = (
    ("m9", JOIN_QUERIES[0][1], ("join: broadcast", "local direct", "dense sort-free group-by per shard (int[0,999])")),
    ("m10", JOIN_QUERIES[1][1], ("join: shuffle", "dense sort-free group-by per shard")),
)
JOIN_OPS = ("aten::sort", "aten::searchsorted", "aten::repeat_interleave", "aten::index", "aten::bincount",
            "aten::nonzero", "ragged_exchange")


def profile_joins(runs):
    """torch.profiler over one warm run of each (name, context, query):
    device-busy ms of the wall, the largest device operations, and the
    device time under each of the join's own operations (JOIN_OPS: the
    build sort, searchsorted, repeat_interleave, the gathers, the direct
    join's bincount, compaction, and K5's exchange); full tables in
    chiprun_out/profile_joins.txt."""
    from torch.profiler import ProfilerActivity, profile

    tables, out = [], {}
    for name, ctx, q in runs:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            t = time.perf_counter()
            ctx.sql(q)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        dev_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.key.startswith("dft.")]  # the port's spans' device-side copies are not work
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        top = sorted(dev_events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        ops = {}
        for e in events:
            for op in JOIN_OPS:
                if e.key.startswith(op) or (op == "ragged_exchange" and op in e.key and e in dev_events):
                    total = getattr(e, "device_time_total", 0) if e not in dev_events else e.self_device_time_total
                    ops[op] = round(ops.get(op, 0.0) + total / 1e3, 3)
        out[name] = {"wall_ms": round(wall, 3), "device_busy_ms": round(busy, 3), "join_ops_ms": ops}
        log(f"phase 7 profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); "
            f"top device ops (ms): " + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f}" for e in top)
            + f"; join ops (device ms) {json.dumps(ops)}")
        tables.append(f"== {name}: {q}\n" + events.table(sort_by="self_device_time_total", row_limit=30))
    with open(os.path.join(ROOT, "chiprun_out", "profile_joins.txt"), "w") as f:
        f.write("\n".join(tables))
    return out


def phase_joins(dev, big, arrays, kernel_stats):
    """Phase 7: joins at 2^25 rows on one card and over the mesh."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    k, _d, lat, _lng, g, _mode = arrays
    t0 = time.perf_counter()
    ja = join_arrays()
    tables = join_tables(port, big, ja, dev)
    torch.cuda.synchronize()
    log(f"phase 7 tables: big + o ({N} rows), orders {ja['o_orderkey'].shape[0]} rows "
        f"({int((np.bincount(ja['line_order'], minlength=ja['o_orderkey'].shape[0]) == 0).sum())} without lines), "
        f"supplier 10000, dim 1000; made in {time.perf_counter() - t0:.2f} s")
    single = port.ExecutionContext()
    mesh = port.ExecutionContext(mesh=port.make_mesh(8))
    for c_ in (single, mesh):
        for name, t in tables.items():
            c_.register_table(name, t)
    queries = [(n, single, q, notes) for n, q, notes in JOIN_QUERIES] + [
        (n, mesh, q, notes) for n, q, notes in MESH_JOIN_QUERIES]
    routes = {}
    for name, c_, q, notes in queries:
        txt = c_.sql(f"EXPLAIN VERBOSE {q}").result_str()
        for note in notes:
            check(note in txt, f"{name} does not route to {note}")
        routes[name] = [line[len("physical: "):] for line in txt.splitlines() if line.startswith("physical: join")]

    counters = {"fused_stage": (fs.run_fused, "launches"), "segreduce_sorted": (sr.segmented_reduce, "sorted_launches"),
                "segreduce_dense": (sr.segmented_reduce, "dense_launches"),
                "slab_partition": (pt.slab_partition, "launches"), "windowed_reduce": (pt.windowed_reduce, "launches"),
                "ragged_exchange": (rs.ragged_exchange, "launches"),
                "ragged_exchange_fold": (rs.ragged_exchange_fold, "launches")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    results, walls, per_query, taken = {}, {}, {}, {}
    for name, c_, q, _ in queries:
        before = {c: getattr(f, a) for c, (f, a) in counters.items()}
        t = time.perf_counter()
        results[name] = c_.sql(q)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) * 1e3
        per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
        taken[name] = sorted(set(results[name].routes))
    launches = {c: getattr(f, a) for c, (f, a) in counters.items()}
    check(per_query["j1"]["segreduce_dense"] == 1, f"j1 made {per_query['j1']['segreduce_dense']} K2 dense launches")
    check(per_query["m9"]["segreduce_dense"] == 8, f"m9 made {per_query['m9']['segreduce_dense']} K2 dense launches")
    check(per_query["j2"]["segreduce_dense"] >= 1 and per_query["m10"]["segreduce_dense"] >= 1, "j2 / m10 K2 dense")
    check(per_query["m10"]["ragged_exchange"] >= 2, f"m10 made {per_query['m10']['ragged_exchange']} K5 launches")
    check(taken["j1"] == ["join: direct"] and taken["j2"] == ["join: sort"] and taken["j3"] == ["join: sort"],
          f"single-card routes taken {taken}")
    check(taken["m9"] == ["join: direct"] and "join: shuffle, skew salt 1" in taken["m10"],
          f"mesh routes taken {taken}")

    def cols(res):
        return [c for c, _ in res.cols]

    def same(got, want, name, floats=()):
        check(len(got) == len(want), f"{name}: column count")
        for j, (a, b) in enumerate(zip(got, want)):
            ok = (np.allclose(a, b, rtol=1e-9, atol=0) if j in floats
                  else a.shape == b.shape and np.array_equal(a, b))
            check(ok, f"{name}: column {j} differs")

    def by_key(res):
        c = cols(res)
        order = np.argsort(c[0], kind="stable")
        return [x[order] for x in c]

    # the numpy oracle: exact keys, counts, MIN / MAX; f64 sums at rtol 1e-9
    m1 = (lat > 53) & (k < 1000)
    kc = np.bincount(k[m1], minlength=1000)
    kp = np.flatnonzero(kc)
    j1_want = [kp, kc[kp], ja["w"][kp]]
    same(by_key(results["j1"]), j1_want, "j1")
    same(by_key(results["m9"]), j1_want, "m9")
    prio_line = ja["o_orderpriority"][ja["line_order"]]
    j2_want = [np.arange(len(PRIORITIES)), np.bincount(prio_line, minlength=len(PRIORITIES)),
               np.bincount(prio_line, weights=lat, minlength=len(PRIORITIES))]
    for name in ("j2", "m10"):
        check(results[name].column_values(0) == list(PRIORITIES), f"{name} keys")
        same(by_key(results[name]), j2_want, name, (2,))
    same(by_key(results["m10"]), by_key(results["j2"]), "m10 vs one card", (2,))
    ORACLE_HELD["m10"] = results["m10"].result_str()
    keep = ~np.isin(g, ja["s_suppkey"][ja["s_acctbal"] < 0])
    same(cols(results["j3"]), [np.array([keep.sum()]), np.array([lat[keep].sum()])], "j3", (1,))

    # row order: no GROUP BY, over a 2^20-row prefix; orders' keys are
    # unique and dense enough, so the ladder ends in the swapped direct
    # join and the rows come in big's order
    n_ord = int(ja["line_order"][PREFIX - 1]) + 1
    pre = port.ExecutionContext()
    for name, t, rows in (("big", tables["big"], PREFIX), ("orders", tables["orders"], n_ord)):
        pre.register_table(name, port.Table(t.schema, tuple(port.Column(c.dtype, c.data[:rows], None, c.dictionary)
                                                            for c in t.columns), rows))
    q_order = ("SELECT o_orderkey, o_totalprice, big.lat FROM orders JOIN big ON orders.o_orderkey = big.o")
    res = pre.sql(q_order)
    check(res.routes == ("join: direct (swapped: build=left side)",), f"row-order case took {res.routes}")
    lo = ja["line_order"][:PREFIX]
    same(cols(res), [ja["o"][:PREFIX], ja["o_totalprice"][lo], lat[:PREFIX]], "row-order case")

    runs = [(name, c_, q) for name, c_, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 7 joins: j1-j3, m9 and m10 match the numpy oracle (m10 also the single card's j2), the row-order case "
        f"({PREFIX} rows) took the swapped direct join in big's order; EXPLAIN routes {json.dumps(routes)}; "
        f"routes taken {json.dumps(taken)}; wall ms first " + json.dumps({n: round(v, 3) for n, v in walls.items()})
        + " warm (median of 5) " + json.dumps({n: round(v, 3) for n, v in warm.items()})
        + f"; launches per query {json.dumps(per_query)}")
    profiles = profile_joins(runs)
    for name, s_ in kernel_stats.items():
        s_["join_launches"] = launches[name]
    return {"warm_ms": warm, "profiles": profiles, "launches": per_query, "tables": tables}


# phase 8's queries: (name, SQL, what EXPLAIN VERBOSE must show). w1-w3,
# u2 and u3 run in a single-card context, u1 in a bigdense one, m11-m14
# over 8 shards
WINDOW_QUERIES = (
    ("w1", "SELECT d, k, lat, rn FROM (SELECT d, k, lat, ROW_NUMBER() OVER (PARTITION BY d ORDER BY lat DESC) AS rn "
     "FROM big) q WHERE rn <= 3 ORDER BY d, rn", ("window: 1 function(s) over 1 spec sort(s) (stable sort passes per "
                                                  "spec: 2)",)),
    ("w2", "SELECT d, MAX(rs), SUM(dl) FROM (SELECT d, SUM(lng) OVER (PARTITION BY d ORDER BY k) AS rs, "
     "lat - LAG(lat) OVER (PARTITION BY d ORDER BY k) AS dl FROM big WHERE g <= 5000) q GROUP BY d",
     ("window: 2 function(s) over 1 spec sort(s) (stable sort passes per spec: 1)", "co-sort + segmented reduce")),
    ("w3", "SELECT COUNT(*), SUM(lat - a), MAX(mx - lat) FROM (SELECT lat, AVG(lat) OVER (PARTITION BY g) AS a, "
     "MAX(lat) OVER (PARTITION BY g) AS mx FROM big) q", ("2 whole-partition aggregate(s) on K2 sorted",)),
    ("u1", "SELECT mode, d, COUNT(*), SUM(lat), MIN(lng) FROM bigm GROUP BY ROLLUP(mode, d)",
     ("bigdense radix-partition sort-free group-by (dict=7 x int[0,999]", "dense sort-free group-by (dict=7)")),
    ("u2", "SELECT COUNT(*) FROM (SELECT d FROM big WHERE lat > 57 INTERSECT ALL SELECT d FROM big WHERE lng < -7.8) q",
     ("fused CUDA stage", "window: 1 function(s) over 1 spec sort(s)", "join: sort")),
    ("u3", "SELECT mode FROM bigm UNION SELECT o_orderpriority FROM orders", ("dense sort-free group-by (dict=12)",)),
)
MESH_WINDOW_QUERIES = (
    ("m11", WINDOW_QUERIES[0][1], ("window: hash-repartition by PARTITION BY keys over K5",)),
    ("m12", "SELECT lat, r FROM (SELECT lat, RANK() OVER (ORDER BY lat DESC) AS r FROM big WHERE lat > 57.99) q "
     "WHERE r <= 1000", ("window: gather to replicated, local evaluation",)),
    ("m13", WINDOW_QUERIES[3][1], ("fused ragged-exchange fold, K6", "dense sort-free group-by per shard (dict=7)",
                                   "union: partitioned inputs gathered to replicated")),
    ("m14", WINDOW_QUERIES[4][1], ("window: hash-repartition by PARTITION BY keys over K5", "join: shuffle")),
)
U = 2.0 ** -53  # f64 unit roundoff


def window_oracle(arrays, ja):
    """Phase 8's answers from numpy: exact keys, counts, ranks and MIN /
    MAX; sums in long double, partition by partition, with their rounding
    bounds."""
    k, d, lat, lng, g, mode = arrays
    out = {}

    def by(keys, rows=None):
        """`rows` (default: all) stably ordered by `keys` (most significant
        first, each below 2^16: numpy's stable sort is a radix sort there)."""
        rows = np.arange(N) if rows is None else rows
        for key in reversed(keys):
            rows = rows[np.argsort(key[rows].astype(np.uint16), kind="stable")]
        return rows

    # w1: top 3 lat per d, ties in row order: among the rows above a
    # threshold that leaves every d at least 3
    thr = 57.9
    while np.bincount(d[lat > thr], minlength=1000).min() < 3:
        thr -= 1.0
    cand = np.flatnonzero(lat > thr)
    o = cand[np.argsort(-lat[cand], kind="stable")]
    o = o[np.argsort(d[o], kind="stable")]
    starts = np.flatnonzero(np.r_[True, d[o][1:] != d[o][:-1]])
    top = (starts[:, None] + np.arange(3)).ravel()
    out["w1"] = [d[o][top], k[o][top], lat[o][top], np.tile(np.arange(1, 4), len(starts))]
    # w2: rows with g <= 5000 by (d, k), ties in row order
    rows = by([d, k], np.flatnonzero(g <= 5000))
    ds = d[rows]
    bounds = np.r_[np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]]), len(rows)]
    mx, dl_sum, dl_tol = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        mx.append(np.cumsum(lng[rows[a:b]].astype(np.longdouble)).max())
        dl = np.diff(lat[rows[a:b]])
        dl_sum.append(dl.astype(np.longdouble).sum())
        dl_tol.append(max(len(dl) - 1, 0) * U * np.abs(dl).sum())  # an f64 sum of m terms in any order
    out["w2"] = [ds[bounds[:-1]], np.array(mx), np.array(dl_sum), np.array(dl_tol),
                 len(rows) * np.abs(lng[rows]).max() * 2.0**-52]
    # w3: per-g mean and max of lat
    og = by([g])
    gs = np.flatnonzero(np.r_[True, g[og][1:] != g[og][:-1]])
    cnt = np.diff(np.r_[gs, N])
    mean = np.add.reduceat(lat[og].astype(np.longdouble), gs) / cnt
    gmax = np.maximum.reduceat(lat[og], gs)
    dev_abs = np.abs(lat[og] - np.repeat(mean, cnt).astype(np.float64)).sum()
    # SUM(lat - a) is 0 but for rounding: each AVG within m_g u max|lat|,
    # each difference within u |lat - a|, their sum within N u sum|lat - a|
    out["w3"] = [N, (gmax - np.minimum.reduceat(lat[og], gs)).max(),
                 U * (float((cnt.astype(np.float64) ** 2).sum()) * np.abs(lat).max() + (N + 1) * dev_abs)]
    # u1: ROLLUP(mode, d)
    key = mode.astype(np.int64) * 1000 + d
    c = np.bincount(key, minlength=7000)
    s_ = np.bincount(key, weights=lat, minlength=7000)
    ok = by([key])
    ks = np.flatnonzero(np.r_[True, key[ok][1:] != key[ok][:-1]])
    mn = np.full(7000, np.inf)
    mn[key[ok][ks]] = np.minimum.reduceat(lng[ok], ks)
    roll = {}
    for m_ in range(7):
        for d_ in range(1000):
            j = m_ * 1000 + d_
            if c[j]:
                roll[(SHIPMODES[m_], d_)] = (c[j], s_[j], mn[j])
        sl = slice(m_ * 1000, (m_ + 1) * 1000)
        roll[(SHIPMODES[m_], None)] = (c[sl].sum(), s_[sl].sum(), mn[sl].min())
    roll[(None, None)] = (N, lat.sum(), lng.min())
    out["u1"] = roll
    # u2: INTERSECT ALL of the two sides' d multisets
    out["u2"] = int(np.minimum(np.bincount(d[lat > 57], minlength=1000), np.bincount(d[lng < -7.8], minlength=1000)).sum())
    out["u3"] = sorted(set(SHIPMODES) | {PRIORITIES[i] for i in np.unique(ja["o_orderpriority"])})
    # m12: the 1000 largest lat above 57.99, ranked
    big_lat = np.sort(lat[lat > 57.99])[::-1][:1000]
    out["m12"] = big_lat
    return out


def check_window_results(name, res, want):
    """`res` (a ResultTable) against the oracle's `want` for query `name`."""
    cols = [c for c, _ in res.cols]
    if name in ("w1", "m11"):
        check(len(cols[0]) == len(want[0]) and all(np.array_equal(a, b) for a, b in zip(cols, want)),
              f"{name} differs from the oracle")
    elif name == "w2":
        keys, mx, dl, dl_tol, atol = want
        order = np.argsort(cols[0], kind="stable")
        got = [c[order] for c in cols]
        check(np.array_equal(got[0], keys), "w2 keys")
        err = np.abs(got[1].astype(np.longdouble) - mx)
        check(np.all(err <= atol + 1e-12 * np.abs(mx)), f"w2 MAX(rs) off by {float(err.max())} (atol {atol})")
        err = np.abs(got[2].astype(np.longdouble) - dl)
        check(np.all(err <= dl_tol + 1e-12 * np.abs(dl)), f"w2 SUM(dl) off by {float(err.max())}")
    elif name == "w3":
        n, spread, tol = want
        check(cols[0][0] == n, "w3 COUNT")
        check(abs(cols[1][0]) <= tol, f"w3 SUM(lat - a) = {cols[1][0]} beyond its bound {tol}")
        check(cols[2][0] == spread, "w3 MAX(mx - lat)")
    elif name in ("u1", "m13"):
        modes = res.column_values(0)
        d_ = cols[1]
        dv = res.cols[1][1]
        got = {}
        for i, m_ in enumerate(modes):
            got[(m_, None if (dv is not None and not dv[i]) else int(d_[i]))] = (cols[2][i], cols[3][i], cols[4][i])
        check(got.keys() == want.keys(), f"{name}: {len(got)} groups, {len(want)} expected")
        for key_, (c_, s_, m_) in want.items():
            gc, gs_, gm = got[key_]
            check(gc == c_ and gm == m_ and abs(gs_ - s_) <= 1e-9 * abs(s_), f"{name} group {key_}")
    elif name in ("u2", "m14"):
        check(int(cols[0][0]) == want, f"{name}: {cols[0][0]} rows, {want} expected")
    elif name == "u3":
        check(res.column_values(0) == want, f"u3: {res.column_values(0)}")
    elif name == "m12":
        order = np.argsort(cols[1], kind="stable")
        check(np.array_equal(cols[0][order], want) and np.array_equal(cols[1][order], np.arange(1, len(want) + 1)),
              "m12 differs from the oracle")


def phase_windows(dev, big, arrays, tables, kernel_stats):
    """Phase 8: windows, UNION, grouping sets and INTERSECT ALL at 2^25
    rows on one card and over the mesh."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.ops import window as window_ops
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    t0 = time.perf_counter()
    bigm = mesh_table(port, big, arrays[5])
    want = window_oracle(arrays, join_arrays())
    log(f"phase 8 tables: big, bigm (big + mode), orders; numpy oracle in {time.perf_counter() - t0:.2f} s")
    single, dense = port.ExecutionContext(), port.ExecutionContext(bigdense=True)
    mesh = port.ExecutionContext(mesh=port.make_mesh(8))
    for c_ in (single, dense, mesh):
        for name, t in (("big", big), ("bigm", bigm), ("orders", tables["orders"])):
            c_.register_table(name, t)
    queries = [(n, dense if n == "u1" else single, q, notes) for n, q, notes in WINDOW_QUERIES] + [
        (n, mesh, q, notes) for n, q, notes in MESH_WINDOW_QUERIES]
    routes = {}
    for name, c_, q, notes in queries:
        txt = c_.sql(f"EXPLAIN VERBOSE {q}").result_str()
        for note in notes:
            check(note in txt, f"{name} does not route to {note}")
        routes[name] = [ln[len("physical: "):] for ln in txt.splitlines() if ln.startswith("physical: ")]

    counters = {"fused_stage": (fs.run_fused, "launches"), "segreduce_sorted": (sr.segmented_reduce, "sorted_launches"),
                "segreduce_dense": (sr.segmented_reduce, "dense_launches"),
                "slab_partition": (pt.slab_partition, "launches"), "windowed_reduce": (pt.windowed_reduce, "launches"),
                "ragged_exchange": (rs.ragged_exchange, "launches"),
                "ragged_exchange_fold": (rs.ragged_exchange_fold, "launches")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    results, walls, per_query, taken = {}, {}, {}, {}
    for name, c_, q, _ in queries:
        before = {c: getattr(f, a) for c, (f, a) in counters.items()}
        t = time.perf_counter()
        results[name] = c_.sql(q)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) * 1e3
        per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
        taken[name] = sorted(set(results[name].routes))
    launches = {c: getattr(f, a) for c, (f, a) in counters.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on phase 8's path")
    check(per_query["w3"]["segreduce_sorted"] == 1, f"w3 made {per_query['w3']['segreduce_sorted']} K2 sorted launches")
    check(per_query["u1"]["slab_partition"] >= 1 and per_query["u1"]["windowed_reduce"] >= 1
          and per_query["u1"]["segreduce_dense"] >= 1, f"u1 launches {per_query['u1']}")
    check(per_query["m11"]["ragged_exchange"] >= 1, f"m11 made {per_query['m11']['ragged_exchange']} K5 launches")
    check(per_query["m13"]["ragged_exchange_fold"] >= 1, "m13 did not launch K6")
    for name, _, _, _ in queries:
        check_window_results(name, results[name], want["m12" if name == "m12" else {"m11": "w1", "m13": "u1",
                                                                                    "m14": "u2"}.get(name, name)])
    ORACLE_HELD["m11"] = results["m11"].result_str()
    # w3's K2 sorted call against its plain version, on the same inputs
    box = capture(window_ops, "segmented_reduce", lambda: single.sql(WINDOW_QUERIES[2][1]))
    (args, kw), = box
    kern = sr.segmented_reduce(*args, **kw)
    plain = sr.segmented_reduce_plain(*args, **kw)
    for op, a, b in zip(kw["ops"], kern, plain):
        ok = torch.allclose(a, b, rtol=1e-9, atol=0) if op == "sum" else torch.equal(a, b)
        check(ok, f"w3's K2 sorted {op} differs from its plain version")
    log(f"phase 8 w3's K2 sorted call: {args[0].numel()} rows, {kw['num_groups']} partitions, ops {kw['ops']}: "
        "kernel == plain (sums at rtol 1e-9)")

    runs = [(name, c_, q) for name, c_, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 8 windows / union: w1-w3, u1-u3, m11-m14 match the numpy oracle; EXPLAIN routes "
        + json.dumps(routes) + f"; routes taken {json.dumps(taken)}; wall ms first "
        + json.dumps({n: round(v, 3) for n, v in walls.items()}) + " warm (median of 5) "
        + json.dumps({n: round(v, 3) for n, v in warm.items()}) + f"; launches per query {json.dumps(per_query)}")
    profile_queries(runs, "phase 8", "profile_windows.txt")
    for name, s_ in kernel_stats.items():
        s_["window_launches"] = launches[name]
    return {"warm_ms": warm, "launches": per_query}


# phase 9's queries: (name, SQL, what EXPLAIN VERBOSE must show). a1-a6 run
# on one card, m15-m18 over 8 shards; geomean is the UDAF of a5
AGG_QUERIES = (
    ("a1", "SELECT d, STDDEV(lat), VARIANCE(lng), COUNT(*) FROM big GROUP BY d",
     ("dense sort-free group-by (int[0,999]); VAR/STDDEV squared deviations in a second K2 dense pass",)),
    ("a2", "SELECT g, MEDIAN(lat), PERCENTILE(lat, 0.9), PERCENTILE_DISC(lat, 0.1), COUNT(lat) FROM big GROUP BY g",
     ("packed-gid co-sort (int[1,10000]) + segmented reduce; the percentile argument rides the co-sort",)),
    ("a3", "SELECT d, COUNT(DISTINCT g), SUM(DISTINCT k), AVG(DISTINCT k) FROM big GROUP BY d",
     ("dense sort-free declined (COUNT_DISTINCT needs the sorted path)",
      "2 DISTINCT argument(s), one sort within the groups each")),
    ("a4", "SELECT COUNT(DISTINCT k), MEDIAN(lng), STDDEV_SAMP(lat) FROM big", ()),
    ("a5", "SELECT d, geomean(lat) FROM big GROUP BY d", ("dense sort-free group-by (int[0,999])",)),
    ("a6", None, ("join: ", "COUNT_DISTINCT needs the sorted path", "1 DISTINCT argument(s)")),
)
MESH_AGG_QUERIES = (
    ("m15", AGG_QUERIES[0][1], ("hash-repartition by group keys over K5",
                                "dense per shard and exchange-fold declined (STDDEV_SAMP")),
    ("m16", "SELECT mode, COUNT(DISTINCT g) FROM bigm GROUP BY mode", ("hash-repartition by group keys over K5",)),
    ("m17", "SELECT g, geomean(lat) FROM big GROUP BY g", ("fused ragged-exchange fold, K6",)),
    ("m18", AGG_QUERIES[3][1], ("aggregate: gather to replicated, local evaluation",)),
)


Q16_SCALE = 5.0  # 30M lineitem rows, 1M parts


def q16_tables(port, dev, scale):
    """TPC-H q16's columns (benchmarks/tpch.py `gen_tables`, 6M lineitem
    rows and 200K parts a unit of scale) on the card, and as numpy; only
    the columns the query reads."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from tpch import Q16ish, gen_tables

    lineitem, _, _, part = gen_tables(scale)
    P = port.DataType

    def col(dt, a, vocab=None):
        return port.Column(dt, torch.from_numpy(np.ascontiguousarray(a)).to(dev), None, vocab)

    def table(cols):
        return port.Table(port.Schema([port.Field(f, c.dtype, False) for f, c in cols.items()]),
                          tuple(cols.values()), next(iter(cols.values())).data.shape[0])

    codes = {}
    for c in ("p_brand", "p_type"):
        vocab, codes[c] = np.unique(part[c], return_inverse=True)
        codes[c + "_vocab"] = tuple(str(v) for v in vocab)
    li = {c: lineitem[c] for c in ("l_partkey", "l_suppkey", "l_quantity", "l_extendedprice")}
    pa = {"p_partkey": part["p_partkey"], "p_size": part["p_size"], "p_brand": codes["p_brand"].astype(np.int32),
          "p_type": codes["p_type"].astype(np.int32)}
    tables = {
        "lineitem": table({"l_partkey": col(P.Int32, li["l_partkey"]), "l_suppkey": col(P.Int32, li["l_suppkey"]),
                           "l_quantity": col(P.Float32, li["l_quantity"]),
                           "l_extendedprice": col(P.Float32, li["l_extendedprice"])}),
        "part": table({"p_partkey": col(P.Int32, pa["p_partkey"]), "p_brand": col(P.Utf8, pa["p_brand"],
                                                                                  codes["p_brand_vocab"]),
                       "p_type": col(P.Utf8, pa["p_type"], codes["p_type_vocab"]), "p_size": col(P.Int32, pa["p_size"])}),
    }
    return tables, Q16ish, li, pa, codes


def q16_oracle(li, pa, codes):
    """Q16ish in numpy: (brand, type, distinct suppliers) of the top 20."""
    bad = np.unique(li["l_suppkey"][(li["l_quantity"] > 49) & (li["l_extendedprice"] > 99000)])
    brands, types = codes["p_brand_vocab"], codes["p_type_vocab"]
    good = (pa["p_brand"] != brands.index("Brand#1")) & np.isin(pa["p_size"], (1, 14, 23, 45))
    rows = good[li["l_partkey"]] & ~np.isin(li["l_suppkey"], bad)
    key = pa["p_brand"][li["l_partkey"][rows]].astype(np.int64) * len(types) + pa["p_type"][li["l_partkey"][rows]]
    n_supp = int(li["l_suppkey"].max()) + 1
    pairs = np.unique(key * n_supp + li["l_suppkey"][rows])
    cnt = np.bincount(pairs // n_supp, minlength=len(brands) * len(types))
    groups = [(-int(c), brands[j // len(types)], types[j % len(types)]) for j, c in enumerate(cnt) if c]
    return [(b, t, -c) for c, b, t in sorted(groups)[:20]]


def agg_oracle(arrays):
    """Phase 9's answers from numpy: exact counts, distinct counts and
    sums of integers, percentiles by the JAX package's positions; f64
    variances by two passes and geometric means, checked at rel 1e-9."""
    k, d, lat, lng, g, mode = arrays
    out = {}
    f64 = np.float64

    def var(key, x, m):
        c = np.bincount(key, minlength=m)
        mean = np.bincount(key, weights=x, minlength=m) / np.maximum(c, 1)
        ss = np.bincount(key, weights=(x - mean[key]) ** 2, minlength=m)
        return c, ss / np.maximum(c - 1, 1)

    cd, var_lat = var(d, lat, 1000)
    _, var_lng = var(d, lng, 1000)
    out["a1"] = [np.arange(1000), np.sqrt(var_lat), var_lng, cd]
    # a2: each g's lat ascending (numpy's stable radix sort on the uint16 key)
    o = np.argsort(lat, kind="stable")
    o = o[np.argsort(g[o].astype(np.uint16), kind="stable")]
    ls = lat[o]
    cg = np.bincount(g, minlength=10_001)[1:]
    st = np.cumsum(cg) - cg

    def cont(q):
        rank = (cg - 1).astype(f64) * q
        lo, hi = np.floor(rank).astype(np.int64), np.ceil(rank).astype(np.int64)
        return ls[st + lo] + (ls[st + hi] - ls[st + lo]) * (rank - lo)

    disc = ls[st + np.minimum(np.maximum(np.ceil(cg * 0.1).astype(np.int64), 1), cg) - 1]
    out["a2"] = [np.arange(1, 10_001), cont(0.5), cont(0.9), disc, cg]
    # a3: distinct (d, g) and (d, k) pairs on bitmaps
    seen = np.zeros(1000 * 10_001, bool)
    seen[d.astype(np.int64) * 10_001 + g] = True
    dg = seen.reshape(1000, 10_001).sum(axis=1)
    seen = np.zeros(1000 * 65536, bool)
    seen[d.astype(np.int64) * 65536 + k] = True
    seen = seen.reshape(1000, 65536)
    dk = seen.sum(axis=1)
    sk = (seen * np.arange(65536, dtype=np.int64)).sum(axis=1)
    out["a3"] = [np.arange(1000), dg, sk, (sk / dk).astype(np.int32)]
    # a4: ungrouped
    n = lat.shape[0]
    mid = np.partition(lng, [n // 2 - 1, n // 2])[[n // 2 - 1, n // 2]]
    mean = lat.sum() / n
    out["a4"] = [np.array([np.unique(k).shape[0]]), np.array([mid[0] + (mid[1] - mid[0]) * 0.5]),
                 np.array([np.sqrt(((lat - mean) ** 2).sum() / (n - 1))])]
    out["a5"] = [np.arange(1000), np.exp(np.bincount(d, weights=np.log(lat), minlength=1000) / cd)]
    seen = np.zeros(7 * 10_001, bool)
    seen[mode.astype(np.int64) * 10_001 + g] = True
    out["m16"] = [np.arange(7), seen.reshape(7, 10_001).sum(axis=1)]
    out["m17"] = [np.arange(1, 10_001), np.exp(np.bincount(g, weights=np.log(lat), minlength=10_001)[1:] / cg)]
    return out


def check_agg_results(name, res, want):
    """`res` (a ResultTable) against the oracle's `want`: integer columns
    exact, float ones at rel 1e-9 (a2's percentiles within 2 ulp: the port
    fuses CONT's multiply-add, numpy does not; its DISC exact)."""
    cols = [c for c, _ in res.cols]
    if name == "a6":
        got = list(zip(res.column_values(0), res.column_values(1), (int(c) for c in cols[2])))
        check(got == want, f"a6: {got[:3]} ... against {want[:3]} ...")
        return
    if name == "m16":  # partitioned: the modes come shard by shard
        check(sorted(res.column_values(0)) == list(SHIPMODES), f"m16 keys {res.column_values(0)}")
        cols[0] = np.array([SHIPMODES.index(m_) for m_ in res.column_values(0)])
    order = np.argsort(cols[0], kind="stable")
    got = [c[order] for c in cols] if len(cols[0]) > 1 else cols
    check(len(got) == len(want) and all(len(a) == len(b) for a, b in zip(got, want)), f"{name}: shapes")
    for j, (a, b) in enumerate(zip(got, want)):
        if b.dtype.kind in "iu":
            ok = np.array_equal(a.astype(np.int64), b.astype(np.int64))
        elif name == "a2" and j in (1, 2, 3):
            ok = np.all(np.abs(a - b) <= 2 * np.spacing(np.abs(b)))
        else:
            ok = np.allclose(a, b, rtol=1e-9, atol=0)
        check(ok, f"{name}: column {j} differs from the oracle")


def phase_aggregates(dev, big, arrays, kernel_stats):
    """Phase 9: the rest of the aggregate family at 2^25 rows (a1-a5,
    m15-m18) and TPC-H q16's shape at scale 5 (a6), on one card and over
    the mesh."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops import aggregate as agg_ops
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    t0 = time.perf_counter()
    bigm = mesh_table(port, big, arrays[5])
    want = agg_oracle(arrays)
    t1 = time.perf_counter()
    q16, q16_sql, li, pa, codes = q16_tables(port, dev, Q16_SCALE)
    want["a6"] = q16_oracle(li, pa, codes)
    torch.cuda.synchronize()
    log(f"phase 9 tables: big, bigm; numpy oracle in {t1 - t0:.2f} s; q16's lineitem "
        f"{li['l_partkey'].shape[0]} rows and part {pa['p_partkey'].shape[0]} rows, made with their oracle in "
        f"{time.perf_counter() - t1:.2f} s")
    single, mesh = port.ExecutionContext(), port.ExecutionContext(mesh=port.make_mesh(8))
    geomean = port.FunctionMeta("geomean", (port.Field("x", port.DataType.Float64, False),), port.DataType.Float64,
                                port.FunctionType.Aggregate)
    for c_ in (single, mesh):
        for name, t in (("big", big), ("bigm", bigm), *q16.items()):
            c_.register_table(name, t)
        c_.register_function(geomean, port.AggregateUDF(map=torch.log, combine="sum",
                                                        finalize=lambda s, n: torch.exp(s / n)))
    queries = [(n, single, q16_sql if n == "a6" else q, notes) for n, q, notes in AGG_QUERIES] + [
        (n, mesh, q, notes) for n, q, notes in MESH_AGG_QUERIES]
    routes = explain_routes(queries)
    results, walls, per_query, launches = run_counted([q[:3] for q in queries])
    for name in ("segreduce_sorted", "segreduce_dense", "ragged_exchange", "ragged_exchange_fold"):
        check(launches[name] > 0, f"{name} was not launched on phase 9's path")
    expect = {("a1", "segreduce_dense"): 2, ("a2", "segreduce_sorted"): 1, ("a3", "segreduce_sorted"): 1,
              ("a5", "segreduce_dense"): 1, ("m15", "segreduce_sorted"): 16, ("m17", "ragged_exchange_fold"): 1}
    for (name, kern), n in expect.items():
        check(per_query[name][kern] == n, f"{name} made {per_query[name][kern]} {kern} launches, not {n}")
    check(per_query["m15"]["ragged_exchange"] >= 1 and per_query["m16"]["ragged_exchange"] >= 1,
          "m15 / m16 did not launch K5")
    check(per_query["a6"]["segreduce_sorted"] >= 1, "a6 did not launch K2 sorted")
    for name, _, _, _ in queries:
        check_agg_results(name, results[name], want[{"m15": "a1", "m17": "m17", "m18": "a4"}.get(name, name)])
    ORACLE_HELD["m15"] = results["m15"].result_str()
    # the new op lists' K2 calls against K2's plain version, on the same inputs
    for name, q, mode in (("a1", AGG_QUERIES[0][1], "dense"), ("a3", AGG_QUERIES[2][1], "sorted")):
        box = capture(agg_ops, "segmented_reduce", lambda q=q: single.sql(q))
        for args, kw in box:
            kern = sr.segmented_reduce(*args, **kw)
            plain = sr.segmented_reduce_plain(*args, ops=kw["ops"], num_groups=kw["num_groups"])
            for op, a, b in zip(kw["ops"], kern, plain):
                ok = torch.allclose(a, b, rtol=1e-9, atol=0) if op == "sum" else torch.equal(a, b)
                check(ok, f"{name}'s K2 {mode} {op} differs from its plain version")
        log(f"phase 9 {name}'s K2 {mode} calls: " + "; ".join(
            f"{a[0].numel()} rows, {kw['num_groups']} groups, ops {kw['ops']}" for a, kw in box)
            + ": kernel == plain (sums at rtol 1e-9)")

    runs = [(name, c_, q) for name, c_, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 9 aggregates: a1-a6, m15-m18 match the numpy oracle; EXPLAIN routes " + json.dumps(routes)
        + "; wall ms first " + json.dumps({n: round(v, 3) for n, v in walls.items()}) + " warm (median of 5) "
        + json.dumps({n: round(v, 3) for n, v in warm.items()}) + f"; launches per query {json.dumps(per_query)}")
    profile_queries(runs, "phase 9", "profile_aggregates.txt")
    for name, s_ in kernel_stats.items():
        s_["aggregate_launches"] = launches[name]
    return {"warm_ms": warm, "launches": per_query}


# phase 10's queries: (name, SQL, what EXPLAIN VERBOSE must show); d1-d3
# on one card, m19 = d1 over 8 shards. bigd is big with dt (Date32 days
# over 1900-2099) and ts (Timestamp seconds over the same span, 5% NULLs)
DATE_PRED = "WHERE dt < DATE '1925-01-01' OR dt >= DATE '2095-01-01'"
MONTH_PRED = "WHERE dt + INTERVAL '1' MONTH < DATE '1905-01-01' OR dt + INTERVAL '1' MONTH >= DATE '2095-01-01'"
DATE_QUERIES = (
    ("d1", "SELECT YEAR(dt), MONTH(dt), DAY(dt), EXTRACT(DOW FROM dt), EXTRACT(DOY FROM dt), EXTRACT(QUARTER FROM dt), "
           f"EXTRACT(WEEK FROM dt), HOUR(ts), MINUTE(ts), SECOND(ts), EXTRACT(EPOCH FROM ts) FROM bigd {DATE_PRED}",
     ("fused CUDA stage (11 computed expr(s), predicate",)),
    ("d2", "SELECT DATE_TRUNC('year', dt), DATE_TRUNC('quarter', dt), DATE_TRUNC('month', dt), DATE_TRUNC('week', dt), "
           "DATE_TRUNC('day', dt), dt + INTERVAL '1' MONTH, ts + INTERVAL '3' HOUR, CAST(ts AS DATE) FROM bigd "
           + MONTH_PRED, ("fused CUDA stage (8 computed expr(s), predicate",)),
    ("d2t", "SELECT " + ", ".join(f"DATE_TRUNC('{u}', ts)" for u in ("year", "quarter", "month", "week", "day", "hour",
                                                                     "minute", "second")) + f" FROM bigd {MONTH_PRED}",
     ("fused CUDA stage (8 computed expr(s), predicate",)),
    ("d3", "SELECT YEAR(dt), QUARTER(dt), SUM(lat), COUNT(*) FROM bigd GROUP BY YEAR(dt), QUARTER(dt)",
     ("co-sort + segmented reduce",)),
)


def date_arrays():
    """Phase 10's columns from the seed: dt, days uniform over 1900-01-01
    .. 2099-12-31 (so before the epoch too); ts, seconds over the same
    span; ts's validity (5% NULLs)."""
    rng = np.random.default_rng(SEED + 10)
    dt = rng.integers(DAY_1900, DAY_2100, N).astype(np.int32)
    ts = rng.integers(DAY_1900 * 86400, DAY_2100 * 86400, N)
    return dt, ts, rng.random(N) > 0.05


def dates_table(port, big, dt, ts, ts_valid):
    """bigd: big's columns (no copy) with dt and ts on the card."""
    P = port.DataType
    dev = big.columns[0].data.device
    cols = (port.Column(P.Date32, torch.from_numpy(dt).to(dev)),
            port.Column(P.Timestamp, torch.from_numpy(ts).to(dev), torch.from_numpy(ts_valid).to(dev)))
    return port.Table(port.Schema(list(big.schema.fields) + [port.Field("dt", P.Date32, False),
                                                            port.Field("ts", P.Timestamp, True)]),
                      big.columns + cols, big.num_rows)


def calendar_oracle(days):
    """Python datetime's answers for each of `days` (days since the epoch,
    in datetime's range), as int64 arrays: the fields, DATE_TRUNC's first
    days (year, quarter, month, ISO week) and the day one month later,
    clamped to that month's length."""
    import calendar
    import datetime

    keys = ("year", "month", "day", "dow", "doy", "quarter", "week", "t_year", "t_quarter", "t_month", "t_week",
            "plus_month")
    out = {k_: np.empty(len(days), np.int64) for k_ in keys}
    epoch = datetime.date(1970, 1, 1)
    for i, x in enumerate(days.tolist()):
        day = epoch + datetime.timedelta(days=x)
        y, m = day.year, day.month
        y2, m2 = divmod(y * 12 + m, 12)  # the month after (y, m), m2 counted from 0
        row = (y, m, day.day, day.isoweekday() % 7, day.timetuple().tm_yday, (m - 1) // 3 + 1, day.isocalendar()[1],
               (datetime.date(y, 1, 1) - epoch).days, (datetime.date(y, (m - 1) // 3 * 3 + 1, 1) - epoch).days,
               (datetime.date(y, m, 1) - epoch).days, x - day.weekday(),
               (datetime.date(y2, m2 + 1, min(day.day, calendar.monthrange(y2, m2 + 1)[1])) - epoch).days)
        for k_, v in zip(keys, row):
            out[k_][i] = v
    return out


def by_day(days):
    """The oracle's answers for each of `days`: evaluated once per
    distinct day and scattered back."""
    uniq, inv = np.unique(days, return_inverse=True)
    return {k_: v[inv] for k_, v in calendar_oracle(uniq).items()}


def dates_oracle(arrays, dt, ts, ts_valid):
    """Phase 10's answers from numpy and Python's datetime: (columns,
    validity of the ts columns or None) per query, over its selected
    rows; d3 (year, quarter, SUM(lat), COUNT(*)) by key."""
    lat = arrays[2]
    out = {}
    m1 = (dt < DAY_1925) | (dt >= DAY_2095)
    c = by_day(dt[m1])
    sec = ts[m1]
    sod = sec - np.floor_divide(sec, 86400) * 86400
    out["d1"] = ([c[k_] for k_ in ("year", "month", "day", "dow", "doy", "quarter", "week")]
                 + [sod // 3600, sod // 60 % 60, sod % 60, sec], ts_valid[m1])
    c = by_day(dt)
    plus = c["plus_month"]
    m2 = (plus < DAY_1905) | (plus >= DAY_2095)
    sec = ts[m2]
    sec_days = np.floor_divide(sec, 86400)
    out["d2"] = ([c[k_][m2] for k_ in ("t_year", "t_quarter", "t_month", "t_week")]
                 + [dt[m2], plus[m2], sec + 10800, sec_days], ts_valid[m2])
    t = by_day(sec_days)
    out["d2t"] = ([t[k_] * 86400 for k_ in ("t_year", "t_quarter", "t_month", "t_week")]
                  + [sec_days * 86400, sec - sec % 3600, sec - sec % 60, sec], ts_valid[m2])
    key = (c["year"] - 1900) * 4 + c["quarter"] - 1
    cnt = np.bincount(key, minlength=800)
    out["d3"] = [1900 + np.arange(800) // 4, np.arange(800) % 4 + 1, np.bincount(key, weights=lat, minlength=800), cnt]
    return out


def check_date_results(name, res, want):
    """d1-d2t against the oracle exactly (data where valid; the ts
    columns' validity equal to ts's); d3 by key, SUM(lat) at rel 1e-9."""
    if name == "d3":
        cols = [c for c, _ in res.cols]
        order = np.lexsort((cols[1], cols[0]))
        got = [c[order] for c in cols]
        check(len(got[0]) == 800, f"d3: {len(got[0])} groups")
        for j, (a, b) in enumerate(zip(got, want)):
            ok = np.allclose(a, b, rtol=1e-9, atol=0) if j == 2 else np.array_equal(a.astype(np.int64), b)
            check(ok, f"d3: column {j} differs from the oracle")
        return
    cols, ts_valid = want
    first_ts = {"d1": 7, "d2": 6, "d2t": 0}[name]  # the columns past it read ts
    check(len(res.cols) == len(cols), f"{name}: column count")
    for j, ((a, v), b) in enumerate(zip(res.cols, cols)):
        live = np.ones(len(b), bool)
        if j >= first_ts:
            check(v is not None and np.array_equal(v, ts_valid), f"{name}: column {j}'s validity")
            live = ts_valid
        check(a.shape == b.shape and np.array_equal(a[live].astype(np.int64), b[live]),
              f"{name}: column {j} differs from the oracle")


def kernel_counters():
    """Each kernel's launch counter: name -> (function, attribute)."""
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs
    from datafusion_tpu_torch.ops.pallas import partition as pt
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    return {"fused_stage": (fs.run_fused, "launches"), "segreduce_sorted": (sr.segmented_reduce, "sorted_launches"),
            "segreduce_dense": (sr.segmented_reduce, "dense_launches"),
            "slab_partition": (pt.slab_partition, "launches"), "windowed_reduce": (pt.windowed_reduce, "launches"),
            "ragged_exchange": (rs.ragged_exchange, "launches"),
            "ragged_exchange_fold": (rs.ragged_exchange_fold, "launches")}


def run_counted(queries):
    """Run each (name, context, SQL) once with every launch counter set to
    0 first: (results, first walls in ms, each kernel's launches per
    query, launches in all)."""
    counters = kernel_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    results, walls, per_query = {}, {}, {}
    for name, c_, q in queries:
        before = {c: getattr(f, a) for c, (f, a) in counters.items()}
        t = time.perf_counter()
        results[name] = c_.sql(q)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t) * 1e3
        per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
    return results, walls, per_query, {c: getattr(f, a) for c, (f, a) in counters.items()}


def launched(counts):
    """The kernels a query launched, with their launch counts."""
    return {c: n for c, n in counts.items() if n}


def explain_routes(queries):
    """The physical lines of EXPLAIN VERBOSE for each (name, context, SQL,
    notes), checked to contain each of its notes."""
    routes = {}
    for name, c_, q, notes in queries:
        txt = c_.sql(f"EXPLAIN VERBOSE {q}").result_str()
        for note in notes:
            check(note in txt, f"{name} does not route to {note}")
        routes[name] = [ln[len("physical: "):] for ln in txt.splitlines() if ln.startswith("physical: ")]
    return routes


def phase_dates(dev, big, arrays, kernel_stats):
    """Phase 10a: the date and timestamp functions at 2^25 rows, d1-d3 on
    one card and m19 over 8 shards, against Python's calendar; K1's date
    programs over the calendar's edges against evaluate_plain bit for
    bit. Returns the runs to profile."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    t0 = time.perf_counter()
    dt, ts, ts_valid = date_arrays()
    bigd = dates_table(port, big, dt, ts, ts_valid)
    want = dates_oracle(arrays, dt, ts, ts_valid)
    torch.cuda.synchronize()
    log(f"phase 10 tables: bigd (big + dt + ts, {N} rows); calendar oracle in {time.perf_counter() - t0:.2f} s")
    single, mesh = port.ExecutionContext(), port.ExecutionContext(mesh=port.make_mesh(8))
    single.register_table("bigd", bigd)
    mesh.register_table("bigd", bigd)
    queries = [(n, single, q, note) for n, q, note in DATE_QUERIES] + [
        ("m19", mesh, DATE_QUERIES[0][1], DATE_QUERIES[0][2])]
    routes = explain_routes(queries)
    results, walls, per_query, launches = run_counted([q[:3] for q in queries])
    per_query = {name: launched(counts) for name, counts in per_query.items()}
    for name in ("d1", "d2", "d2t"):
        check(per_query[name] == {"fused_stage": 1}, f"{name} made launches {per_query[name]}, not one K1")
    check(per_query["m19"] == {"fused_stage": 8}, f"m19 made launches {per_query['m19']}, not 8 K1")
    check(per_query["d3"].get("segreduce_sorted", 0) >= 1, "d3 did not launch K2 sorted")
    for name in ("d1", "d2", "d2t", "d3"):
        check_date_results(name, results[name], want[name])
    for (a, va), (b, vb) in zip(results["m19"].cols, results["d1"].cols):
        check(np.array_equal(a, b) and (va is None) == (vb is None) and (va is None or np.array_equal(va, vb)),
              "m19 differs from one card's d1")

    # K1's date programs over the calendar's edges, and d1's own program
    t = date_edge_table(port, N, SEED + 11, dev)
    edge_ctx = port.ExecutionContext()
    edge_ctx.register_table("t", t)
    err, rows = 0.0, []
    for i, sql in enumerate(K1_DATES):
        prog, ins = fused_program(edge_ctx, "t", sql)
        err = max(err, compare_k1(prog, ins, N, dev))
        rows.append(f"program {i}: {len(prog.code)} instructions over {prog.n_regs} registers, kernel "
                    f"{time_ms(lambda: fs.run_fused(prog, *ins, N, dev)):.3f} ms, plain "
                    f"{time_ms(lambda: fs.evaluate_plain(prog, *ins, N), reps=3):.3f} ms, bound "
                    f"{program_bytes(prog, ins, N) / hbm_bytes_per_s() * 1e3:.3f} ms")
    log(f"phase 10 K1 date programs over the calendar's edges at {N} rows: kernel == plain bit for bit; "
        + "; ".join(rows))
    prog, ins = fused_program(single, "bigd", DATE_QUERIES[0][1])
    call = lambda: fs.run_fused(prog, *ins, N, dev)  # noqa: E731
    err = max(err, compare_k1(prog, ins, N, dev))
    d1 = {"dates_ms": time_ms(call), "dates_kernel_ms": kernel_only_ms(call, "fused_stage_kernel"),
          "dates_plain_ms": time_ms(lambda: fs.evaluate_plain(prog, *ins, N), reps=3),
          "dates_bound_ms": program_bytes(prog, ins, N) / hbm_bytes_per_s() * 1e3}
    kernel_stats["fused_stage"].update(d1)
    kernel_stats["fused_stage"]["max_abs_err"] = max(kernel_stats["fused_stage"]["max_abs_err"], err)
    log(f"phase 10 K1 on d1's program ({len(prog.code)} instructions over {prog.n_regs} registers, "
        f"{fs.tile_rows(prog.n_regs)} rows a thread): kernel == plain; event {d1['dates_ms']:.3f} ms, kernel only "
        f"{d1['dates_kernel_ms']:.3f} ms, plain {d1['dates_plain_ms']:.3f} ms, bound {d1['dates_bound_ms']:.3f} ms "
        "(bytes)")

    runs = [(name, c_, q) for name, c_, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    log("phase 10 dates: d1-d3 and m19 match the calendar oracle (m19 equals one card); EXPLAIN routes "
        + json.dumps(routes) + "; wall ms first " + json.dumps({n: round(v, 3) for n, v in walls.items()})
        + " warm (median of 5) " + json.dumps({n: round(v, 3) for n, v in warm.items()})
        + f"; launches per query {json.dumps(per_query)}")
    for name, s_ in kernel_stats.items():
        s_["dates_launches"] = launches[name]
    return runs


TPCH_SCALE = 1.0  # 6M lineitem rows, TPC-H SF1's size


def same_result(name, got, want, rtol=1e-9):
    """Row count and order, strings, integers, dates and validity exact;
    floats at `rtol`."""
    check(got.num_rows == want.num_rows and got.num_columns == want.num_columns,
          f"{name}: {got.num_rows} x {got.num_columns} against {want.num_rows} x {want.num_columns}")
    for j, ((a, va), (b, vb)) in enumerate(zip(got.cols, want.cols)):
        live = np.ones(len(a), bool) if va is None else va
        check(np.array_equal(live, np.ones(len(b), bool) if vb is None else vb), f"{name}: column {j}'s validity")
        check(got.schema.field(j).dtype is want.schema.field(j).dtype, f"{name}: column {j}'s type")
        if np.asarray(a).dtype.kind == "f":
            ok = np.allclose(a[live], b[live], rtol=rtol, atol=0, equal_nan=True)
        else:
            ok = got.column_values(j) == want.column_values(j)
        check(ok, f"{name}: column {j} differs")


def phase_tpch(dev, kernel_stats, date_runs):
    """Phase 10b: the 22 shapes of benchmarks/tpch.py over gen_tables(1.0)
    on the card (t1-t22), each held to the same query through the port on
    the CPU over the same tables; m20, q1 over 8 shards, to one card."""
    import datafusion_tpu_torch as port

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from tpch import QUERIES, gen_tables

    t0 = time.perf_counter()
    tables = gen_tables(TPCH_SCALE)
    cpu, card, mesh = port.ExecutionContext(device="cpu"), port.ExecutionContext(), port.ExecutionContext(
        mesh=port.make_mesh(8))
    for name, cols in zip(("lineitem", "orders", "customer", "part"), tables):
        t = port.Table.from_pydict(cols, device="cpu")
        cpu.register_table(name, t)
        card.register_table(name, t)
        mesh.register_table(name, card.table(name))
    torch.cuda.synchronize()
    log(f"phase 10 TPC-H tables: scale {TPCH_SCALE}, lineitem {len(tables[0]['l_orderkey'])} rows, orders "
        f"{len(tables[1]['o_orderkey'])}, customer {len(tables[2]['c_custkey'])}, part {len(tables[3]['p_partkey'])}; "
        f"made and loaded in {time.perf_counter() - t0:.2f} s")
    names = {f"t{i + 1}": q for i, q in enumerate(QUERIES)}
    queries = [(t_, card, QUERIES[q], ()) for t_, q in names.items()] + [("m20", mesh, QUERIES["q1"], ("per shard",))]
    routes = explain_routes(queries)
    results, walls, per_query, launches = run_counted([q[:3] for q in queries])
    per_query = {name: launched(counts) for name, counts in per_query.items()}
    for kern in ("fused_stage", "segreduce_sorted", "segreduce_dense"):
        check(launches[kern] > 0, f"{kern} was not launched on TPC-H's path")
    t0 = time.perf_counter()
    for t_, q in names.items():
        same_result(f"{t_} ({q})", results[t_], cpu.sql(QUERIES[q]))
    cpu_s = time.perf_counter() - t0
    same_result("m20", results["m20"], results["t1"])
    for t_, q in names.items():  # a second evaluation: the same bytes (float SUMs are the same bits in every run)
        check(card.sql(QUERIES[q]).result_str() == results[t_].result_str(), f"{t_} ({q}): a second run differs")
    runs = [(name, c_, q) for name, c_, q, _ in queries]
    warm = {name: warm_wall_ms(c_, q) for name, c_, q in runs}
    for name, _, _ in runs:
        log(f"phase 10 {name} ({names.get(name, 'q1 on 8 shards')}): {results[name].num_rows} rows, wall first "
            f"{walls[name]:.3f} ms, warm {warm[name]:.3f} ms (median of 5), launches {json.dumps(per_query[name])}, "
            f"route {json.dumps(routes[name])}")
    log(f"phase 10 TPC-H: t1-t22 equal the port on the CPU (floats at rtol 1e-9; the CPU took {cpu_s:.2f} s) and "
        "their own second evaluation byte for byte, m20 equals one card's q1")
    profile_queries(date_runs + runs, "phase 10", "profile_dates_tpch.txt")
    for name, s_ in kernel_stats.items():
        s_["tpch_launches"] = launches[name]


# phase 13: q15ish compares its revenue view with the view's own MAX, two
# evaluations of one float SUM (scripts/tpch_repeat.py repeats the same
# query and view, for one checkout or two side by side)
REPEAT_SCALE = 0.05  # 300K lineitem rows: tests/test_torch_cuda.py's TPC-H scale
REPEAT_RUNS = 30
Q15_REVENUE = ("SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) AS r FROM lineitem "
               "WHERE l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-04-01' "
               "GROUP BY l_suppkey ORDER BY l_suppkey")


def phase_determinism(dev, big):
    """Phase 13: q15ish REPEAT_RUNS times at REPEAT_SCALE on the card, each
    equal to the CPU's rows, and its revenue view bit-equal in 5 runs; then
    the phase-4 queries and TPC-H's 22 shapes once under
    torch.use_deterministic_algorithms(True, warn_only=True), every
    nondeterminism warning torch raises logged
    (chiprun_out/determinism_warnings.txt)."""
    import warnings

    import datafusion_tpu_torch as port

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from tpch import QUERIES, gen_tables

    t0 = time.perf_counter()
    gpu, cpu = port.ExecutionContext(), port.ExecutionContext(device="cpu")
    for name, cols in zip(("lineitem", "orders", "customer", "part"), gen_tables(REPEAT_SCALE)):
        t = port.Table.from_pydict(cols, device="cpu")
        gpu.register_table(name, t)
        cpu.register_table(name, t)
    q = QUERIES["q15ish"]
    want = cpu.sql(q)
    runs = [gpu.sql(q) for _ in range(REPEAT_RUNS)]
    for r in runs:  # the CPU's rows; the revenue within rtol 1e-9 (row order on the CPU, fixed point on the card)
        same_result("phase 13 q15ish", r, want)
    strs = {r.result_str() for r in runs}
    sums = [gpu.sql(Q15_REVENUE).cols[1][0].copy() for _ in range(5)]
    same = [bool(np.array_equal(x.view(np.uint64), sums[0].view(np.uint64))) for x in sums]
    as_cpu = sum(r.result_str() == want.result_str() for r in runs)
    log(f"phase 13 q15ish at scale {REPEAT_SCALE}: {REPEAT_RUNS} of {REPEAT_RUNS} runs give the CPU's "
        f"{want.num_rows} row(s); {len(strs)} distinct result_str over the runs ({as_cpu} byte-equal to the CPU's); "
        f"its revenue view ({len(sums[0])} suppliers' f64 sums) bit-equal in 5 runs: {same}")
    check(len(strs) == 1, "q15ish's result differs between runs")
    check(all(same), "q15ish's revenue view differs between runs")

    # torch's own float reductions on the path: a sum (ungrouped aggregates,
    # VAR's mean) should repeat its bits; a float cumsum need not, which is
    # why the windows' sums are integer prefix sums (ops/window.py)
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(SEED + 13), device=dev,
                    dtype=torch.float64) * 100
    sums = {int(x.sum().view(torch.int64)) for _ in range(20)}
    scans = {int(torch.cumsum(x, 0)[-1].view(torch.int64)) for _ in range(20)}
    log(f"phase 13 torch on the card at {N} f64 values: x.sum() gave {len(sums)} distinct bit pattern(s) in 20 runs, "
        f"torch.cumsum(x)[-1] {len(scans)}")
    check(len(sums) == 1, "torch.sum of f64 on the card differs between runs")
    del x

    ctx = port.ExecutionContext(bigdense=True)
    ctx.register_table("big", big)
    runs = [(n, ctx, q_) for n, q_, _ in MAIN_QUERIES] + [(n, gpu, q_) for n, q_ in QUERIES.items()]
    found = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, c_, q_ in runs:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                c_.sql(q_)
                torch.cuda.synchronize()
            for w in caught:
                found.setdefault(str(w.message).splitlines()[0][:300], []).append(name)
    finally:
        torch.use_deterministic_algorithms(False)
    with open(os.path.join(ROOT, "chiprun_out", "determinism_warnings.txt"), "w") as f:
        f.writelines(f"{msg}\t{sorted(set(names))}\n" for msg, names in found.items())
    log(f"phase 13 torch.use_deterministic_algorithms(True, warn_only=True) over {len(runs)} queries (q1-q5, TPC-H "
        f"at scale {REPEAT_SCALE}): {len(found)} distinct nondeterminism warning(s) "
        + json.dumps({m[:160]: sorted(set(n)) for m, n in found.items()}) + f"; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")


def phase_csv(dev):
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.utils.fmt import rust_f32, rust_f64

    P = port.DataType
    data = os.path.join(ROOT, "tests", "data")

    def display(dt, v):  # Rust `{}` Display, the era goldens' format
        if v is None:
            return ""
        if dt is P.Utf8:
            return str(v)
        if dt is P.Boolean:
            return "true" if v else "false"
        if dt in (P.Float32, P.Float64):
            s = rust_f32(float(v)) if dt is P.Float32 else rust_f64(float(v))
            return s[:-2] if s.endswith(".0") else s
        return str(int(v))

    def render(res):
        cols = [res.column_values(j) for j in range(res.num_columns)]
        dts = [f.dtype for f in res.schema.fields]
        return "".join(",".join(display(dts[j], cols[j][i]) for j in range(len(cols))) + "\n"
                       for i in range(res.num_rows))

    ctx = port.ExecutionContext(device=dev)
    F = port.Field
    ctx.register_csv("uk_cities", os.path.join(data, "uk_cities.csv"),
                     port.Schema([F("city", P.Utf8, False), F("lat", P.Float64, False), F("lng", P.Float64, False)]),
                     has_header=False)
    ctx.register_csv("cities", os.path.join(data, "uk_cities.csv"),
                     port.Schema([F("city", P.Utf8, False), F("lat", P.Float64, False), F("lng", P.Float64, False)]))
    ctx.register_csv("null_test", os.path.join(data, "null_test.csv"),
                     port.Schema([F("c_int", P.Int32, False), F("c_float", P.Float64, True),
                                  F("c_string", P.Utf8, True), F("c_bool", P.Boolean, False)]))
    for name, it, ft in (("num", P.Int32, P.Float32), ("num64", P.Int64, P.Float64)):
        ctx.register_csv(name, os.path.join(data, "numerics.csv"),
                         port.Schema([F("a", it, False), F("b", it, False), F("a_f", ft, False), F("b_f", ft, False)]))
    types = [("c_bool", P.Boolean), ("c_uint8", P.UInt8), ("c_uint16", P.UInt16), ("c_uint32", P.UInt32),
             ("c_uint64", P.UInt64), ("c_int8", P.Int8), ("c_int16", P.Int16), ("c_int32", P.Int32),
             ("c_int64", P.Int64), ("c_float32", P.Float32), ("c_float64", P.Float64), ("c_utf8", P.Utf8)]
    ctx.register_csv("t", os.path.join(data, "all_types_flat.csv"),
                     port.Schema([F(n, t, False) for n, t in types]), has_header=False)
    ctx.register_csv("t1", os.path.join(data, "aggregate_test_1.csv"),
                     port.Schema([F("a", P.Int32, False), F("b", P.Float64, False)]))
    ctx.register_csv("t2", os.path.join(data, "aggregate_test_2.csv"),
                     port.Schema([F("a", P.Utf8, False), F("b", P.Float64, False)]))

    minmax = ", ".join(f"MIN({n}), MAX({n})" for n, _ in types[1:])
    goldens = [
        ("test_filter", "SELECT city, lat, lng FROM uk_cities WHERE lat > 52.0"),
        ("test_sql_min_max", "SELECT MIN(lat), MAX(lat), MIN(lng), MAX(lng) FROM uk_cities"),
        ("is_null_csv", "SELECT c_int FROM null_test WHERE c_float IS NULL"),
        ("is_not_null_csv", "SELECT c_int FROM null_test WHERE c_float IS NOT NULL"),
        ("test_cast", "SELECT c_int, CAST(c_int AS smallint), CAST(c_int AS int), CAST(c_int AS bigint), "
                      "c_float, CAST(c_float AS double), c_string, c_string FROM null_test WHERE c_int < 3"),
        ("csv_query_all_types", "SELECT * FROM t WHERE c_float64 < 0.1"),
        ("csv_aggregate_by_c_bool", f"SELECT c_bool, {minmax} FROM t GROUP BY c_bool ORDER BY c_bool"),
        ("c_int8_range_inclusive", "SELECT c_int8 FROM t WHERE c_int8 >= 2 AND c_int8 <= 100"),
        ("c_uint32_cast", "SELECT CAST(c_uint32 AS bigint) FROM t"),
    ]
    for op, sym in (("plus", "+"), ("minus", "-"), ("multiply", "*"), ("divide", "/"), ("modulo", "%")):
        expr = f"a {sym} b, a {sym} 2, a {sym} 2.5, a_f {sym} b_f, a_f {sym} 2, a_f {sym} 2.5"
        goldens += [(f"numerics_{op}", f"SELECT {expr} FROM num"), (f"numerics_{op}_f64", f"SELECT {expr} FROM num64")]
    for name, q in goldens:
        with open(os.path.join(data, "expected", f"{name}.csv")) as f:
            want = f.read()
        check(render(ctx.sql(q)) == want, f"golden {name} differs")
    # tests/sql.rs goldens (aggregate_test, uk_cities), in the result_str format
    sqlrs = [
        ("SELECT a, MIN(b), MAX(b) FROM t1 GROUP BY a", "1\t1.1\t2.2\n2\t3.3\t5.5\n3\t1.0\t2.0\n"),
        ("SELECT a, MIN(b), MAX(b) FROM t2 GROUP BY a", '"one"\t1.1\t2.2\n"three"\t1.0\t2.0\n"two"\t3.3\t5.5\n'),
        ("SELECT a, b FROM t1 ORDER BY b DESC LIMIT 3", "2\t5.5\n2\t4.4\n2\t3.3\n"),
        ("SELECT a, b FROM t1 ORDER BY a DESC, b ASC", "3\t1.0\n3\t2.0\n2\t3.3\n2\t4.4\n2\t5.5\n1\t1.1\n1\t2.2\n"),
        ("SELECT COUNT(*) FROM t1", "7\n"),
        ("SELECT b, sqrt(b) FROM t1 ORDER BY b LIMIT 2", "1.0\t1.0\n1.1\t1.0488088481701516\n"),
        ("SELECT a, COUNT(a) FROM t2 WHERE a > 'three' GROUP BY a", '"two"\t3\n'),
        ("SELECT CAST(lat AS int) FROM cities",
         "53\n52\n51\n50\n51\n51\n51\n51\n52\n52\n52\n51\n57\n51\n53\n55\n51\n50\n"
         "52\n53\n50\n53\n55\n50\n52\n51\n51\n54\n50\n50\n53\n54\n50\n52\n52\n57\n"),
    ]
    for q, want in sqlrs:
        check(ctx.sql(q).result_str() == want, f"sql.rs golden differs: {q}")
    c1 = ctx.sql("SELECT city, lat, lng, lat + lng FROM cities WHERE lat > 51.0 AND lat < 53").result_str()
    check(c1.splitlines()[2] == '"Oxford, Oxfordshire, UK"\t51.752022\t-1.257677\t50.494344999999996'
          and len(c1.splitlines()) == 18, "sql.rs csv_query_with_predicate")
    log(f"phase 5 CSV: {len(goldens)} golden files + {len(sqlrs) + 1} sql.rs goldens byte-exact on the card")


# phase 11: the CSV export of big's five columns, larger than TPC-H SF1's
# 6M-row lineitem, and an NDJSON file of k, d, lat and a Utf8 mode with
# 5% NULLs; (name, SQL, what EXPLAIN VERBOSE must show, the kernel that
# must launch once)
INGEST_ROWS = 1 << 23
NDJSON_ROWS = 1 << 20
INGEST_QUERIES = (
    ("i1", "SELECT k, lat + lng FROM c WHERE d < 150", "fused CUDA stage", "fused_stage"),
    ("i2", "SELECT d, SUM(lat), COUNT(*) FROM c GROUP BY d ORDER BY d LIMIT 10", "dense sort-free",
     "segreduce_dense"),
    ("i3", "SELECT k, MIN(lng), MAX(g) FROM c GROUP BY k", "packed-gid co-sort", "segreduce_sorted"),
)


def write_csv(path, cols, names):
    """A header line, then one line per row: integers as written, floats
    as `repr` (the shortest text that reads back to the same double)."""
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        step = 1 << 18
        for lo in range(0, len(cols[0]), step):
            rows = zip(*(c[lo:lo + step].tolist() for c in cols))
            f.write("".join(",".join(map(repr, r)) + "\n" for r in rows))


def write_ndjson(path, k, d, lat, mode, valid):
    with open(path, "w") as f:
        step = 1 << 18
        for lo in range(0, len(k), step):
            sl = slice(lo, lo + step)
            f.write("".join(
                f'{{"k": {a}, "d": {b}, "lat": {c!r}, "mode": ' + (f'"{SHIPMODES[m]}"}}\n' if v else "null}\n")
                for a, b, c, m, v in zip(k[sl].tolist(), d[sl].tolist(), lat[sl].tolist(), mode[sl].tolist(),
                                         valid[sl].tolist())))


def ingest_oracle(k, d, lat, lng, g):
    """i1-i3 over the CSV's rows in numpy: i1's rows in file order, i2's
    first 10 groups of d, i3's per-k MIN(lng) and MAX(g)."""
    m = d < 150
    i1 = (k[m], lat[m] + lng[m])
    keys = np.arange(10)
    i2 = (keys, np.array([lat[d == x].sum() for x in keys]), np.bincount(d, minlength=10)[:10])
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    i3 = (ks[starts], np.minimum.reduceat(lng[order], starts), np.maximum.reduceat(g[order], starts))
    return {"i1": i1, "i2": i2, "i3": i3}


def check_ingest_result(name, res, want):
    cols = [c for c, _ in res.cols]
    check(all(v is None or v.all() for _, v in res.cols), f"{name}: NULLs in the result")
    if name == "i3":  # GROUP BY without ORDER BY: compare by key
        order = np.argsort(cols[0], kind="stable")
        cols = [c[order] for c in cols]
    check(len(cols[0]) == len(want[0]), f"{name}: {len(cols[0])} rows, the oracle {len(want[0])}")
    for j, (a, b) in enumerate(zip(cols, want)):
        if name == "i2" and j == 1:  # f64 sums: the order of the additions differs
            check(np.allclose(a, b, rtol=1e-9, atol=0), f"{name}: column {j} differs from the oracle")
        else:
            check(np.array_equal(a, b), f"{name}: column {j} differs from the oracle")


def phase_ingest(dev, arrays, kernel_stats):
    """Phase 11: ingest and the session API on the card. A CSV of big's
    first 2^23 rows through the native C++ loader, eager (bit for bit
    against the source arrays) and lazy (a column parsed when a query
    first scans it); i1-i3 launch K1, K2 dense and K2 sorted once each and
    equal the eager table and a numpy oracle; a shipped plan runs in a
    fresh context; an NDJSON file through STORED AS NDJSON; the console
    on one card and on 8 shards against the reference smoketest golden."""
    import tempfile

    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.columnar.csv import LazyCsvTable
    from datafusion_tpu_torch.io.native import count_csv_rows_native, get_lib, parse_csv_native

    P = port.DataType
    n = INGEST_ROWS
    k, d, lat, lng, g = (a[:n] for a in arrays[:5])
    names = ("k", "d", "lat", "lng", "g")
    schema = port.Schema([port.Field(c, t, False) for c, t in zip(names, (P.Int32, P.Int32, P.Float64, P.Float64,
                                                                          P.Int32))])
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "big.csv")
        t0 = time.perf_counter()
        write_csv(path, (k, d, lat, lng, g), names)
        mb = os.path.getsize(path) / 1e6
        log(f"phase 11 CSV: {n} rows, {mb:.1f} MB written in {time.perf_counter() - t0:.2f} s")

        # the native loader: built with g++ on first use, and used here
        check(get_lib() is not None, "the native CSV loader did not build on this machine")
        t0 = time.perf_counter()
        rows = count_csv_rows_native(path, True)
        t_count = time.perf_counter() - t0
        check(rows == n, f"count_csv_rows_native gave {rows} rows, the file has {n}")
        t0 = time.perf_counter()
        parsed, validity = parse_csv_native(path, schema, True)
        t_parse = time.perf_counter() - t0
        check(validity is None, "the native parse found NULLs")
        for name, a, b in zip(names, parsed, (k, d, lat, lng, g)):
            check(a.dtype == b.dtype and same_bits(torch.from_numpy(a), torch.from_numpy(b)),
                  f"native parse of {name} is not the source bit for bit")
        del parsed
        eager = port.ExecutionContext()
        t0 = time.perf_counter()
        eager.register_csv("c", path, schema, lazy=False)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        et = eager.table("c")
        check(not isinstance(et, LazyCsvTable) and et.device.type == "cuda", "the eager table is not on the card")
        for name, col, b in zip(names, et.columns, (k, d, lat, lng, g)):
            check(col.validity is None and same_bits(col.data, torch.from_numpy(b).to(col.data.device)),
                  f"eager column {name} on the card is not the source bit for bit")
        log(f"phase 11 native loader: count pass {t_count * 1e3:.1f} ms, parse {t_parse:.3f} s "
            f"({mb / t_parse:.0f} MB/s), eager register_csv (parse + copy to the card) {t_eager:.3f} s "
            f"({mb / t_eager:.0f} MB/s); columns equal the source bit for bit")

        # the lazy scan: registration parses nothing, each query its new columns
        lazy = port.ExecutionContext()
        t0 = time.perf_counter()
        lazy.register_csv("c", path, schema)
        t_lazy = time.perf_counter() - t0
        lt = lazy.table("c")
        check(isinstance(lt, LazyCsvTable) and lt.materialized_columns() == [] and lt.num_rows == n,
              "a default register_csv on the card is not a lazy table with nothing parsed")
        oracle = ingest_oracle(k, d, lat, lng, g)
        # run_counted's loop, reading the parsed columns after each query
        results, walls, per_query, materialized = {}, {}, {}, {}
        counters = kernel_counters()
        for f, attr in counters.values():
            setattr(f, attr, 0)
        for name, q, _, _ in INGEST_QUERIES:
            before = {c: getattr(f, a) for c, (f, a) in counters.items()}
            t = time.perf_counter()
            results[name] = lazy.sql(q)
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t) * 1e3
            per_query[name] = {c: getattr(f, a) - before[c] for c, (f, a) in counters.items()}
            materialized[name] = lt.materialized_columns()
        totals = {c: getattr(f, a) for c, (f, a) in counters.items()}
        for name, cols in (("i1", [0, 1, 2, 3]), ("i2", [0, 1, 2, 3]), ("i3", [0, 1, 2, 3, 4])):
            check(materialized[name] == cols, f"after {name} the parsed columns are {materialized[name]}, not {cols}")
        for name, _, _, kernel in INGEST_QUERIES:
            check(per_query[name][kernel] == 1, f"{name} launched {kernel} {per_query[name][kernel]} times, not once")
            check_ingest_result(name, results[name], oracle[name])
        for name, q, _, _ in INGEST_QUERIES:  # the same rows: the same bytes, float SUMs included
            check(results[name].result_str() == eager.sql(q).result_str(), f"{name}: lazy differs from eager")
        routes = explain_routes([(name, lazy, q, [note]) for name, q, note, _ in INGEST_QUERIES])
        for name, q, _, _ in INGEST_QUERIES:
            warm = warm_wall_ms(lazy, q)
            stats = {key: (round(v * 1e3, 3) if key.endswith("_s") else v) for key, v in lazy.last_stats.items()}
            log(f"phase 11 {name}: {results[name].num_rows} rows; wall first {walls[name]:.3f} ms (with its parse), "
                f"warm {warm:.3f} ms; last_stats (ms) {json.dumps(stats)}; launched {launched(per_query[name])}; "
                f"parsed columns after it {materialized[name]}; route {routes[name]}")
        # what the first walls hold: a lazy table of its own parses i1's
        # columns, then g, onto the card
        split = LazyCsvTable(path, schema, device=dev)
        parse_ms = {}
        for label, cols in (("k, d, lat, lng", [0, 1, 2, 3]), ("g", [4])):
            t0 = time.perf_counter()
            split.ensure_columns(cols)
            torch.cuda.synchronize()
            parse_ms[label] = (time.perf_counter() - t0) * 1e3
        del split
        log(f"phase 11 lazy parse onto the card, alone: {json.dumps({c: round(v, 3) for c, v in parse_ms.items()})} ms "
            f"(i1's first wall {walls['i1']:.3f} ms, i3's {walls['i3']:.3f} ms)")
        profile_queries([(name, lazy, q) for name, q, _, _ in INGEST_QUERIES], "phase 11", "profile_ingest.txt")
        log(f"phase 11 lazy: register_csv {t_lazy * 1e3:.1f} ms (the count pass only); i1-i3 equal the eager "
            f"table's result_str byte for byte and the numpy oracle; g parsed first by i3")
        for name, s_ in kernel_stats.items():
            s_["ingest_launches"] = totals[name]

        # plan shipping: i2's plan runs in a fresh context on the card
        q2 = INGEST_QUERIES[1][1]
        shipped = lazy.serialize_plan(q2)
        fresh = port.ExecutionContext()
        t0 = time.perf_counter()
        got = fresh.execute_plan_json(shipped)
        torch.cuda.synchronize()
        same_result("i2 shipped", got, results["i2"])
        log(f"phase 11 plan shipping: i2 serialized ({len(shipped)} bytes of JSON) and run in a fresh context in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, parsing columns {fresh.table('c').materialized_columns()}")
        del eager, lazy, fresh, et, lt

        # NDJSON: STORED AS NDJSON, GROUP BY mode on K2 dense
        rng = np.random.default_rng(SEED + 11)
        m = NDJSON_ROWS
        mode = rng.integers(0, len(SHIPMODES), m).astype(np.int32)
        mvalid = rng.random(m) >= 0.05
        jpath = os.path.join(tmp.name, "big.ndjson")
        t0 = time.perf_counter()
        write_ndjson(jpath, k[:m], d[:m], lat[:m], mode, mvalid)
        t_write = time.perf_counter() - t0
        nctx = port.ExecutionContext()
        t0 = time.perf_counter()
        nctx.sql(f"CREATE EXTERNAL TABLE n (k INT NOT NULL, d INT NOT NULL, lat DOUBLE NOT NULL, mode VARCHAR(10)) "
                 f"STORED AS NDJSON LOCATION '{jpath}'")
        t_read = time.perf_counter() - t0
        nq = "SELECT mode, COUNT(*), COUNT(mode), SUM(lat), MIN(k), MAX(d) FROM n GROUP BY mode"
        nres, nwalls, nper, _ = run_counted([("n1", nctx, nq)])
        check(nper["n1"]["segreduce_dense"] == 1, f"n1 launched K2 dense {nper['n1']['segreduce_dense']} times")
        for name, s_ in kernel_stats.items():
            s_["ingest_launches"] += nper["n1"][name]
        res = nres["n1"]
        got = {row[0]: row[1:] for row in zip(*(res.column_values(j) for j in range(res.num_columns)))}
        check(len(got) == len(SHIPMODES) + 1, f"n1 gave {len(got)} groups")
        for code in range(-1, len(SHIPMODES)):
            sel = ~mvalid if code < 0 else mvalid & (mode == code)
            key = None if code < 0 else SHIPMODES[code]
            rows_, nonnull, total, kmin, dmax = got[key]
            check(rows_ == int(sel.sum()) and nonnull == (0 if code < 0 else int(sel.sum()))
                  and np.isclose(total, lat[:m][sel].sum(), rtol=1e-9, atol=0)
                  and kmin == int(k[:m][sel].min()) and dmax == int(d[:m][sel].max()),
                  f"n1's group {key} differs from the oracle")
        log(f"phase 11 NDJSON: {m} rows written in {t_write:.2f} s, STORED AS NDJSON read onto the card in "
            f"{t_read:.2f} s; n1 (GROUP BY mode, 5% NULL) equals the numpy oracle, wall {nwalls['n1']:.3f} ms, "
            f"launched {launched(nper['n1'])}")

        # the console, on one card and on 8 shards, as two processes at once
        sql = open(os.path.join(ROOT, "tests", "data", "smoketest.sql")).read()
        spath = os.path.join(tmp.name, "smoketest.sql")
        with open(spath, "w") as f:
            f.write(sql.replace("/test/data/uk_cities.csv", os.path.join(ROOT, "tests", "data", "uk_cities.csv")))
        with open(os.path.join(ROOT, "tests", "data", "smoketest-expected.txt")) as f:
            expected = f.read()
        t0 = time.perf_counter()
        procs = {label: subprocess.Popen([sys.executable, "-m", "datafusion_tpu_torch.console", "--script", spath,
                                          "--ref-output", *extra], cwd=ROOT, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)
                 for label, extra in (("one card", []), ("--mesh 8", ["--mesh", "8"]))}
        try:
            outs = {label: p.communicate(timeout=300) for label, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for label, (out, err) in outs.items():
            check(procs[label].returncode == 0, f"the console ({label}) exited {procs[label].returncode}: {err[-2000:]}")
            check(out == expected, f"the console's stdout ({label}) differs from smoketest-expected.txt")
        log(f"phase 11 console: python -m datafusion_tpu_torch.console --script smoketest.sql --ref-output on one "
            f"card and with --mesh 8 equal tests/data/smoketest-expected.txt byte for byte "
            f"({time.perf_counter() - t0:.2f} s for both processes)")

        # Parquet: read by pyarrow (pandas reads Parquet through pyarrow too)
        versions = {lib: importlib.import_module(lib).__version__ for lib in ("pyarrow", "pandas")
                    if importlib.util.find_spec(lib) is not None}
        if "pyarrow" in versions:
            import pyarrow as pa
            import pyarrow.parquet as pq

            ppath = os.path.join(tmp.name, "big.parquet")
            t0 = time.perf_counter()
            pq.write_table(pa.table(dict(zip(names, (k, d, lat, lng, g)))), ppath)
            t_write = time.perf_counter() - t0
            pctx = port.ExecutionContext()
            t0 = time.perf_counter()
            pctx.register_parquet("c", ppath)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            check([f.dtype for f in pctx.table("c").schema.fields] == [f.dtype for f in schema.fields],
                  "the Parquet table's inferred types")
            for name, q, _, _ in INGEST_QUERIES:
                got = pctx.sql(q)
                if name == "i2":
                    same_result(f"{name} over Parquet", got, results[name])
                else:
                    check(all(np.array_equal(a, b) for (a, _), (b, _) in zip(got.cols, results[name].cols)),
                          f"{name} over Parquet differs from the CSV scan")
            log(f"phase 11 Parquet: {json.dumps(versions)} import here; {n} rows written by pyarrow in "
                f"{t_write:.2f} s ({os.path.getsize(ppath) / 1e6:.1f} MB), register_parquet onto the card "
                f"{t_read:.2f} s; i1-i3 over it equal the lazy CSV scan's rows")
            del pctx
        else:
            log(f"phase 11 Parquet: pyarrow does not import on this machine ({json.dumps(versions)}), so Parquet "
                f"is not run here; the CPU tests hold it to the JAX package")
    finally:
        tmp.cleanup()


# --- phase 14: one mesh over several cards of one process ---------------------------

MULTICARD_QUERIES = MESH_QUERIES + (MESH_JOIN_QUERIES[1], MESH_WINDOW_QUERIES[0], MESH_AGG_QUERIES[0])
MULTICARD_K5 = ("m6", "m7", "m10", "m11", "m15")  # the queries that exchange over K5 on one card's mesh
MULTICARD_K6 = ("m3", "m4")  # the fold
ORACLE_HELD = {}  # name -> result_str of the one-card mesh's query that phases 6-9 held to its numpy oracle
SPREAD = 2.0 ** -50  # phase 14's K6 case: the first card's receivers' values this far below the others'


def cards_used(n_cards):
    """How many cards phases 12 and 14 spread the 8 shards over: the most
    of 4, 2 and 1 that this host has (a count that divides 8)."""
    return next(c for c in (4, 2, 1) if c <= n_cards)


def card_lines():
    """nvidia-smi's name and power limit of every card, one per card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


def cards_ms(fn, devices, reps=5):
    """Median host-clock ms of `fn` between synchronizes of every card of
    `devices`, after a warm-up: the time of work that spans cards."""
    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    fn()
    times = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def cross_bytes(sizes, cards, rows_of, width, send_cards=None):
    """Per logical card c of `cards` (the kernels' `cards` argument; the
    `[n_send, n_recv]` count matrix `sizes`, receiver i on card
    i * len(cards) // n_recv, sender j on card `send_cards[j]`, by default
    j * len(cards) // n_send): (bytes its receivers read from senders on
    another card, bytes its own HBM moves: its senders' rows read and its
    receivers' rows written). `rows_of(count)` is the rows a pair moves
    (K5: whole chunks), `width` the bytes of a row."""
    sz = sizes.tolist()
    card = [i * len(cards) // len(sz[0]) for i in range(len(sz[0]))]
    send = send_cards or [j * len(cards) // len(sz) for j in range(len(sz))]
    peer, local = [0] * len(cards), [0] * len(cards)
    for j, row in enumerate(sz):
        for i, cnt in enumerate(row):
            b = rows_of(cnt) * width
            local[card[i]] += b  # written into the receiver's buffer
            local[send[j]] += b  # read from the sender's HBM
            if cards[send[j]] != cards[card[i]]:
                peer[card[i]] += b  # read over NVLink
    return peer, local


def cross_bound_ms(peer, local, cards):
    """The least time of an exchange across cards: over the cards, the
    larger of its peer bytes over NVLink (each way) and its own HBM bytes
    over HBM (utils/roofline.py)."""
    from datafusion_tpu_torch.utils.roofline import chip_hbm_gbps, chip_nvlink_gbps

    return max(max(p / (chip_nvlink_gbps(d) * 1e9), b / (chip_hbm_gbps(d) * 1e9)) * 1e3
               for p, b, d in zip(peer, local, cards))


def copies_yardstick(sends, sizes, split_cap, recvs):
    """The library yardstick of an exchange across cards: the same live
    regions moved by one `copy_` per live (sender, receiver, array), into
    the receivers' buffers `recvs` (peer copies where the cards differ)."""
    sz = sizes.tolist()

    def run():
        for j, row in enumerate(sz):
            for i, cnt in enumerate(row):
                if cnt:
                    for a, t in enumerate(sends[j]):
                        recvs[i][a][j * split_cap: j * split_cap + cnt].copy_(t[i * split_cap: i * split_cap + cnt],
                                                                               non_blocking=True)
    return run


def on_card(ts, dev):
    return [None if t is None else t.to(dev) for t in ts]


def phase_multicard(dev, big, arrays, tables, kernel_stats):
    """Phase 14: m1-m8, m10, m11 and m15 over make_mesh(8, devices=...) on
    4 or 2 cards (`cards_used`; two shards a card on four), against the one-card
    8-shard mesh and the oracle-held results of phases 6-9; then K5 and
    K6 alone at m6's and m3's shapes across the cards, bit-equal to their
    plain versions and the one-card launch, with a float SUM whose first
    card's values lie 2^50 below the others'. With one card the mesh is
    (cuda:0, cuda:0): every per-card launch, event and agreed scale runs,
    and no NVLink is crossed."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.parallel import collectives as C
    from datafusion_tpu_torch.parallel import shuffle as sh

    t14 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    log(f"phase 14 cards: {n_cards}; " + "; ".join(card_lines()))
    cross = n_cards >= 2
    cards = ([torch.device("cuda", i) for i in range(cards_used(n_cards))] if cross
             else [torch.device("cuda", 0)] * 2)
    P = port.DataType
    mode = port.Column(P.Utf8, torch.from_numpy(arrays[5]).to(dev), None, SHIPMODES)
    bigo = tables["big"]
    table = port.Table(port.Schema(list(bigo.schema.fields) + [port.Field("mode", P.Utf8, False)]),
                       bigo.columns + (mode,), bigo.num_rows)
    mesh = port.make_mesh(8, devices=cards)
    check(mesh.devices == tuple(cards) and mesh.device == cards[0], "make_mesh(devices=) did not take the cards")
    multi, one = port.ExecutionContext(mesh=mesh), port.ExecutionContext(mesh=port.make_mesh(8))
    t = time.perf_counter()
    for name, tb in (("big", table), ("orders", tables["orders"])):
        multi.register_table(name, tb)
        one.register_table(name, tb)
    for d in dict.fromkeys(cards):
        torch.cuda.synchronize(d)
    placed = time.perf_counter() - t
    shards = multi.table("big").shards
    check([s.device for s in shards] == [mesh.card_of(i) for i in range(8)], "a shard is not on its card")
    log(f"phase 14 mesh: 8 shards over {len(cards)} card(s) {[str(c) for c in cards]}, big's {table.num_rows} rows "
        f"({sum(c.data.nbytes for c in table.columns) / 1e9:.2f} GB) placed in {placed:.2f} s; shard rows "
        f"{[s.num_rows for s in shards]}")
    queries = [(n, q, (note,) if isinstance(note, str) else note) for n, q, note in MULTICARD_QUERIES]
    routes = explain_routes([(n, multi, q, notes) for n, q, notes in queries])
    bytes0 = C.to_card.bytes
    results, walls, per_query, launches = run_counted([(n, multi, q) for n, q, _ in queries])
    peer_bytes = C.to_card.bytes - bytes0
    for name in MULTICARD_K5:
        check(per_query[name]["ragged_exchange"] > 0, f"phase 14 {name} launched no K5")
    for name in MULTICARD_K6:
        check(per_query[name]["ragged_exchange_fold"] > 0, f"phase 14 {name} launched no K6")
    held = []
    for name, q, _ in queries:
        got = results[name].result_str()
        check(got == one.sql(q).result_str(), f"phase 14 {name} differs from the one-card mesh")
        if name in ORACLE_HELD:
            check(got == ORACLE_HELD[name], f"phase 14 {name} differs from the oracle-held one-card result")
            held.append(name)
    reps = 5 if cross else 3
    warm = {}
    for name, q, _ in queries:  # in turns: one card, the cards, (the cards, one card)
        order = [("one", one), ("cards", multi)] + ([("cards", multi), ("one", one)] if cross else [])
        ws = {}
        for lab, c_ in order:
            ws.setdefault(lab, []).append(warm_wall_ms(c_, q, reps))
        warm[name] = {lab: min(v) for lab, v in ws.items()}
    log(f"phase 14 queries: m1-m8, m10, m11, m15 over {len(cards)} card(s) equal the one-card 8-shard mesh byte for "
        f"byte; {len(held)} of them ({held}) also the result phases 6-9 held to the numpy oracle; EXPLAIN routes "
        + json.dumps(routes) + f"; launches per query {json.dumps({n: launched(c) for n, c in per_query.items()})}; "
        f"bytes moved between cards by the collectives (to_card) {peer_bytes}; wall ms first "
        + json.dumps({n: round(v, 3) for n, v in walls.items()}) + f" warm (median of {reps}; the better of the "
        "turns) " + json.dumps({n: {k: round(x, 3) for k, x in v.items()} for n, v in warm.items()}))
    for name, s_ in kernel_stats.items():
        s_["multicard_launches"] = launches[name]

    # K5 at m6's shape across the cards
    (a5, kw5), = capture(sh, "ragged_exchange", lambda: multi.sql(MESH_QUERIES[5][1]))[-1:]
    sends, sizes = a5
    n_dev, split_cap, chunk = kw5["n_dev"], kw5["split_cap"], kw5["chunk"]
    check(kw5["cards"] == mesh.devices, "m6's exchange did not take the mesh's cards")
    dev0 = cards[0]
    before = rs.ragged_exchange.launches
    got = rs.ragged_exchange(sends, sizes, **kw5)
    per_call5 = rs.ragged_exchange.launches - before
    plain = rs.ragged_exchange_plain([on_card(s_, dev0) for s_ in sends], sizes.to(dev0), n_dev=n_dev,
                                     split_cap=split_cap, chunk=chunk)
    for d in dict.fromkeys(cards):
        torch.cuda.synchronize(d)
    sz = sizes.tolist()
    for i in range(n_dev):
        check(got[i][0].device == mesh.card_of(i), f"K5's receiver {i} is not on its card")
        for a, b in zip(got[i], plain[i]):
            bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
            for j in range(len(sends)):
                span = slice(j * split_cap, j * split_cap + sz[j][i])
                check(torch.equal(a[span].to(dev0).view(bits), b[span].view(bits)),
                      "K5 across cards differs from its plain version")
    del plain
    width5 = sum(t.element_size() for t in sends[0])
    peer5, local5 = cross_bytes(sizes, list(mesh.devices), lambda c: -(-c // chunk) * chunk, width5)
    log(f"phase 14 K5 at m6's shape: {len(sends)} senders x {n_dev} receivers on {len(cards)} card(s), "
        f"{len(sends[0])} arrays ({width5} bytes a row), {int(sizes.sum())} rows, {per_call5} launch(es) a call: "
        "every receiver's valid prefixes bit-equal to the plain version over the senders' arrays on one card")

    # K6 at m3's shape across the cards
    (a6, kw6), = capture(sh, "ragged_exchange_fold", lambda: multi.sql(MESH_QUERIES[2][1]))[-1:]
    gids, vals, masks, sizes6 = a6
    check(kw6["cards"] == mesh.devices and kw6["agree"] is None, "m3's fold did not take the mesh's cards")
    kw1 = {k: v for k, v in kw6.items() if k not in ("cards", "agree")}

    def to0(args):
        g, v, m, s_ = args
        return ([x.to(dev0) for x in g], [on_card(x, dev0) for x in v], [on_card(x, dev0) for x in m], s_.to(dev0))

    def k6_bits(args, tag):
        """K6 across the cards against the one-card launch over the same
        rows, every table bit for bit, and its float SUMs against the
        plain fixed-point function."""
        before = rs.ragged_exchange_fold.launches
        k = rs.ragged_exchange_fold(*args, **kw6)
        calls = rs.ragged_exchange_fold.launches - before
        args0 = to0(args)
        w = rs.ragged_exchange_fold(*args0, **kw1)
        for i, (ki, wi) in enumerate(zip(k, w)):
            check(ki[0].device == mesh.card_of(i), f"K6's receiver {i} is not on its card")
            for op, x, y in zip(kw6["ops"], ki, wi):
                check(same_bits(x.to(dev0), y), f"K6 across cards ({tag}) {op} differs from the one-card launch")
        tables0 = [torch.stack([ki[a].to(dev0) for ki in k]) for a in range(len(kw6["ops"]))]
        check_fixed(f"K6 across cards ({tag})", tables0, k6_fixed_sums(args0, kw1))
        return calls

    per_call6 = k6_bits(a6, "m3")
    # the first card's receivers' values 2^50 below the others': the cards
    # must still fold on the mesh's one scale
    first = set(mesh.card_shards(0))
    scaled = {}
    for v in vals:
        for x in v:
            if x is not None and x.dtype.is_floating_point and id(x) not in scaled:
                y = x.clone()
                for i in first:
                    y[i * kw6["split_cap"]: (i + 1) * kw6["split_cap"]] *= SPREAD
                scaled[id(x)] = y
    vals_s = [[None if x is None else scaled.get(id(x), x) for x in v] for v in vals]
    k6_bits((gids, vals_s, masks, sizes6), "first card 2^50 below")
    del scaled, vals_s
    width6 = 4 + sum(t.element_size() for t in {id(t): t for t in vals[0] if t is not None}.values()) + len(masks[0])
    peer6, local6 = cross_bytes(sizes6, list(mesh.devices), lambda c: c, width6)
    log(f"phase 14 K6 at m3's shape: {int(sizes6.sum())} routed rows, {kw6['num_groups']} slots x {n_dev} receivers "
        f"on {len(cards)} card(s), ops {kw6['ops']}, {per_call6} launch(es) a call: every table bit-equal to the "
        "one-card launch and its float SUMs to the plain fixed-point function, also with the first card's values "
        f"2^50 below the others' (the cards agree on the mesh's scale)")

    if not cross:
        log("phase 14: one card, so the mesh's two logical cards share its HBM: no NVLink was crossed, and no "
            f"cross-card time is measured; phase 14 took {time.perf_counter() - t14:.1f} s")
        return

    # times across the cards: event (on the first card, which waits for
    # every card), kernel only (torch.profiler, summed over the launches of
    # every card), host, and the peer-copy yardstick, all on the same inputs
    devs = list(mesh.devices)
    call5 = lambda: rs.ragged_exchange(sends, sizes, **kw5)  # noqa: E731
    lib5 = copies_yardstick(sends, sizes, split_cap, got)
    s5 = dict(ms=time_ms(call5), wall_ms=cards_ms(call5, devs),
              kernel_ms=kernel_only_ms(call5, "ragged_exchange_kernel", per_call5), host_ms=host_only_ms(call5),
              nvlink_bytes=sum(peer5), bound_ms=cross_bound_ms(peer5, local5, devs),
              library_ms=cards_ms(lib5, devs), launches=launches["ragged_exchange"],
              library="one copy_ per live (sender, receiver, array)")
    del got
    call6 = lambda: rs.ragged_exchange_fold(gids, vals, masks, sizes6, **kw6)  # noqa: E731
    arrays6 = [[g] + list({id(t): t for t in v if t is not None}.values()) + list(m) for g, v, m in zip(gids, vals, masks)]
    recv6 = [[torch.empty(len(gids) * kw6["split_cap"], dtype=t.dtype, device=mesh.card_of(i)) for t in arrays6[0]]
             for i in range(n_dev)]
    lib6 = copies_yardstick(arrays6, sizes6, kw6["split_cap"], recv6)
    s6 = dict(ms=time_ms(call6), wall_ms=cards_ms(call6, devs),
              kernel_ms=kernel_only_ms(call6, "ragged_exchange_fold_kernel", per_call6), host_ms=host_only_ms(call6),
              nvlink_bytes=sum(peer6), bound_ms=cross_bound_ms(peer6, local6, devs),
              library_ms=cards_ms(lib6, devs), launches=launches["ragged_exchange_fold"],
              library="one copy_ per live (sender, receiver, array), no fold")
    del recv6, arrays6
    kernel_stats["ragged_exchange"]["cross_card"] = s5
    kernel_stats["ragged_exchange_fold"]["cross_card"] = s6
    for name, st in (("K5 at m6's shape", s5), ("K6 at m3's shape", s6)):
        log(f"phase 14 {name} across {len(devs)} cards: event {st['ms']:.3f} ms (host wall between synchronizes "
            f"{st['wall_ms']:.3f}), kernel only {st['kernel_ms']:.3f} ms summed over the cards' launches, host "
            f"{st['host_ms']:.3f} ms, {st['nvlink_bytes']} bytes over NVLink, bound {st['bound_ms']:.3f} ms "
            f"(per card the larger of peer bytes / NVLink each way and own bytes / HBM), library {st['library_ms']:.3f}"
            f" ms ({st['library']}); {st['launches']} launches in the counted run")
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s")


# --- phase 12: several processes as one mesh ---------------------------------------

MULTI_ROWS = 1 << 24  # big's rows over every process: 2^23 each of two
MULTI_CSV_ROWS = 1 << 21  # rows of each process's CSV file
MULTI_WORLD = 2  # processes on one or two cards (on four, also four processes of one card)
MULTI_QUERIES = MESH_QUERIES + (MESH_JOIN_QUERIES[1], MESH_WINDOW_QUERIES[0], MESH_AGG_QUERIES[0])
SHARD_QUERIES = (  # tests/multiproc_driver.py's queries over the per-process CSV files
    ("s1", "SELECT tag, COUNT(v) FROM s GROUP BY tag ORDER BY tag", ()),
    ("s2", "SELECT tag, k FROM s ORDER BY tag, k, v LIMIT 20", ()),
    ("s3", "SELECT MIN(tag), MAX(tag) FROM s", ()),
    ("s4", "SELECT COUNT(tag) FROM s WHERE tag = 'host1_3'", ()),
    ("s5", "SELECT s.tag, w, COUNT(v) FROM s JOIN d ON s.tag = d.tag GROUP BY s.tag, w ORDER BY 1", ()),
)
MULTI_K5 = ("m6", "m7", "m10", "m11", "m15")  # the routes that exchange over K5
MULTI_K6 = ("m3", "m4")  # the fold
INSERT_ROWS = 1 << 20  # rows of the rank table phase 12's INSERT rebuilds, over every process
INSERT_SQL = "INSERT INTO big SELECT k, d, lat, lng, g, mode, o FROM big WHERE d < 100"
INSERT_QUERIES = (MESH_QUERIES[0], MESH_QUERIES[2])  # m1 and m3 over the table after the INSERT
LAYOUTS = ("one", "cards")  # a process's shards on one card; over its cards (or two logical cards of one)


def multi_rounds(n_cards):
    """Phase 12's process groups on a host of `n_cards` cards, as
    (processes, cards a process): two processes share one card (Gloo) or
    take one card each of two (NCCL); on four or more, four processes of
    one card, then two of two cards each (NCCL)."""
    return [(4, 1), (MULTI_WORLD, 2)] if n_cards >= 4 else [(MULTI_WORLD, 1)]


def multi_tables(port, dev, rank=None, world=MULTI_WORLD, rows=MULTI_ROWS):
    """Phase 12's tables from the seed: big (k, d, lat, lng, g, mode, o)
    at `rows` rows and orders. With `rank`, big holds that process's
    share of the rows, of `world`; orders stays whole (each process keeps
    its blocks when it registers it)."""
    P = port.DataType
    k, d, lat, lng, g, mode = main_arrays(rows)
    ja = join_arrays(rows)
    cols = [k, d, lat, lng, g, (mode, SHIPMODES), ja["o"]]
    if rank is not None:
        lo, hi = rank * rows // world, (rank + 1) * rows // world
        cols = [(c[0][lo:hi], c[1]) if isinstance(c, tuple) else c[lo:hi] for c in cols]
    big = port.Table.from_arrays(port.Schema([port.Field(n, t, False) for n, t in (
        ("k", P.Int32), ("d", P.Int32), ("lat", P.Float64), ("lng", P.Float64), ("g", P.Int32), ("mode", P.Utf8),
        ("o", P.Int32))]), cols, device=dev)
    orders = port.Table.from_arrays(port.Schema([port.Field("o_orderkey", P.Int32, False),
                                                 port.Field("o_totalprice", P.Float64, False),
                                                 port.Field("o_orderpriority", P.Utf8, False)]),
                                    [ja["o_orderkey"], ja["o_totalprice"], (ja["o_orderpriority"], PRIORITIES)],
                                    device="cpu")
    return big, orders


def shard_arrays(world=MULTI_WORLD):
    """Each process's CSV rows (tag codes into that process's own
    vocabulary host<p>_0 .. host<p>_6, k, v), as tests/multiproc_driver.py
    makes them, at MULTI_CSV_ROWS rows a process."""
    rng = np.random.default_rng(SEED + 12)
    out = []
    for p in range(world):
        vocab = tuple(f"host{p}_{i}" for i in range(7))
        out.append((vocab, rng.integers(0, 7, MULTI_CSV_ROWS).astype(np.int32),
                    rng.integers(0, 25, MULTI_CSV_ROWS).astype(np.int64), np.round(rng.normal(size=MULTI_CSV_ROWS), 6)))
    return out


def write_shard_csvs(tmp, world=MULTI_WORLD):
    """The per-process CSV files s<p>.csv (tag, k, v) and d<p>.csv (tag, w)
    without header rows."""
    for p, (vocab, tag, k, v) in enumerate(shard_arrays(world)):
        words = np.asarray(vocab, dtype=object)[tag]
        with open(os.path.join(tmp, f"s{p}.csv"), "w") as f:
            f.write("".join(f"{t},{a},{b!r}\n" for t, a, b in zip(words.tolist(), k.tolist(), v.tolist())))
        with open(os.path.join(tmp, f"d{p}.csv"), "w") as f:
            f.write("".join(f"{t},{p * 100 + i}\n" for i, t in enumerate(vocab)))


def shard_schemas(port):
    P = port.DataType
    return (port.Schema([port.Field("tag", P.Utf8, False), port.Field("k", P.Int64, False),
                         port.Field("v", P.Float64, False)]),
            port.Schema([port.Field("tag", P.Utf8, False), port.Field("w", P.Int64, False)]))


def worker_meshes(port, n_local, cards_per_process):
    """A phase-12 process's two meshes: "one", its shards on its (first)
    card, and "cards", its shards over its `cards_per_process` cards, or,
    with one card a process, over two logical cards of that card."""
    first = torch.cuda.current_device()
    if cards_per_process > 1:
        cards = [torch.device("cuda", first + i) for i in range(cards_per_process)]
    else:
        cards = [torch.device("cuda", first)] * 2
    return {"one": port.global_mesh(n_local), "cards": port.global_mesh(n_local, devices=cards)}


def card_launch_counts():
    """K5's and K6's launch counts by logical card, copied."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs

    return {"ragged_exchange": collections.Counter(rs.ragged_exchange.card_launches),
            "ragged_exchange_fold": collections.Counter(rs.ragged_exchange_fold.card_launches)}


def kernel_ms_by_card(fn, names, devices, reps=5):
    """Device ms of one call of `fn` on each card of `devices`: the kernels
    whose name holds one of `names`, from torch.profiler's device events by
    device index, summed and divided by `reps` calls after a warm-up. A
    card the trace shows none of them on is missing from the result (the
    tracer misses K5's launches on the H100)."""
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    by = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names):
            by[e.device_index] += e.time_range.elapsed_us() / 1e3 / reps
    return dict(sorted(by.items()))


def card_exchange_times(ctx, mesh):
    """K5 at m6's and K6 at m3's shapes over this process's cards, with
    the other processes' regions on the first card (captured from the
    queries, which every process runs): the call's event on the first card
    (which waits for every card), its host wall between synchronizes of
    every card, each card's kernel-only ms, the call's host ms, and each
    card's bytes over NVLink, bytes of its own HBM and bound, as phase 14
    counts them. K6 is timed without the processes' scale agreement, a
    collective the processes would have to enter in step: the counted run
    agreed it."""
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.parallel import shuffle as sh
    from datafusion_tpu_torch.utils.roofline import chip_hbm_gbps, chip_nvlink_gbps

    (a5, kw5), = capture(sh, "ragged_exchange", lambda: ctx.sql(MESH_QUERIES[5][1]))[-1:]
    (a6, kw6), = capture(sh, "ragged_exchange_fold", lambda: ctx.sql(MESH_QUERIES[2][1]))[-1:]
    check(kw5["cards"] == mesh.devices and kw6["cards"] == mesh.devices and kw6["agree"] is not None,
          "phase 12: the exchanges did not take the process's cards and the processes' scale")
    devs = list(mesh.devices)
    send_cards = [mesh.card_index(j - mesh.first) if 0 <= j - mesh.first < mesh.n_local else 0
                  for j in range(mesh.n_dev)]
    sends, sizes = a5
    gids, vals, masks, sizes6 = a6
    kw6 = dict(kw6, agree=None)
    width6 = 4 + sum(t.element_size() for t in {id(t): t for t in vals[0] if t is not None}.values()) + len(masks[0])
    out = {}
    for name, call, kernels, sz, rows_of, width in (
            ("K5", lambda: rs.ragged_exchange(sends, sizes, **kw5), ("ragged_exchange_kernel",), sizes,
             lambda c: -(-c // kw5["chunk"]) * kw5["chunk"], sum(t.element_size() for t in sends[0])),
            ("K6", lambda: rs.ragged_exchange_fold(gids, vals, masks, sizes6, **kw6),
             ("ragged_exchange_fold_kernel", "ragged_scale_kernel"), sizes6, lambda c: c, width6)):
        peer, own = cross_bytes(sz, devs, rows_of, width, send_cards)
        bound = [max(p / (chip_nvlink_gbps(d) * 1e9), b / (chip_hbm_gbps(d) * 1e9)) * 1e3
                 for p, b, d in zip(peer, own, devs)]
        out[name] = dict(ms=time_ms(call), wall_ms=cards_ms(call, devs), kernel_ms=kernel_ms_by_card(call, kernels, devs),
                         queued_ms=queued_ms(call), host_ms=host_only_ms(call), nvlink_bytes=peer, own_bytes=own,
                         bound_ms=bound, rows=int(sz.sum()))
    return out


def multi_worker(rank, port_no, tmp, world=MULTI_WORLD, cards_per_process=1):
    """One process of phase 12: join the group of `world` processes of
    `cards_per_process` cards each and, over each of its two meshes
    (`worker_meshes`), hold its share of big and its blocks of orders on
    its cards, read its own CSV files, run every query of MULTI_QUERIES and
    SHARD_QUERIES (launches counted by logical card), fold with the first
    process's receivers 2^50 below the others', and INSERT into a rank
    table of INSERT_ROWS rows and query it; then the meshes' warm walls in
    turns and, with cards of its own, K5's and K6's times per card. Writes
    each result, route, EXPLAIN, launch count and time to `tmp`/rank<rank>.*."""
    import torch.distributed as dist

    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.parallel import collectives as C

    backend = port.initialize_multihost(f"127.0.0.1:{port_no}", world, rank, cards_per_process=cards_per_process)
    meshes = worker_meshes(port, 8 // world, cards_per_process)
    dev = meshes["one"].device
    log(f"rank {rank} of {world}: backend {backend}; cards {[str(d) for d in meshes['cards'].devices]}")
    t0 = time.perf_counter()
    big, orders = multi_tables(port, dev, rank, world)
    ins_big, _ = multi_tables(port, dev, rank, world, rows=INSERT_ROWS)
    s_schema, d_schema = shard_schemas(port)
    queries = [(n, q) for n, q, _ in MULTI_QUERIES + SHARD_QUERIES]
    arrays, info, ctxs = {}, {"backend": backend, "card": str(dev), "rows_on_card": big.num_rows,
                              "transport": "pinned host staging" if backend == "gloo" else "device", "layouts": {}}, {}
    for lay, mesh in meshes.items():
        ctx = port.ExecutionContext(mesh=mesh)
        t = time.perf_counter()
        port.register_table_shards(ctx, "big", big)
        ctx.register_table("orders", orders)
        port.register_csv_shards(ctx, "s", os.path.join(tmp, f"s{rank}.csv"), s_schema, has_header=False)
        port.register_csv_shards(ctx, "d", os.path.join(tmp, f"d{rank}.csv"), d_schema, has_header=False)
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.synchronize(d)
        setup_s = time.perf_counter() - t
        explain = {n: [ln for ln in ctx.sql(f"EXPLAIN VERBOSE {q}").result_str().splitlines()
                       if ln.startswith("physical: ")] for n, q in queries}
        bytes0, live0, calls0 = C.transport.bytes, C.transport.live_bytes, C.transport.calls
        results, walls, per_query, per_card = {}, {}, {}, {}
        for n, q in queries:
            before = card_launch_counts()
            res, w, counts, _ = run_counted([(n, ctx, q)])
            results.update(res)
            walls.update(w)
            per_query.update(counts)
            per_card[n] = {k: dict(v - before[k]) for k, v in card_launch_counts().items()}
        run_bytes, run_live = C.transport.bytes - bytes0, C.transport.live_bytes - live0
        run_calls = C.transport.calls - calls0
        fold_spread = fold_spread_equal(mesh, dev)
        ins = port.ExecutionContext(mesh=mesh)
        port.register_table_shards(ins, "big", ins_big)
        ins.sql(INSERT_SQL)
        for n, q, _ in INSERT_QUERIES:
            results[f"ins_{n}"] = ins.sql(q)
        ins_kind = type(ins.table("big")).__name__
        del ins
        meta = {}
        for n, res in results.items():
            for j, (d, v) in enumerate(res.cols):
                arrays[f"{lay}_{n}_d{j}"] = d
                if v is not None:
                    arrays[f"{lay}_{n}_v{j}"] = v
            meta[n] = {"dicts": res.dicts, "routes": list(res.routes), "explain": explain.get(n),
                       "launches": per_query.get(n), "card_launches": per_card.get(n), "first_ms": walls.get(n),
                       "columns": len(res.cols)}
        info["layouts"][lay] = {"cards": [str(d) for d in mesh.devices], "setup_s": setup_s, "cross_bytes": run_bytes,
                                "live_bytes": run_live, "calls": run_calls, "queries": meta,
                                "fold_spread_equal": fold_spread, "insert_table": ins_kind, "warm_ms": {}}
        ctxs[lay] = ctx
    own_cards = cards_per_process > 1
    turns = ["one", "cards", "cards", "one"] if own_cards else ["one"]
    for n, q in queries:  # warm walls, the layouts in turns where the process has cards of its own
        ws = collections.defaultdict(list)
        for lay in turns:
            ws[lay].append(warm_wall_ms(ctxs[lay], q, 3 if own_cards else 5, meshes[lay].devices))
        for lay, v in ws.items():
            info["layouts"][lay]["warm_ms"][n] = min(v)
    if own_cards:
        info["exchange_times"] = card_exchange_times(ctxs["cards"], meshes["cards"])
    info["setup_s"] = time.perf_counter() - t0
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.destroy_process_group()


FOLD_SPREAD_ROWS = 1 << 20  # rows of each shard in phase 12's fold with a 2^50 spread
FOLD_SPREAD_OPS = ("sum", "count", "max", "sum")


def fold_spread_shard(shard, n_dev, n_first, dev):
    """Global shard `shard`'s fold inputs from its own seed, on `dev`:
    packed ids in [0, 10020) (some past the 10001 groups), f64 values from
    2^-20 to 2^30 with cancellation, a mask for the last SUM; a row bound
    for one of the first process's receivers (id % n_dev below its
    `n_first` shards) has its value 2^50 smaller."""
    rng = np.random.default_rng(SEED + 1200 + shard)
    n = FOLD_SPREAD_ROWS
    gid = rng.integers(0, 10020, n)
    x = 2.0 ** rng.uniform(-20, 30, n) * rng.choice([-1.0, 1.0], n)
    x[1::3] = -x[0::3][: len(x[1::3])]
    x[gid % n_dev < n_first] *= SPREAD
    xt = torch.from_numpy(x).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    return torch.from_numpy(gid.astype(np.int32)).to(dev), [xt, None, xt, xt], [None, None, None, mask]


def fold_spread_equal(mesh, dev):
    """`exchange_fold` over the spanning mesh, each local shard's inputs
    on its card, the first process's receivers' values 2^50 below the
    others' (K6 with remote senders and the processes' agreed float-SUM
    scale), against one launch over all of the mesh's shards on this
    process's card `dev`: True when this process's receivers' tables
    equal that launch's bit for bit."""
    from datafusion_tpu_torch.parallel.shuffle import exchange_fold

    def fold(shards, m):
        ins = [fold_spread_shard(g, mesh.n_dev, mesh.n_local, dev if m is None else m.card_of(g - m.first))
               for g in shards]
        return exchange_fold([g for g, _, _ in ins], [v for _, v, _ in ins], [k for _, _, k in ins],
                             ops=FOLD_SPREAD_OPS, num_groups=10001, n_dev=mesh.n_dev, mesh=m)

    got = fold(range(mesh.first, mesh.first + mesh.n_local), mesh)
    want = fold(range(mesh.n_dev), None)[mesh.first: mesh.first + mesh.n_local]
    return all(same_bits(x.to(dev), y) for g, w in zip(got, want) for x, y in zip(g, w))


def rank_result(res_like, arrays, meta, name):
    """A rank's result of `name` as a ResultTable with the schema of the
    one-card result `res_like`."""
    from datafusion_tpu_torch.exec.result import ResultTable

    cols = [(arrays[f"{name}_d{j}"], arrays.get(f"{name}_v{j}")) for j in range(meta["columns"])]
    return ResultTable(res_like.schema, cols, [None if d is None else tuple(d) for d in meta["dicts"]])


def rows_by_keys(res):
    """`res` with its rows ordered by its non-float columns (a GROUP BY on
    the mesh returns its groups shard by shard, in no order one card
    shares)."""
    from datafusion_tpu_torch.exec.result import ResultTable

    keys = [d for d, _ in res.cols if d.dtype.kind != "f"]
    order = np.lexsort(keys[::-1]) if keys else np.arange(res.num_rows)
    return ResultTable(res.schema, [(d[order], None if v is None else v[order]) for d, v in res.cols], res.dicts)


def materialize_ms(cq, out, reps=5):
    """(first ms, warm median ms, bytes) of `to_host` (cq.host_columns) on
    the device result `out`, and the same for the old path, one pageable
    `.cpu()` per column after a boolean-mask index; the two results must
    be equal bit for bit."""
    from datafusion_tpu_torch.ops.expr_eval import broadcast_col

    def pageable():
        cols = [broadcast_col(c, out.capacity) for c in out.cols]
        return [(d[out.sel].cpu().numpy(), None if v is None else v[out.sel].cpu().numpy()) for d, v in cols]

    stats = {}
    for name, fn in (("to_host", lambda: cq.host_columns(out)), ("pageable", pageable)):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cols = fn()
            times.append((time.perf_counter() - t) * 1e3)
        nbytes = sum(d.nbytes + (0 if v is None else v.nbytes) for d, v in cols)
        stats[name] = (times[0], statistics.median(times[1:]), nbytes, cols)
    def bits(x):
        return x.dtype, x.shape, x.view(np.uint8).tobytes()

    a, b = stats["to_host"][3], stats["pageable"][3]
    check(all(bits(x) == bits(y) and (vx is None) == (vy is None) and (vx is None or np.array_equal(vx, vy))
              for (x, vx), (y, vy) in zip(a, b)), "to_host differs from the per-column .cpu() copy")
    return {k: v[:3] for k, v in stats.items()}


def multi_round(port, one, want, world, cards_per_process, dev):
    """One group of phase 12's processes (`multi_rounds`): start `world`
    processes of `cards_per_process` cards each (`--rank`), then hold
    every rank's results on both of its meshes to one card (`want`, and
    the CSV-shard queries over this group's files), its routes and
    EXPLAIN to every other rank's, its K5 / K6 launches on every logical
    card, and its 2^50-spread fold to one launch."""
    import socket
    import tempfile

    tag = f"{world} processes x {cards_per_process} card(s)"
    tmp = tempfile.TemporaryDirectory()
    try:
        write_shard_csvs(tmp.name, world)
        s_schema, d_schema = shard_schemas(port)
        sh = shard_arrays(world)
        vocab = tuple(sorted(w for v, _, _, _ in sh for w in v))
        remap = [np.searchsorted(vocab, v).astype(np.int32) for v, _, _, _ in sh]
        one.register_table("s", port.Table.from_arrays(s_schema, [
            (np.concatenate([r[t] for r, (_, t, _, _) in zip(remap, sh)]), vocab),
            np.concatenate([k for _, _, k, _ in sh]), np.concatenate([v for _, _, _, v in sh])], device=dev))
        one.register_table("d", port.Table.from_arrays(d_schema, [
            (np.arange(len(vocab), dtype=np.int32), vocab),
            np.array([p * 100 + i for p in range(world) for i in range(7)], np.int64)], device=dev))
        want = dict(want, **{n: one.sql(q) for n, q, _ in SHARD_QUERIES})
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port_no = sock.getsockname()[1]
        paths = [os.path.join(ROOT, "chiprun_out", f"phase12_w{world}c{cards_per_process}_rank{r}.txt")
                 for r in range(world)]
        logs = [open(p, "w") for p in paths]
        t_run = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), str(port_no), tmp.name,
                                   str(world), str(cards_per_process)], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=420)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        run_s = time.perf_counter() - t_run
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(paths[r]) as f:
                    log(f.read()[-3000:])
            check(p.returncode == 0, f"phase 12 ({tag}) rank {r} exited with {p.returncode}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp.name, f"rank{r}.json")) as f:
                info = json.load(f)
            ranks.append((info, dict(np.load(os.path.join(tmp.name, f"rank{r}.npz")))))
    finally:
        tmp.cleanup()
    info0 = ranks[0][0]
    log(f"phase 12 ({tag}): backend {info0['backend']} (CUDA tensors cross processes by {info0['transport']}), "
        f"{info0['rows_on_card']} of big's {MULTI_ROWS} rows in each process; each process's meshes' cards "
        + json.dumps([{lay: i["layouts"][lay]["cards"] for lay in LAYOUTS} for i, _ in ranks])
        + f"; processes ran {run_s:.1f} s (set-up and both meshes {[round(i['setup_s'], 1) for i, _ in ranks]} s)")
    for lay in LAYOUTS:
        lays = [i["layouts"][lay] for i, _ in ranks]
        n_logical = len(lays[0]["cards"])
        log(f"phase 12 ({tag}) mesh '{lay}' ({n_logical} logical card(s) a process): registered in "
            f"{[round(x['setup_s'], 2) for x in lays]} s; cross-process bytes sent in the counted run "
            f"{[x['cross_bytes'] for x in lays]} over {[x['calls'] for x in lays]} collectives, of which "
            f"{[x['live_bytes'] for x in lays]} carry rows (padding share "
            f"{[round(1 - x['live_bytes'] / max(x['cross_bytes'], 1), 4) for x in lays]}); the INSERT rebuilt a "
            f"{lays[0]['insert_table']}")
        check(all(x["fold_spread_equal"] for x in lays),
              f"phase 12 ({tag}, {lay}): K6 over the processes, one process's receivers 2^50 below, differs from one "
              "launch")
        names = [(n, q) for n, q, _ in MULTI_QUERIES + SHARD_QUERIES] + [(f"ins_{n}", q) for n, q, _ in INSERT_QUERIES]
        for n, q in names:
            metas = [x["queries"][n] for x in lays]
            ordered = "ORDER BY" in q  # else the mesh returns its groups shard by shard
            for r, (_, arrs) in enumerate(ranks):
                got = rank_result(want[n], arrs, metas[r], f"{lay}_{n}")
                same_result(f"phase 12 ({tag}, {lay}) {n} rank {r}", got if ordered else rows_by_keys(got),
                            want[n] if ordered else rows_by_keys(want[n]))
            check(all(m["routes"] == metas[0]["routes"] for m in metas),
                  f"phase 12 ({tag}, {lay}) {n}: the ranks took different routes")
            if n.startswith("ins_"):
                continue
            check(all(m["explain"] == metas[0]["explain"] for m in metas),
                  f"phase 12 ({tag}, {lay}) {n}: the ranks' EXPLAIN differs")
            for r, m in enumerate(metas):
                for kern, qs in (("ragged_exchange", MULTI_K5), ("ragged_exchange_fold", MULTI_K6)):
                    if n in qs:
                        by_card = m["card_launches"][kern]
                        check(m["launches"][kern] > 0 and sorted(int(c) for c in by_card) == list(range(n_logical)),
                              f"phase 12 ({tag}, {lay}) {n} rank {r} launched {kern} on logical cards {by_card}, "
                              f"not on each of {n_logical}")
            log(f"phase 12 ({tag}, {lay}) {n}: {want[n].num_rows} rows == one card on every rank; routes "
                f"{metas[0]['routes']}; launches {[launched(m['launches']) for m in metas]}, K5 / K6 by logical card "
                f"{[m['card_launches'] for m in metas]}; first wall {[round(m['first_ms'], 3) for m in metas]} ms, "
                f"warm {[lays[r]['warm_ms'].get(n) for r in range(world)]} ms")
        log(f"phase 12 ({tag}, {lay}): INSERT into a rank table of {INSERT_ROWS} rows, then m1 and m3, equal one card "
            "after the same INSERT on every rank")
    for r, (info, _) in enumerate(ranks):
        for name, st in info.get("exchange_times", {}).items():
            log(f"phase 12 ({tag}) rank {r} {name} over its cards {info['layouts']['cards']['cards']} with the other "
                f"processes' regions on its first card: {st['rows']} rows; event {st['ms']:.3f} ms (host wall between "
                f"synchronizes {st['wall_ms']:.3f}), queued device {st['queued_ms']:.3f} ms, kernel only by card "
                f"{json.dumps({k: round(v, 3) for k, v in st['kernel_ms'].items()})} ms (a card the trace missed is "
                f"absent), host {st['host_ms']:.3f} ms; bytes over NVLink by card {st['nvlink_bytes']}, own HBM bytes "
                f"{st['own_bytes']}, bound by card {[round(b, 3) for b in st['bound_ms']]} ms")
    return ranks


def phase_multiprocess(dev, big, arrays):
    """Phase 12: m1-m8, m10, m11, m15 and the JAX package's five CSV-shard
    queries over several processes as one mesh, each process over two
    meshes (its shards on one card, and over its cards or two logical
    cards of one), every result equal to the same query on one card over
    the whole tables; an INSERT into a rank table, then m1 and m3, equal
    to one card after the same INSERT (`multi_round`, `multi_rounds`). On
    four or more cards the warm walls of one process over four cards
    (phase 14's mesh) come before and after the groups. Then q1's and
    d1's materialization through `to_host` against the old per-column
    pageable `.cpu()`."""
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.exec.compiler import compile_plan
    from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection

    t12 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    one = port.ExecutionContext()
    mbig, orders = multi_tables(port, dev)
    one.register_table("big", mbig)
    one.register_table("orders", orders)
    want = {n: one.sql(q) for n, q, _ in MULTI_QUERIES}
    ins_one = port.ExecutionContext()
    ins_one.register_table("big", multi_tables(port, dev, rows=INSERT_ROWS)[0])
    ins_one.sql(INSERT_SQL)
    want.update({f"ins_{n}": ins_one.sql(q) for n, q, _ in INSERT_QUERIES})
    del ins_one
    one_ms = {n: warm_wall_ms(one, q) for n, q, _ in MULTI_QUERIES}
    four, four_ms = None, collections.defaultdict(list)
    if n_cards >= 4:  # phase 14's layout: one process over four cards
        four = port.ExecutionContext(mesh=port.make_mesh(8, devices=[torch.device("cuda", i) for i in range(4)]))
        four.register_table("big", mbig)
        four.register_table("orders", orders)
    del mbig

    def four_walls():
        for n, q, _ in MULTI_QUERIES:
            four_ms[n].append(warm_wall_ms(four, q, 3, four.mesh.devices))

    if four is not None:
        four_walls()
    groups = {(w, c): multi_round(port, one, want, w, c, dev) for w, c in multi_rounds(n_cards)}
    if four is not None:
        four_walls()
        log("phase 12 warm walls (ms) by query: one card (8 shards), one process over four cards (phase 14's mesh; "
            "before and after the process groups), and each group's meshes, rank 0: "
            + json.dumps({n: {"one card": round(one_ms[n], 3), "one process x 4 cards": [round(x, 3) for x in four_ms[n]],
                              **{f"{w}x{c} {lay}": round(r[0][0]["layouts"][lay]["warm_ms"][n], 3)
                                 for (w, c), r in groups.items() for lay in LAYOUTS
                                 if n in r[0][0]["layouts"][lay]["warm_ms"]}}
                          for n, _, _ in MULTI_QUERIES}))
    else:
        log("phase 12 warm walls (ms) by query, one card (8 shards) and the processes' one-card mesh, rank 0: "
            + json.dumps({n: [round(one_ms[n], 3)] + [round(r[0][0]["layouts"]["one"]["warm_ms"][n], 3)
                                                      for r in groups.values()] for n, _, _ in MULTI_QUERIES}))
    del one, want, four

    dt, ts, ts_valid = date_arrays()
    tables = {"big": big, "bigd": dates_table(port, big, dt, ts, ts_valid)}
    for name, q, tname in (("q1", MAIN_QUERIES[0][1], "big"), ("d1", DATE_QUERIES[0][1], "bigd")):
        ctx = port.ExecutionContext()
        ctx.register_table(tname, tables[tname])
        cq = compile_plan(push_down_projection(push_down_filters(ctx.plan(q))), {tname: tables[tname]}, device=dev)
        out = cq.device_result()
        st = materialize_ms(cq, out)
        nbytes = st["to_host"][2]
        log(f"phase 12 materialization {name}: {nbytes / 1e6:.1f} MB of {out.capacity} rows' selected cells; "
            f"to_host first {st['to_host'][0]:.3f} ms, warm {st['to_host'][1]:.3f} ms "
            f"({nbytes / st['to_host'][1] / 1e6:.2f} GB/s); pageable .cpu() per column first "
            f"{st['pageable'][0]:.3f} ms, warm {st['pageable'][1]:.3f} ms ({nbytes / st['pageable'][1] / 1e6:.2f} GB/s)")
    log(f"phase 12 processes and materialization: {time.perf_counter() - t12:.1f} s")


def quick_multicard(dev):
    """`python3 chip_smoke.py --phase14`: the build and phase 14 without
    the other phases (their oracle-held results too: phase 14 then holds
    the cards to the one-card mesh alone). It prints neither the kernels'
    line nor the last line."""
    import datafusion_tpu_torch as port

    arrays = main_arrays()
    big = main_table(port, arrays)
    tables = join_tables(port, big, join_arrays(), dev)
    stats = {"ragged_exchange": {}, "ragged_exchange_fold": {}}
    stats.update({k: {} for k in kernel_counters()})
    phase_multicard(dev, big, arrays, tables, stats)
    log(json.dumps({k: v["cross_card"] for k, v in stats.items() if "cross_card" in v}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        sys.exit(1)
    import datafusion_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if sys.argv[1:2] == ["--rank"]:  # one process of phase 12, started by phase_multiprocess
        multi_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]), int(sys.argv[6]))
        return

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_build()
    if sys.argv[1:2] == ["--phase14"]:  # a rehearsal of phase 14 alone
        quick_multicard(dev)
        return
    if sys.argv[1:2] == ["--phase12"]:  # a rehearsal of phase 12 alone
        arrays = main_arrays()
        phase_multiprocess(dev, main_table(datafusion_tpu_torch, arrays), arrays)
        return
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    k2_err["sorted"] = max(k2_err["sorted"], phase_k2_sorted(dev))
    k3_err, k4_err = phase_k3k4(dev)
    k5_err, k6_err = phase_k5k6(dev)
    src = "datafusion_tpu_torch/csrc"
    kernel_stats = {
        "fused_stage": {"route": "cuda", "source": f"{src}/fused_stage.cu",
                        "replaces": "datafusion_tpu/ops/pallas/fused_stage.py:57",
                        "max_abs_err": max(k1_err.values())},
        "segreduce_sorted": {"route": "cuda", "source": f"{src}/segreduce.cu",
                             "replaces": "datafusion_tpu/ops/pallas/segreduce.py:524",
                             "max_abs_err": k2_err["sorted"]},
        "segreduce_dense": {"route": "cuda", "source": f"{src}/segreduce.cu",
                            "replaces": "datafusion_tpu/ops/pallas/segreduce.py:524",
                            "max_abs_err": k2_err["dense"]},
        "slab_partition": {"route": "cuda", "source": f"{src}/partition.cu",
                           "replaces": "datafusion_tpu/ops/pallas/partition.py:219", "max_abs_err": k3_err},
        "windowed_reduce": {"route": "cuda", "source": f"{src}/partition.cu",
                            "replaces": "datafusion_tpu/ops/pallas/partition.py:368", "max_abs_err": k4_err},
        "ragged_exchange": {"route": "cuda", "source": f"{src}/ragged_shuffle.cu",
                            "replaces": "datafusion_tpu/ops/pallas/ragged_shuffle.py:544", "max_abs_err": k5_err},
        "ragged_exchange_fold": {"route": "cuda", "source": f"{src}/ragged_shuffle.cu",
                                 "replaces": "datafusion_tpu/ops/pallas/ragged_shuffle.py:456", "max_abs_err": k6_err},
    }
    arrays = main_arrays()
    big = phase_main_path(dev, kernel_stats, arrays)
    phase_csv(dev)
    t11 = time.perf_counter()
    phase_ingest(dev, arrays, kernel_stats)
    log(f"phase 11 ingest and session API: {time.perf_counter() - t11:.1f} s")
    phase_mesh(dev, big, arrays, kernel_stats)
    joins = phase_joins(dev, big, arrays, kernel_stats)
    phase_windows(dev, big, arrays, joins["tables"], kernel_stats)
    phase_aggregates(dev, big, arrays, kernel_stats)
    phase_multicard(dev, big, arrays, joins["tables"], kernel_stats)
    phase_tpch(dev, kernel_stats, phase_dates(dev, big, arrays, kernel_stats))
    phase_determinism(dev, big)
    phase_multiprocess(dev, big, arrays)
    kernels = []
    for name, s in kernel_stats.items():
        ops_bound = s.pop("ops_bound_ms")
        bound_by = "bytes" if s["bound_ms"] >= ops_bound else "operations"
        s["bound_ms"] = max(s["bound_ms"], ops_bound)
        kernels.append({"name": name, **s, "bound_by": bound_by})
        log(f"kernel {name}: {s['ms']:.3f} ms (kernel only {s['kernel_ms']:.3f}, host {s['host_ms']:.3f}) vs bound "
            f"{s['bound_ms']:.3f} ms "
            f"({bound_by}), plain {s['plain_ms']:.3f} ms, library {s['library_ms']}, launches {s['launches']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
