"""K5 and K6 split over cards, their CUDA source run on the CPU.

On a mesh of several cards (or of several processes) the ragged exchange
and the exchange fold take one launch per card over that card's
receivers, with every shard of the mesh as a sender
(ops/pallas/ragged_shuffle.py `cards`). This file builds
`datafusion_tpu_torch/csrc/ragged_shuffle.cu` alone against the emulated
CUDA runtime of tests/test_torch_kernel_emu.py and launches each kernel
as two halves, the receivers split and every sender kept, as the wrapper
packs them (`exchange_args`, `fold_pointer_table`, `fold_tables`,
`c_entries`), against one launch over every receiver:

  * K5: every receive buffer bit-equal, tails included;
  * K6: every table bit-equal, with float SUMs whose values on one half
    lie 2^50 below the other's. The halves take the mesh's scale (each
    half's first pass alone, the largest scale word written into both,
    then the folds); with each half's own scale the small half's sums
    round on a finer grid and differ, which the test shows as well. A
    mesh that spans processes launches the same way (its receivers are
    one process's), so this holds its scale agreement too;
  * `parallel/shuffle.py` `exchange_fold` over a mesh of two processes
    (Gloo), with the wrapper's card path launching the emulated kernel on
    CPU tensors (`_emulated_card`): each process's tables bit-equal to one
    process's launch when its receivers' values lie 2^50 below the other
    process's, and different when the processes do not agree on the
    scale;
  * both exchanges over two processes of two logical cards each: K5's
    received rows and K6's tables (with the same 2^50 spread) bit-equal
    to one process's single launch over all 8 shards, each card's launch
    taking the remote senders' regions from the first card.

The file is the two-process tests' worker: `python
tests/test_torch_multicard_emu.py LIB PORT RANK WORLD OUT AGREE CARDS`.
"""

import contextlib
import ctypes
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
from datafusion_tpu_torch.ops.pallas import segreduce as sr
from test_torch_kernel_emu import EMU_RUNTIME, _bits


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """ragged_shuffle.cu built against EMU_RUNTIME, as a ctypes library."""
    from datafusion_tpu_torch.ops.pallas.cuda_lib import SRC_DIR

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' emulation")
    d = tmp_path_factory.mktemp("multicard_emu")
    (d / "cuda_runtime.h").write_text(EMU_RUNTIME)
    src = (SRC_DIR / "ragged_shuffle.cu").read_text()
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];", "unsigned char* smem = emu_smem;")
    src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
    (d / "ragged_shuffle.cpp").write_text(src)
    lib_path = d / "libemu_k56.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread", "-shared",
                          "-Wno-unknown-pragmas", f"-I{d}", f"-I{SRC_DIR}", str(d / "ragged_shuffle.cpp"), "-o",
                          str(lib_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout
    return _load(lib_path)


def _load(lib_path):
    """The emulated library at `lib_path`, its C entries typed as
    ops/pallas/cuda_lib.py types them."""
    lib = ctypes.CDLL(str(lib_path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_ragged_exchange.argtypes = [vp, vp, i32, i32, i64, i32, vp]
    lib.dft_ragged_exchange_fold.argtypes = [vp, vp, i32, i32, i64, i32, i32, i32, vp, vp, vp, vp, i32, vp]
    lib.dft_enable_peer_access.argtypes = [i32, i32]
    for f in (lib.dft_ragged_exchange, lib.dft_ragged_exchange_fold, lib.dft_enable_peer_access):
        f.restype = i32
    assert lib.dft_ragged_exchange_args_size() == ctypes.sizeof(rs.ExchangeArgs)
    return lib


HALVES = ((0, 3), (3, 6))  # the receivers of each card: 6 receivers on 2 cards
N_SEND, N_RECV = 6, 6


def _sizes(rng, split_cap):
    sizes = rng.integers(0, split_cap + 1, (N_SEND, N_RECV))
    sizes[0, -1], sizes[1, :] = split_cap, 0  # a full region, and a sender with nothing to send
    return torch.from_numpy(sizes.astype(np.int32))


def _exchange(lib, sends, sizes, lo, hi, split_cap, chunk):
    """K5 over receivers [lo, hi) with every sender, as the wrapper packs
    one card's launch, into new buffers; returns them."""
    nr = hi - lo
    part = [rs._regions_from(a, lo, hi, split_cap) for a in sends]
    bufs = [torch.full((nr * N_SEND * split_cap,), 0x5A, dtype=torch.uint8).to(t.dtype) for t in sends[0]]
    block = sizes[:, lo:hi].contiguous()
    for x in rs.exchange_args(part, bufs):
        assert lib.dft_ragged_exchange(ctypes.byref(x), block.data_ptr(), N_SEND, nr, split_cap, chunk, None) == 0
    return bufs


def test_ragged_exchange_per_card_equals_one_launch(emu):
    """Two per-card K5 launches (receivers 0-2 and 3-5, every sender read
    from its own region 0 or 3) fill the same bits as one launch over all
    six receivers: each half's buffers are the whole launch's halves."""
    rng = np.random.default_rng(5)
    split_cap, chunk = 512, 128
    sizes = _sizes(rng, split_cap)
    dtypes = (torch.float64, torch.uint8, torch.int32, torch.int16)

    def region(dt):
        return torch.from_numpy(rng.integers(0, 256, N_RECV * split_cap * 8).astype(np.uint8)).view(dt)[
            : N_RECV * split_cap]

    sends = [[region(dt) for dt in dtypes] for _ in range(N_SEND)]
    whole = _exchange(emu, sends, sizes, 0, N_RECV, split_cap, chunk)
    width = N_SEND * split_cap
    for lo, hi in HALVES:
        half = _exchange(emu, sends, sizes, lo, hi, split_cap, chunk)
        for a, (h, w) in enumerate(zip(half, whole)):
            assert torch.equal(_bits(h), _bits(w[lo * width: hi * width])), (lo, a)
    assert rs.card_groups(("cpu", "cpu"), N_RECV, sizes) == [(torch.device("cpu"), lo, hi) for lo, hi in HALVES]


OPS, MASK_MAP = ("sum", "count", "sum", "max", "min", "sum"), (0, 0, 1, 1, 0, 0)


def _fold_case(rng, split_cap, num_groups, spread):
    """K6's inputs over 6 senders and 6 receivers: f64 values from 2^-20
    to 2^30 with cancellation, their values for the first half's
    receivers `spread` times smaller, a masked f32 SUM, an i64 SUM, MAX
    and MIN, ids past num_groups."""
    width = N_RECV * split_cap
    sizes = torch.from_numpy(rng.integers(split_cap // 2, split_cap + 1, (N_SEND, N_RECV)).astype(np.int32))
    gids, vals, masks = [], [], []
    for _ in range(N_SEND):
        x = 2.0 ** rng.uniform(-20, 30, width) * rng.choice([-1.0, 1.0], width)
        x[1::3] = -x[0::3][: len(x[1::3])]
        x[: HALVES[0][1] * split_cap] *= spread
        xt = torch.from_numpy(x)
        it = torch.from_numpy(rng.integers(-10**12, 10**12, width))
        gids.append(torch.from_numpy(rng.integers(0, num_groups + 9, width).astype(np.int32)))
        vals.append([xt, None, xt.float(), xt, it, it])
        masks.append([torch.from_numpy(rng.random(width) < 0.7)])
    return gids, vals, masks, sizes


def _fold(case, lo, hi, num_groups):
    """One card's K6 tables over receivers [lo, hi), as the wrapper makes
    them: (FoldTables, launches, what `_run` launches over)."""
    gids, vals, masks, sizes = case
    launches = sr.fold_launches(sr.fold_widths(OPS, vals[0]), num_groups)
    ft = sr.fold_tables(OPS, vals[0], num_groups, "cpu", lead=(hi - lo,), counters=len(launches), fixed=True)
    return ft, launches, (gids, vals, masks, sizes, lo, hi)


def _run(lib, ft, launches, args, split_cap, num_groups, phases):
    """K6 over receivers [lo, hi) with every sender, as the wrapper packs
    one card's launches, with `phases` (1: the first pass, 2: the fold, 3:
    both)."""
    gids, vals, masks, sizes, lo, hi = args
    g_p = [rs._regions_from([g], lo, hi, split_cap)[0] for g in gids]
    v_p = [rs._regions_from(v, lo, hi, split_cap) for v in vals]
    per_op = [rs._op_masks(rs._regions_from(m, lo, hi, split_cap), MASK_MAP) for m in masks]
    block = sizes[:, lo:hi].contiguous()
    for (a, b, reps), done in zip(launches, ft.counters):
        ptrs = torch.tensor(rs.fold_pointer_table(g_p, v_p, per_op, range(a, b)), dtype=torch.int64)
        assert lib.dft_ragged_exchange_fold(ptrs.data_ptr(), block.data_ptr(), N_SEND, hi - lo, split_cap,
                                            num_groups, reps, b - a, *sr.c_entries(OPS, vals[0], ft, a, b, fixed=True),
                                            done, phases, None) == 0


def _tables(fts):
    """Each op's tables of the halves, stacked receiver-major."""
    return [torch.cat([ft.tables[a] for ft in fts]) for a in range(len(OPS))]


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("spread", [1.0, 2.0**-50], ids=["same scale", "halves 2^50 apart"])
def test_exchange_fold_per_card_takes_the_mesh_scale(emu, monkeypatch, spread):
    """K6 as two per-card launches (or two processes' launches) equals one
    launch over all six receivers bit for bit, float SUMs included, when
    the halves agree on the scale: each half's first pass, the larger
    word into both, then each half's fold. With the halves 2^50 apart
    and each half on its own scale (`phases` 3), the small half's float
    SUMs differ from the whole launch's."""
    monkeypatch.setenv("EMU_SMS", "3")
    rng = np.random.default_rng(50)
    split_cap, num_groups = 256, 40
    case = _fold_case(rng, split_cap, num_groups, spread)
    ft, launches, args = _fold(case, 0, N_RECV, num_groups)
    _run(emu, ft, launches, args, split_cap, num_groups, 3)
    whole = ft.tables

    halves = [_fold(case, lo, hi, num_groups) for lo, hi in HALVES]
    for ft_h, launches_h, args_h in halves:
        _run(emu, ft_h, launches_h, args_h, split_cap, num_groups, 1)
    fix = [a for a, at in enumerate(halves[0][0].scale_at) if at is not None]
    assert fix == [0, 2]  # the f64 and the masked f32 SUM
    words = torch.stack([torch.cat([h[0].scale(a) for a in fix]) for h in halves]).amax(0)
    assert torch.equal(words, torch.cat([ft.scale(a) for a in fix]))  # the whole launch's scale
    for ft_h, _, _ in halves:
        for w, a in zip(words.unbind(0), fix):
            ft_h.scale(a).copy_(w.reshape(1))
    for ft_h, launches_h, args_h in halves:
        _run(emu, ft_h, launches_h, args_h, split_cap, num_groups, 2)
    agreed = _tables([h[0] for h in halves])
    for a in range(len(OPS)):
        assert _bits_equal(agreed[a], whole[a]), a

    own = [_fold(case, lo, hi, num_groups) for lo, hi in HALVES]
    for ft_h, launches_h, args_h in own:
        _run(emu, ft_h, launches_h, args_h, split_cap, num_groups, 3)
    alone = _tables([h[0] for h in own])
    for a in range(len(OPS)):
        if a in fix and spread != 1.0:
            assert not _bits_equal(alone[a], whole[a]), f"op {a}: a half's own scale gave the mesh's bits"
        else:
            assert _bits_equal(alone[a], whole[a]), a


def test_peer_access_entry(emu):
    """The peer-access entry: a card and itself need nothing; another card
    the emulated runtime reports reachable is enabled (0)."""
    assert emu.dft_enable_peer_access(0, 0) == 0
    assert emu.dft_enable_peer_access(0, 1) == 0


# --- exchange_fold over two processes ------------------------------------------------

FOLD_OPS = ("sum", "count", "max", "sum")
N_LOCAL, WORLD, FOLD_GROUPS = 3, 2, 240  # 3 shards a process; packed ids below 240, so 40 windows a receiver
CARD_LOCAL = 4  # the cards case: 4 shards a process, two on each of its two logical cards


class _Event:
    """A CUDA event's stand-in: the emulated kernels run on the host, in
    order, so there is nothing to wait for."""

    def record(self, stream=None):
        pass


def _emulated_card(patch, lib):
    """Let K5's and K6's wrappers take their card path on CPU tensors with
    the emulated library: the device check reports "cuda", streams,
    events and device guards are stand-ins, pinning is a no-op.
    `patch(obj, name, value)` sets an attribute (monkeypatch.setattr, or
    setattr in a worker)."""
    from datafusion_tpu_torch.ops.pallas import cuda_lib

    check_devices = rs._check_devices
    stream = types.SimpleNamespace(cuda_stream=None, wait_event=lambda e: None)
    patch(rs, "_check_devices", lambda *a: "cuda" if check_devices(*a) == "cpu" else "?")
    patch(cuda_lib, "load_library", lambda: lib)
    patch(torch.cuda, "device", lambda card: contextlib.nullcontext())
    patch(torch.cuda, "current_stream", lambda card=None: stream)
    patch(torch.cuda, "Event", _Event)
    patch(torch.Tensor, "pin_memory", lambda self: self)


def _fold_shard(shard: int, n_local: int = N_LOCAL):
    """Global shard `shard`'s fold inputs, from its own seed: packed ids
    (some past FOLD_GROUPS), f64 values from 2^-20 to 2^30 with
    cancellation, and a mask. A row bound for one of the first process's
    receivers (id % (n_local * WORLD) < n_local) has its value 2^50
    smaller."""
    rng = np.random.default_rng(900 + shard)
    n = 700 + 31 * shard
    gid = rng.integers(0, FOLD_GROUPS + 20, n)
    x = 2.0 ** rng.uniform(-20, 30, n) * rng.choice([-1.0, 1.0], n)
    x[1::3] = -x[0::3][: len(x[1::3])]
    x[gid % (n_local * WORLD) < n_local] *= 2.0 ** -50
    xt = torch.from_numpy(x)
    mask = torch.from_numpy(rng.random(n) < 0.8)
    return torch.from_numpy(gid.astype(np.int32)), [xt, None, xt, xt], [None, None, None, mask]


def _fold_over(shards, mesh, n_local: int = N_LOCAL):
    from datafusion_tpu_torch.parallel.shuffle import exchange_fold

    ins = [_fold_shard(g, n_local) for g in shards]
    return exchange_fold([g for g, _, _ in ins], [v for _, v, _ in ins], [m for _, _, m in ins], ops=FOLD_OPS,
                         num_groups=FOLD_GROUPS, n_dev=n_local * WORLD, mesh=mesh)


def _shuffle_shard(shard: int):
    """Global shard `shard`'s rows for a repartition over 8 shards, from
    its own seed: destinations, a selection, and int64, f64 (with a
    validity), bool and int32 columns."""
    rng = np.random.default_rng(700 + shard)
    n = 500 + 37 * shard
    cols = [(torch.from_numpy(rng.integers(-2**40, 2**40, n)), None),
            (torch.from_numpy(rng.normal(size=n)), torch.from_numpy(rng.random(n) < 0.9)),
            (torch.from_numpy(rng.random(n) < 0.5), None),
            (torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)), None)]
    return cols, torch.from_numpy(rng.integers(0, CARD_LOCAL * WORLD, n)), torch.from_numpy(rng.random(n) < 0.8)


def _shuffle_over(shards, mesh):
    """Each of `shards`' receivers' selected rows after a repartition (K5)
    over `mesh` (None: one process, one launch): per receiver, each
    column's data and validity at its selected slots."""
    from datafusion_tpu_torch.parallel.shuffle import repartition

    ins = [_shuffle_shard(g) for g in shards]
    recv, sels = repartition([c for c, _, _ in ins], [d for _, d, _ in ins], [s for _, _, s in ins],
                             CARD_LOCAL * WORLD, mesh=mesh)
    return [[x[sel] for d, v in cols for x in (d, v) if x is not None] for cols, sel in zip(recv, sels)]


def _fold_worker(lib_path, port, rank, world, out, agree, cards):
    """One process of the two-process exchanges: join the Gloo group, fold
    its shards over the spanning mesh on the emulated card, save its
    receivers' tables. `agree` "0" replaces the processes' agreement on
    the scale by each process's own. `cards` "2": the process's 4 shards
    lie on two logical cards, and it also saves its receivers' rows of a
    repartition (K5) over that mesh."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.parallel import shuffle

    os.environ["EMU_SMS"] = "3"
    _emulated_card(setattr, _load(lib_path))
    if agree == "0":
        shuffle.agreed_max = lambda words, mesh: words
    assert dft.initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo") == "gloo"
    if cards == "2":
        mesh = dft.global_mesh(CARD_LOCAL, device="cpu", devices=("cpu", "cpu"))
        shards = range(mesh.first, mesh.first + CARD_LOCAL)
        saved = {"fold": _fold_over(shards, mesh, CARD_LOCAL), "shuffle": _shuffle_over(shards, mesh),
                 "card_launches": [dict(rs.ragged_exchange.card_launches),
                                   dict(rs.ragged_exchange_fold.card_launches)]}
    else:
        mesh = dft.global_mesh(N_LOCAL, device="cpu")
        saved = {"fold": _fold_over(range(mesh.first, mesh.first + N_LOCAL), mesh)}
    saved["fold"] = [[x.clone() for x in t] for t in saved["fold"]]  # each its own storage
    torch.save(saved, out)
    import torch.distributed as dist

    dist.destroy_process_group()


def _two_processes(tmp_path, lib_path, agree, cards="0"):
    """Both processes' saved results, in rank order."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    outs = [tmp_path / f"fold_{agree}_{cards}_rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(lib_path), str(port), str(r), str(WORLD), str(outs[r]),
                               agree, cards], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o) for o in outs]


def test_exchange_fold_across_processes_takes_the_mesh_scale(emu, monkeypatch, tmp_path):
    """`exchange_fold` over a mesh of two processes, the first process's
    receivers' values 2^50 below the second's: the processes agree on the
    float SUMs' scale (collectives.agreed_max), so every receiver's tables
    equal one process's single launch over all six receivers bit for bit.
    Without the agreement the first process's sums round on a finer grid
    and differ."""
    monkeypatch.setenv("EMU_SMS", "3")
    _emulated_card(monkeypatch.setattr, emu)
    one = _fold_over(range(N_LOCAL * WORLD), None)
    agreed = [t for r in _two_processes(tmp_path, emu._name, "1") for t in r["fold"]]
    own = [t for r in _two_processes(tmp_path, emu._name, "0") for t in r["fold"]]
    assert len(one) == len(agreed) == len(own) == N_LOCAL * WORLD
    sums = [a for a, op in enumerate(FOLD_OPS) if op == "sum"]
    for i, (w, a, o) in enumerate(zip(one, agreed, own)):
        for k in range(len(FOLD_OPS)):
            assert _bits_equal(a[k], w[k]), (i, k)
            if i >= N_LOCAL or k not in sums:  # the second process's scale is the mesh's; other ops take none
                assert _bits_equal(o[k], w[k]), (i, k)
    assert any(not _bits_equal(o[k], w[k]) for o, w in zip(own[:N_LOCAL], one[:N_LOCAL]) for k in sums), \
        "each process's own scale gave the mesh's bits"


def test_exchanges_across_processes_and_cards_equal_one_launch(emu, monkeypatch, tmp_path):
    """K5 and K6 over a mesh of two processes of two logical cards each
    (4 shards a process): each card's launch takes its process's senders
    from their own cards and the remote senders' regions from the first
    card, where the transport left them. Every receiver's rows of a
    repartition and its fold tables, float SUMs with the first process's
    receivers' values 2^50 below the other's included, equal one
    process's single launch over all 8 shards bit for bit; each process
    launched K5 and K6 on both of its cards."""
    monkeypatch.setenv("EMU_SMS", "3")
    _emulated_card(monkeypatch.setattr, emu)
    n = CARD_LOCAL * WORLD
    one_fold = _fold_over(range(n), None, CARD_LOCAL)
    one_shuffle = _shuffle_over(range(n), None)
    ranks = _two_processes(tmp_path, emu._name, "1", "2")
    fold = [t for r in ranks for t in r["fold"]]
    shuffled = [x for r in ranks for x in r["shuffle"]]
    assert len(fold) == len(shuffled) == n
    for i in range(n):
        for k in range(len(FOLD_OPS)):
            assert _bits_equal(fold[i][k], one_fold[i][k]), (i, k)
        assert len(shuffled[i]) == len(one_shuffle[i]) == 5
        for a, (x, y) in enumerate(zip(shuffled[i], one_shuffle[i])):
            assert _bits_equal(x, y), (i, a)
    for r, got in enumerate(ranks):
        k5, k6 = got["card_launches"]
        assert sorted(k5) == sorted(k6) == [0, 1] and all(k5.values()) and all(k6.values()), (r, k5, k6)


if __name__ == "__main__":
    _fold_worker(*sys.argv[1:3], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:8])
