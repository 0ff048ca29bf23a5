"""The fold tile of K2 dense and K4 (and K3's part in K4), its CUDA source
run on the CPU with its checks shrunk.

A float SUM on the fold tile (csrc/reduce_common.cuh) keeps each digit of
a slot as two 32-bit shared words, hi = d >> 16 and lo = d & 0xffff, and
every DFT_FIX_CHECK_ROWS rows a block has folded it moves each word past
DFT_FIX_CHECK_LIMIT into the device tables. This file builds
`datafusion_tpu_torch/csrc/segreduce.cu` and `partition.cu` against the
emulated CUDA runtime of tests/test_torch_kernel_emu.py with a check at
every block step of 2048 rows and a limit of 0, so every check moves
every word that is not 0, and holds the kernels, packed as the wrappers
pack them, to `segreduce.fixed_sum_plain` bit for bit (counts and
MIN/MAX to the plain version):

  * a hot slot that takes every row, each block checking several times
    in mid-range;
  * values of alternating sign at +-2^E and just under, and far below
    (so the last digit is not 0), every digit negative in half the rows
    and the carries between the words run;
  * K4 given K3's scale words and chunk counts (`SlabFold`, the slab as
    K3 left it) against K4 with its own first pass, masked and unmasked,
    the largest |value| on a row whose id is past num_groups or whose
    mask is off, so it sets no scale; and K3's slab and info against the
    plain version's;
  * K4's split of its blocks over the buckets by K3's chunk counts, under
    several block orders (EMU_BLOCK_SEED) and grids (EMU_SMS).

Each case is at most 5,003 rows. Skips where no g++ is found.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from datafusion_tpu_torch.ops.pallas import partition as pt
from datafusion_tpu_torch.ops.pallas import segreduce as sr
from test_torch_kernel_emu import EMU_RUNTIME, _bits

CHECKS = ("-DDFT_FIX_CHECK_ROWS=2048", "-DDFT_FIX_CHECK_LIMIT=0")  # every step moves every word


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """segreduce.cu and partition.cu built against EMU_RUNTIME with the
    checks shrunk (CHECKS), as one ctypes library."""
    from datafusion_tpu_torch.ops.pallas.cuda_lib import SRC_DIR

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' emulation")
    d = tmp_path_factory.mktemp("fold_tile_emu")
    (d / "cuda_runtime.h").write_text(EMU_RUNTIME)
    procs, objs = [], []
    for name in ("segreduce.cu", "partition.cu"):
        src = (SRC_DIR / name).read_text()
        src = src.replace("extern __shared__ __align__(16) unsigned char smem[];", "unsigned char* smem = emu_smem;")
        src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        (d / f"{name}.cpp").write_text(src)
        objs.append(d / f"{name}.o")
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread", "-Wno-unknown-pragmas", *CHECKS,
             f"-I{d}", f"-I{SRC_DIR}", "-c", str(d / f"{name}.cpp"), "-o", str(objs[-1])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out
    lib_path = d / "libemu_fold.so"
    subprocess.run([gxx, "-shared", "-pthread", *map(str, objs), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_slab_partition.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, vp, vp, vp, vp, i32, i32, vp, vp, vp]
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce_slab.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    for f in (lib.dft_segreduce_dense, lib.dft_slab_partition, lib.dft_windowed_reduce, lib.dft_windowed_reduce_slab):
        f.restype = i32
    return lib


def _dense(lib, gid, vals, masks, ops, g):
    """K2 dense mode's launches, packed as ops/pallas/segreduce.py packs them."""
    launches = sr.fold_launches(sr.fold_widths(ops, vals), g)
    ft = sr.fold_tables(ops, vals, g, "cpu", counters=len(launches), fixed=True)
    for (lo, hi, reps), done in zip(launches, ft.counters):
        kinds, outs, aux = sr.c_entries(ops, vals, ft, lo, hi, fixed=True)
        assert lib.dft_segreduce_dense(gid.data_ptr(), gid.numel(), g, reps, hi - lo, kinds,
                                       *sr.c_streams(vals, masks, lo, hi), outs, aux, done, None) == 0
    return ft.tables


def _window(lib, gid, vals, masks, ops, g, slab=None):
    """K4's launches as `partition.windowed_reduce` packs them: with its
    own first pass, or with `slab` (a SlabFold) over K3's packed gid."""
    launches = sr.fold_launches(sr.fold_widths(ops, vals), pt.WINDOW)
    ft = sr.fold_tables(ops, vals, g, "cpu", counters=len(launches), fixed=True)
    for (lo, hi, _), done in zip(launches, ft.counters):
        kinds, outs, aux = sr.c_entries(ops, vals, ft, lo, hi, fixed=True)
        if slab is None:
            rc = lib.dft_windowed_reduce(gid.data_ptr(), gid.numel(), g, hi - lo, kinds,
                                         *sr.c_streams(vals, masks, lo, hi), outs, aux, done, None)
        else:
            words = slab.info.data_ptr()
            for a in range(lo, hi):
                if slab.scale_at[a] is not None:
                    aux[a - lo] = words + 8 * slab.scale_at[a]
            bits = (ctypes.c_int * (hi - lo))(*[-1 if b is None else b for b in slab.mask_bits[lo:hi]])
            rc = lib.dft_windowed_reduce_slab(gid.data_ptr(), gid.numel(), g, slab.id_mod, hi - lo, kinds,
                                              sr.c_streams(vals, masks, lo, hi)[0], bits, outs, aux, done,
                                              words + 8 * slab.n_scales, None)
        assert rc == 0
    return ft.tables


def _slab(lib, packed, cols, n_buckets, id_mod, scales, num_groups):
    """K3's launch as `partition.slab_partition` packs it: the slab's
    gid, its payloads and K3's info."""
    n, k, j = packed.numel(), len(cols), len(scales)
    size = -(-n // pt.PBLOCK) * pt.slab_capacity(pt.PBLOCK, n_buckets)
    out_gid = torch.empty(size, dtype=torch.int32)
    outs = [torch.empty(size, dtype=c.dtype) for c in cols]
    info = torch.zeros(j + n_buckets, dtype=torch.int64)
    assert lib.dft_slab_partition(packed.data_ptr(), out_gid.data_ptr(), n, id_mod, n_buckets, pt.PBLOCK,
                                  pt.slab_capacity(pt.PBLOCK, n_buckets), k,
                                  (ctypes.c_int * k)(*[c.element_size() for c in cols]),
                                  (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
                                  (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]), info.data_ptr(), num_groups,
                                  j, (ctypes.c_int * j)(*[c for c, _ in scales]),
                                  (ctypes.c_int * j)(*[-1 if b is None else b for _, b in scales]), None) == 0
    return out_gid, outs, info


def _assert_fold(ops, got, gid, vals, masks, g):
    """Every float SUM bit-equal to fixed_sum_plain, every other op to the plain version."""
    plain = sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g)
    for a, (op, v, m) in enumerate(zip(ops, vals, masks)):
        want = sr.fixed_sum_plain(gid, v, m, g) if sr.float_sum(op, v) else plain[a]
        assert got[a].dtype == want.dtype and torch.equal(_bits(got[a]), _bits(want)), (a, op)


def _values(rng, n):
    f = rng.standard_normal(n) * 100
    f[::101] = f[::101] * 1e-25  # far below the scale: the last digit is not 0
    f[7::997] = np.nan
    return torch.from_numpy(f), torch.from_numpy((rng.standard_normal(n) * 3).astype(np.float32))


OPS = ("sum", "count", "sum", "min", "max", "sum")


@pytest.mark.parametrize("kernel", ["dense", "window", "k3k4"])
def test_hot_slot_checks_move_words_mid_range(emu, monkeypatch, kernel):
    """Every row on one id (5,003 rows, one block): the block checks
    after each of its three steps, each check moving every word, and the
    float SUMs equal fixed_sum_plain bit for bit."""
    monkeypatch.setenv("EMU_SMS", "1")
    rng = np.random.default_rng(41)
    n = 5003
    f, f32 = _values(rng, n)
    m = torch.from_numpy(rng.random(n) < 0.8)
    vals, masks = [f, None, f32, f, f32, f], [None, None, m, m, None, m]
    if kernel == "dense":
        g = 7
        gid = torch.full((n,), 5, dtype=torch.int32)
        _assert_fold(OPS, _dense(emu, gid, vals, masks, OPS, g), gid, vals, masks, g)
        return
    g = 5000
    gid = torch.full((n,), 4321, dtype=torch.int32)
    if kernel == "window":
        _assert_fold(OPS, _window(emu, gid, vals, masks, OPS, g), gid, vals, masks, g)
        return
    # through K3, as ops/aggregate.py slab_reduce packs the masks and names the scales
    id_mod, bit = 8192, 13
    packed = gid | (m.int() << bit)
    scales = [(0, None), (1, bit), (0, bit)]
    out_gid, (sf, sf32), info = _slab(emu, packed, [f, f32], 3, id_mod, scales, g)
    fold = pt.SlabFold(id_mod, (None, None, bit, bit, None, bit), info, 3, (0, None, 1, None, None, 2))
    got = _window(emu, out_gid, [sf, None, sf32, sf, sf32, sf], [None] * 6, OPS, g, slab=fold)
    _assert_fold(OPS, got, gid, vals, masks, g)


EDGE = 2.0 ** 20


@pytest.mark.parametrize("kernel", ["dense", "window"])
def test_alternating_signs_at_the_scale_edge(emu, monkeypatch, kernel):
    """+-2^E, +-(2^E less an ulp), +-2^(E-70) and +-(2^E less an ulp) *
    2^-40, alternating in sign along the rows, some runs of equal ids
    (digits combined in registers across signs): every digit is negative
    in half the rows, and the words' carries run, on a hot slot and
    spread over slots."""
    monkeypatch.setenv("EMU_SMS", "2")
    n = 4999
    base = np.array([EDGE, np.nextafter(EDGE, 0), EDGE * 2.0 ** -70, np.nextafter(EDGE, 0) * 2.0 ** -40])
    x = np.resize(base, n) * np.where(np.arange(n) % 2, -1.0, 1.0)
    x[1::3] *= -1.0
    rng = np.random.default_rng(43)
    g = 9 if kernel == "dense" else 4099
    ids = rng.integers(0, g, n)
    ids[: n // 2] = g - 1  # half the rows on one slot
    ids[n // 2: n // 2 + 40] = 3  # a run of equal neighbours
    gid = torch.from_numpy(ids.astype(np.int32))
    f = torch.from_numpy(x)
    ops, vals, masks = ("sum", "sum", "count"), [f, f.float(), None], [None, None, None]
    got = _dense(emu, gid, vals, masks, ops, g) if kernel == "dense" else _window(emu, gid, vals, masks, ops, g)
    _assert_fold(ops, got, gid, vals, masks, g)


@pytest.mark.parametrize("masked", [False, True])
def test_k4_given_k3_scales_equals_its_own_first_pass(emu, monkeypatch, masked):
    """K3's scale words (and slab, and chunk counts) equal the plain
    version's; K4 over the slab as K3 left it (SlabFold: no first pass)
    is bit-equal to K4 with its own first pass over the unpacked slab and
    to fixed_sum_plain. The largest |value| lies on a row whose id is
    num_groups (unselected) and, masked, on a row whose mask is off: K3
    takes neither into the scale."""
    monkeypatch.setenv("EMU_SMS", "3")
    rng = np.random.default_rng(47 + masked)
    n, g = 5003, 6000
    id_mod, bit = 8192, 13
    ids = rng.integers(0, g + 1, n)
    f = rng.standard_normal(n)
    ids[17], f[17] = g, 1e30  # unselected
    m = rng.random(n) < 0.7
    if masked:
        m[29], f[29] = False, -1e20  # masked off
    f = torch.from_numpy(f)
    mask = torch.from_numpy(m) if masked else None
    gid = torch.from_numpy(ids.astype(np.int32))
    packed = gid | (mask.int() << bit) if masked else gid
    b = bit if masked else None
    ops = ("sum", "count", "max", "sum")
    scales = [(0, b), (1, None)]
    f32 = f.float()
    out_gid, (sf, sf32), info = _slab(emu, packed, [f, f32], 3, id_mod, scales, g)
    want = pt.slab_partition_plain(packed, [f, f32], n_buckets=3, id_mod=id_mod, scales=scales, num_groups=g)
    for x, y in zip((out_gid, sf, sf32, info), want):
        assert torch.equal(_bits(x), _bits(y))
    assert int(info[0]) >> 52 < 1023 + 20  # 1e30 and -1e20 set no scale
    vals, masks = [f, None, f, f32], [mask, None, mask, None]
    fold = pt.SlabFold(id_mod, (b, None, b, None), info, 2, (0, None, None, 1))
    got = _window(emu, out_gid, [sf, None, sf, sf32], [None] * 4, ops, g, slab=fold)
    ids_k, masks_k = fold.unpacked(out_gid)
    own = _window(emu, ids_k, [sf, None, sf, sf32], masks_k, ops, g)
    for a, (x, y) in enumerate(zip(got, own)):
        assert torch.equal(_bits(x), _bits(y)), a
    _assert_fold(ops, got, gid, vals, masks, g)


@pytest.mark.parametrize("seed,sms,g", [(0, 2, 8000), (3, 2, 8000), (11, 5, 8000), (29, 8, 6144)])
def test_split_over_buckets_in_any_block_order(emu, monkeypatch, seed, sms, g):
    """K4's blocks split over the buckets by K3's chunk counts (80% of the
    rows in one bucket, one bucket empty), launched with the blocks in
    grid order or shuffled (EMU_BLOCK_SEED) on grids of 2-8 blocks: every
    output bit-equal to grid order on 2 blocks, and to the plain versions.
    With 6,144 slots the unselected id fills a bucket K3 has and K4 does
    not."""
    rng = np.random.default_rng(53)
    n, id_mod = 5003, 8192
    ids = rng.integers(0, 2048, n)  # bucket 0
    hot = rng.random(n) < 0.8
    ids[hot] = rng.integers(4096, 6144, int(hot.sum()))  # bucket 2; bucket 1 empty
    ids[::50] = g  # unselected, in bucket 3
    gid = torch.from_numpy(ids.astype(np.int32))
    f, f32 = _values(rng, n)
    ops, vals = ("sum", "count", "min", "sum"), [f, None, f32, f32]

    def run(seed, sms):
        monkeypatch.setenv("EMU_SMS", str(sms))
        monkeypatch.setenv("EMU_BLOCK_SEED", str(seed))
        out_gid, (sf, sf32), info = _slab(emu, gid, [f, f32], -(-(g + 1) // pt.WINDOW), id_mod, [(0, None), (1, None)],
                                          g)
        fold = pt.SlabFold(id_mod, (None,) * 4, info, 2, (0, None, None, 1))
        return _window(emu, out_gid, [sf, None, sf32, sf32], [None] * 4, ops, g, slab=fold)

    got = run(seed, sms)
    ref = run(0, 2)
    for a, (x, y) in enumerate(zip(got, ref)):
        assert torch.equal(_bits(x), _bits(y)), a
    _assert_fold(ops, got, gid, vals, [None] * 4, g)
