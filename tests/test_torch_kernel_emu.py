"""The kernels' CUDA source (K1, K2 both modes, K4, K5) run on the CPU.

The kernels have no interpret mode, so this file compiles
`datafusion_tpu_torch/csrc/segreduce.cu`, `partition.cu`,
`fused_stage.cu` and `ragged_shuffle.cu` with the host C++ compiler
against a small emulation of the CUDA runtime (EMU_RUNTIME below): each
block's threads are std::threads, a warp's shuffles and ballots and a
block's __syncthreads are barriers, blocks run one after another (so a
static local is the block's shared memory), atomics take a mutex, and the
rounding intrinsics are the host's IEEE operations (built with
-ffp-contract=off, so nothing fuses into an FMA). The C entries are then
called through ctypes with the arguments the wrappers pack (the same
functions pack them), on small inputs, and held to the plain versions:
K1 and K5 bit for bit (K1's transcendental functions to 1 ulp: libm is
not libdevice), counts and MIN/MAX exact, f64 sums at rtol 1e-12. It
checks the kernels' logic (tiles, register reuse, immediates, runs,
carries, windows, flushes, the last block's decode, batched launches);
what the card's compiler accepts and how fast the kernels run show only on
the card (chip_smoke.py, tests/test_torch_cuda.py). Skips where no g++ is
found.
"""

import ctypes
import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import datafusion_tpu_torch as port
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.ops.pallas import partition as pt
from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
from datafusion_tpu_torch.ops.pallas import segreduce as sr

EMU_RUNTIME = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <cstdlib>
#include <mutex>
#include <random>
#include <thread>
#include <utility>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
                   cudaErrorPeerAccessUnsupported = 217, cudaErrorPeerAccessAlreadyEnabled = 704 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
struct uint3_ { unsigned int x, y, z; };
struct dim3 {
  unsigned int x, y, z;
  dim3(unsigned int a = 1, unsigned int b = 1, unsigned int c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { unsigned int x, y, z, w; };
inline thread_local uint3_ threadIdx, blockIdx;
inline uint3_ blockDim, gridDim;
inline int emu_env(const char* name, int dflt) { const char* e = getenv(name); return e ? atoi(e) : dflt; }
template <typename K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int v) {
  return v > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaDeviceCanAccessPeer(int* can, int, int) { *can = 1; return cudaSuccess; }
inline cudaError_t cudaDeviceEnablePeerAccess(int, unsigned) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = emu_env("EMU_SMS", 2); return cudaSuccess; }
template <typename K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t emu_err = cudaSuccess;
inline cudaError_t cudaGetLastError() { cudaError_t e = emu_err; emu_err = cudaSuccess; return e; }

struct EmuBlock {
  std::barrier<>* block;
  std::vector<std::barrier<>*> warp;
  unsigned long long slot[32][32];
};
inline EmuBlock* emu_blk = nullptr;
inline std::mutex emu_mu;
inline int emu_lane() { return threadIdx.x & 31; }
inline int emu_warp() { return threadIdx.x >> 5; }
template <typename T> T emu_xchg(T v, int src) {
  unsigned long long b = 0;
  memcpy(&b, &v, sizeof(T));
  emu_blk->slot[emu_warp()][emu_lane()] = b;
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  T out;
  memcpy(&out, &emu_blk->slot[emu_warp()][src], sizeof(T));
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  return out;
}
template <typename T> T __shfl_sync(unsigned, T v, int src, int = 32) { return emu_xchg(v, src & 31); }
template <typename T> T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) {
  const int s = emu_lane() - (int)d;
  return emu_xchg(v, s < 0 ? emu_lane() : s);
}
template <typename T> T __shfl_down_sync(unsigned, T v, unsigned d, int = 32) {
  const int s = emu_lane() + (int)d;
  return emu_xchg(v, s > 31 ? emu_lane() : s);
}
inline unsigned emu_vote(unsigned long long mine, bool equal) {
  emu_blk->slot[emu_warp()][emu_lane()] = mine;
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) {
    const unsigned long long x = emu_blk->slot[emu_warp()][l];
    r |= (equal ? x == mine : x != 0) ? 1u << l : 0u;
  }
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int p) { return emu_vote(p != 0, false); }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  emu_blk->slot[emu_warp()][emu_lane()] = v;
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r = std::max(r, (unsigned)emu_blk->slot[emu_warp()][l]);
  emu_blk->warp[emu_warp()]->arrive_and_wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, int v) { return emu_vote((unsigned)v, true); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncthreads() { emu_blk->block->arrive_and_wait(); }
inline void __syncwarp() { emu_blk->warp[emu_warp()]->arrive_and_wait(); }
inline void __threadfence() { std::lock_guard<std::mutex> g(emu_mu); }
template <typename T> T __ldg(const T* p) { return *p; }
template <typename T> T __ldcg(const T* p) { std::lock_guard<std::mutex> g(emu_mu); return *p; }
inline int __float_as_int(float x) { int b; memcpy(&b, &x, 4); return b; }
inline long long __double_as_longlong(double x) { long long b; memcpy(&b, &x, 8); return b; }
inline double __longlong_as_double(long long b) { double x; memcpy(&x, &b, 8); return x; }
inline double __ll2double_rn(long long x) { return (double)x; }
inline double __ull2double_rn(unsigned long long x) { return (double)x; }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __double2float_rn(double x) { return (float)x; }
inline long long __double2ll_rz(double x) { return (long long)x; }
inline float __ll2float_rn(long long x) { return (float)x; }
#define EMU_ATOMIC(T, NAME, EXPR) \
  inline T NAME(T* p, T v) { std::lock_guard<std::mutex> g(emu_mu); T old = *p; *p = EXPR; return old; }
EMU_ATOMIC(unsigned int, atomicAdd, old + v)
EMU_ATOMIC(int, atomicAdd, old + v)
EMU_ATOMIC(unsigned long long, atomicAdd, old + v)
EMU_ATOMIC(double, atomicAdd, old + v)
EMU_ATOMIC(unsigned int, atomicMax, v > old ? v : old)
EMU_ATOMIC(unsigned long long, atomicMax, v > old ? v : old)
EMU_ATOMIC(unsigned int, atomicOr, old | v)
EMU_ATOMIC(unsigned long long, atomicOr, old | v)

alignas(16) inline unsigned char emu_smem[232448];  // the running block's dynamic shared memory

template <typename F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  if (smem > sizeof(emu_smem) || block.x > 1024) { emu_err = cudaErrorInvalidConfiguration; return; }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, block.y, block.z};
  std::vector<std::pair<unsigned, unsigned>> order;  // (bx, by): in grid order, or shuffled by EMU_BLOCK_SEED
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) order.emplace_back(bx, by);
  if (const int seed = emu_env("EMU_BLOCK_SEED", 0)) std::shuffle(order.begin(), order.end(), std::mt19937(seed));
  for (const auto& [bx, by] : order) {
    std::barrier<> bar(block.x);
    EmuBlock b;
    b.block = &bar;
    for (unsigned w = 0; w < (block.x + 31) / 32; ++w) b.warp.push_back(new std::barrier<>(32));
    emu_blk = &b;
    memset(emu_smem, 0xab, sizeof(emu_smem));  // shared memory starts as garbage
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block.x; ++t)
      th.emplace_back([&, t] { threadIdx = {t, 0, 0}; blockIdx = {bx, by, 0}; f(); });
    for (auto& x : th) x.join();
    for (auto* w : b.warp) delete w;
    emu_blk = nullptr;
  }
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernels' sources built against EMU_RUNTIME, as a ctypes library."""
    from datafusion_tpu_torch.ops.pallas.cuda_lib import SRC_DIR

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' emulation")
    d = tmp_path_factory.mktemp("kernel_emu")
    (d / "cuda_runtime.h").write_text(EMU_RUNTIME)
    procs = []
    names = ("segreduce.cu", "partition.cu", "fused_stage.cu", "ragged_shuffle.cu")
    for name in names:
        src = (SRC_DIR / name).read_text()
        src = src.replace("extern __shared__ __align__(16) unsigned char smem[];", "unsigned char* smem = emu_smem;")
        src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        (d / f"{name}.cpp").write_text(src)
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread", "-Wno-unknown-pragmas", f"-I{d}",
             f"-I{SRC_DIR}", "-c",
             str(d / f"{name}.cpp"), "-o", str(d / f"{name}.o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out
    lib_path = d / "libemu.so"
    subprocess.run([gxx, "-shared", "-pthread", *[str(d / f"{name}.o") for name in names], "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_segreduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, i32, vp]
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_fused_stage.argtypes = [vp, i64, i32, i32, vp]
    lib.dft_ragged_exchange.argtypes = [vp, vp, i32, i32, i64, i32, vp]
    lib.dft_ragged_exchange_fold.argtypes = [vp, vp, i32, i32, i64, i32, i32, i32, vp, vp, vp, vp, i32, vp]
    for f in (lib.dft_segreduce, lib.dft_segreduce_dense, lib.dft_windowed_reduce, lib.dft_fused_stage,
              lib.dft_ragged_exchange, lib.dft_ragged_exchange_fold):
        f.restype = i32
    assert lib.dft_fused_stage_program_size() == ctypes.sizeof(fs._CProgram)
    assert lib.dft_ragged_exchange_args_size() == ctypes.sizeof(rs.ExchangeArgs)
    return lib


def _launch(lib, mode, gid, vals, masks, ops, g):
    """The wrappers' launches on CPU tensors: `fold_tables`, one C call per
    launch of the mode's op split, each with its ops' C arrays
    (`c_entries`, `c_streams`). Returns (tables, launches)."""
    n = gid.shape[0]
    max_blocks = min(sr.SORTED_MAX_BLOCKS, -(-n // sr.SORTED_BLOCK_ROWS))
    if mode == "sorted":
        launches = [(lo, hi, 1) for lo, hi in sr.sorted_launch_ops(len(ops))]
        ft = sr.fold_tables(ops, vals, g, "cpu", counters=len(launches), edge_blocks=max_blocks)
    else:
        launches = sr.fold_launches(sr.fold_widths(ops, vals), g if mode == "dense" else pt.WINDOW)
        ft = sr.fold_tables(ops, vals, g, "cpu", counters=len(launches), fixed=True)
    for (lo, hi, reps), counter in zip(launches, ft.counters):
        kinds, outs, aux = sr.c_entries(ops, vals, ft, lo, hi, fixed=mode != "sorted")
        arrays = (kinds, *sr.c_streams(vals, masks, lo, hi), outs, aux)
        k = hi - lo
        if mode == "sorted":
            rc = lib.dft_segreduce(gid.data_ptr(), n, g, k, *arrays, counter, max_blocks, None)
        elif mode == "dense":
            rc = lib.dft_segreduce_dense(gid.data_ptr(), n, g, reps, k, *arrays, counter, None)
        else:
            rc = lib.dft_windowed_reduce(gid.data_ptr(), n, g, k, *arrays, counter, None)
        assert rc == 0
    return ft.tables, len(launches)


def _launch_k6(lib, gids, vals, masks, sizes, ops, mask_map, n_recv, split_cap, num_groups):
    """K6's launches as the wrapper makes them: the `[n_recv, num_groups]`
    tables, one packed pointer table and one C call per `fold_launches`
    entry. Returns (tables, launches)."""
    launches = sr.fold_launches(sr.fold_widths(ops, vals[0]), num_groups)
    ft = sr.fold_tables(ops, vals[0], num_groups, "cpu", lead=(n_recv,), counters=len(launches), fixed=True)
    per_op = [rs._op_masks(m, mask_map) for m in masks]
    for (lo, hi, reps), done in zip(launches, ft.counters):
        ptrs = torch.tensor(rs.fold_pointer_table(gids, vals, per_op, range(lo, hi)), dtype=torch.int64)
        assert lib.dft_ragged_exchange_fold(ptrs.data_ptr(), sizes.data_ptr(), len(gids), n_recv, split_cap,
                                            num_groups, reps, hi - lo,
                                            *sr.c_entries(ops, vals[0], ft, lo, hi, fixed=True), done, 3, None) == 0
    return ft.tables, len(launches)


EDGE_OPS = ("sum", "count", "min", "max", "max", "min", "sum", "count", "sum", "max", "min", "count", "sum", "min",
            "max")


def _streams(rng, n, n_ops):
    """Op a's value (None for COUNT; f64 with NaN / +-inf, i64, f32, i32
    by a % 4) and mask (none where a % 3 == 1)."""
    f = rng.standard_normal(n) * 100
    f[::97], f[5::199], f[9::203] = np.nan, np.inf, -np.inf
    pool = [torch.from_numpy(x) for x in (f, rng.integers(-10**12, 10**12, n), f.astype(np.float32),
                                          rng.integers(-10**6, 10**6, n).astype(np.int32))]
    m1, m2 = (torch.from_numpy(rng.random(n) < p) for p in (0.9, 0.4))
    ops = tuple(EDGE_OPS[a % len(EDGE_OPS)] for a in range(n_ops))
    vals = [None if op == "count" else pool[a % 4] for a, op in enumerate(ops)]
    return ops, vals, [(m1, None, m2)[a % 3] for a in range(n_ops)]


def _assert_tables(ops, k, p):
    for op, a, b in zip(ops, k, p):
        assert a.dtype == b.dtype
        if op == "sum" and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-9, equal_nan=True)
        else:
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), op


@pytest.mark.parametrize("case,n_ops,sms", [("random", 6, 2), ("own", 4, 2), ("one", 4, 2), ("long", 5, 8),
                                            ("tail", 5, 2), ("negative head", 4, 2), ("ragged", 15, 8),
                                            ("33 ops", 33, 2)])
def test_sorted_kernel_matches_plain(emu, monkeypatch, case, n_ops, sms):
    """K2 sorted mode: runs within a lane, across lanes and warp tiles (the
    carry), across warps' spans (atomics at a span's edges), every row its
    own group, one group, dropped ids at either end, a ragged last tile,
    33 ops in two launches; `sms` sets the grid, so spans are long or one
    tile."""
    monkeypatch.setenv("EMU_SMS", str(sms))
    rng = np.random.default_rng(len(case) + n_ops)
    n = 20_000 if n_ops <= 15 else 8_000
    ids = {"own": np.arange(n), "one": np.zeros(n, np.int64), "long": np.sort(rng.integers(0, 9, n)),
           "ragged": np.sort(rng.integers(0, 900, n - 3))}.get(case, np.sort(rng.integers(0, 700, n)))
    g = int(ids.max()) + 1
    if case == "tail":
        ids[-3001:] = g
    if case == "negative head":
        ids[:2500] = -1
    gid = torch.from_numpy(ids.astype(np.int32))
    ops, vals, masks = _streams(rng, gid.shape[0], n_ops)
    k, launches = _launch(emu, "sorted", gid, vals, masks, ops, g)
    assert launches == (2 if n_ops > 32 else 1)
    _assert_tables(ops, k, sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g))


@pytest.mark.parametrize("case", ["slab", "shuffled", "widest", "skew", "unsorted ragged", "whole windows",
                                  "four float sums", "three float sums and three ops"])
def test_windowed_kernel_matches_plain(emu, monkeypatch, case):
    """K4 over K3's slab (10,001 slots, 5 buckets), the same slab shuffled
    (chunks mix buckets and windows: global atomics), 14 ops over 16,383
    slots (two launches: four float SUMs take three windows each), 80% of
    the rows on one gid, unsorted ids with negatives and a ragged last
    chunk, a slot count that fills its last window; and over 5,000 slots
    four f64 SUMs (12 windows) and three float SUMs beside a COUNT, a MIN
    and a MAX (12 windows), one launch each."""
    monkeypatch.setenv("EMU_SMS", "6")
    rng = np.random.default_rng(len(case))
    nslots = {"widest": 16_383, "whole windows": 4096, "four float sums": 5000,
              "three float sums and three ops": 5000}.get(case, 10_001)
    if case == "unsorted ragged":
        gid = torch.from_numpy(rng.integers(-10, nslots + 50, 30_001).astype(np.int32))
    else:
        ids = rng.integers(0, nslots + 1, 30_000)
        if case == "skew":
            ids[rng.random(ids.shape[0]) < 0.8] = 4321
        id_mod = 1 << nslots.bit_length()
        gid = pt.slab_partition(torch.from_numpy(ids.astype(np.int32)), [], n_buckets=-(-(nslots + 1) // pt.WINDOW),
                                id_mod=id_mod, pblock=8192)[0]
        if case == "shuffled":
            gid = gid[torch.from_numpy(rng.permutation(gid.shape[0]))].contiguous()
    ops, vals, masks = _streams(rng, gid.shape[0], pt.MAX_OPS if case == "widest" else 5)
    if case == "four float sums":
        ops, vals, masks = ("sum",) * 4, [vals[0]] * 4, [masks[0], None, masks[2], masks[0]]
    if case == "three float sums and three ops":
        f64, f32 = vals[0], vals[2]
        ops, vals, masks = ("sum", "count", "sum", "min", "sum", "max"), [f64, None, f32, f64, f64, f32], masks + masks[:1]
    k, launches = _launch(emu, "window", gid, vals, masks, ops, nslots)
    assert launches == (2 if case == "widest" else 1)
    _assert_tables(ops, k, pt.windowed_reduce_plain(gid, vals, masks, ops=ops, num_groups=nslots))


def test_windowed_entry_refuses_more_windows_than_a_block_holds(emu):
    """csrc/partition.cu's C entry takes at most MAX_OPS (14) shared
    windows a launch, a float SUM three: four f64 SUMs and two COUNTs (14
    windows) launch, five f64 SUMs (15) are refused, as are four f64 SUMs
    and three COUNTs. test_torch_partition.py holds the wrapper's launch
    plan to the same limit."""
    n, g = 4096, 5000
    gid = torch.from_numpy(np.arange(n, dtype=np.int32) % g)
    x = torch.ones(n, dtype=torch.float64)
    for ops, ok in ((("sum",) * 4 + ("count",) * 2, True), (("sum",) * 5, False),
                    (("sum",) * 4 + ("count",) * 3, False)):
        vals = [x if op == "sum" else None for op in ops]
        assert sum(sr.fold_widths(ops, vals)) == (14 if ok else 15)
        ft = sr.fold_tables(ops, vals, g, "cpu", fixed=True)
        kinds, outs, aux = sr.c_entries(ops, vals, ft, 0, len(ops), fixed=True)
        rc = emu.dft_windowed_reduce(gid.data_ptr(), n, g, len(ops), kinds,
                                     *sr.c_streams(vals, [None] * len(ops), 0, len(ops)), outs, aux, ft.counters[0],
                                     None)
        assert (rc == 0) == ok, ops
        if ok:
            want = sr.segmented_reduce_plain(gid, vals, [None] * len(ops), ops=ops, num_groups=g)
            for a, b in zip(ft.tables, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("g,n_ops", [(7, 5), (2048, 15)])
def test_dense_kernel_matches_plain(emu, monkeypatch, g, n_ops):
    """K2 dense mode on the same fold tile: a small table with replicas,
    and 15 ops over 2,048 slots (two launches)."""
    monkeypatch.setenv("EMU_SMS", "3")
    rng = np.random.default_rng(g + n_ops)
    gid = torch.from_numpy(rng.integers(0, g + 1, 20_003).astype(np.int32))
    ops, vals, masks = _streams(rng, gid.shape[0], n_ops)
    k, _ = _launch(emu, "dense", gid, vals, masks, ops, g)
    _assert_tables(ops, k, sr.segmented_reduce_plain(gid, vals, masks, ops=ops, num_groups=g))


# --- K1: the fused stage's tile interpreter ----------------------------------

def _chip_smoke():
    """chip_smoke.py as a module: its K1 inputs (value types and their
    edges, limits_program()'s columns, the program itself) serve these checks too."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()


def _typed_table(n, seed):
    """A table of every value type (smoke.ALL_TYPES); `nv` and `j` carry NULLs."""
    rng = np.random.default_rng(seed)
    P = port.DataType
    schema = port.Schema([port.Field(name, P[t], name in ("nv", "j")) for name, t, _ in smoke.ALL_TYPES])
    arrays = [smoke.edge_column(rng, dt, n) for _, _, dt in smoke.ALL_TYPES]
    validity = [rng.random(n) > 0.2 if name in ("nv", "j") else None for name, _, _ in smoke.ALL_TYPES]
    return port.Table.from_arrays(schema, arrays, validity=validity, device="cpu")


def _sql_program(table, sql):
    """The K1 program the compiler builds for `sql` over `table` (as t),
    with its input tensors."""
    from datafusion_tpu_torch.plan import logical as L
    from datafusion_tpu_torch.plan.optimizer import push_down_filters, push_down_projection

    ctx = port.ExecutionContext(device="cpu")
    ctx.register_table("t", table)
    plan = push_down_projection(push_down_filters(ctx.plan(sql)))
    sel = plan.input if isinstance(plan.input, L.Selection) else None
    scan = plan.input.input if sel is not None else plan.input
    idx = list(range(len(table.schema))) if scan.projection is None else list(scan.projection)
    cols = [table.columns[i] for i in idx]
    computed = [e for e in plan.exprs if not isinstance(e, L.Column)]
    prog = fs.compile_program(table.schema.project(idx), [c.dictionary for c in cols],
                              [c.validity is not None for c in cols], None if sel is None else sel.expr, computed)
    return prog, ([cols[i].data for i in prog.inputs], [cols[i].validity for i in prog.inputs])


def _limits_inputs(n, seed):
    """smoke.limits_program() and one edge column per input type, each with a validity."""
    prog = smoke.limits_program()
    return prog, smoke.limits_inputs(prog, n, "cpu", np.random.default_rng(seed))


def run_k1(lib, prog, ins, n):
    """The wrapper's launch on CPU tensors: the cached C program bound to
    fresh outputs, one C call."""
    outs = [(torch.empty(n, dtype=fs._storage(t)), torch.empty(n, dtype=torch.bool) if nl else None)
            for _, t, nl in prog.outputs]
    sel = torch.empty(n, dtype=torch.bool) if prog.sel_reg >= 0 else None
    cp = fs.c_program(prog)
    fs.bind_program(cp, *ins, outs, sel)
    assert lib.dft_fused_stage(ctypes.byref(cp), n, prog.n_regs, fs.tile_rows(prog.n_regs), None) == 0
    return sel, outs


def _bits(x):
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]).long()


def assert_k1(got, want, ulps=0):
    """sel and validity equal; every valid value bit for bit (any NaN
    equal to any NaN: payloads carry no meaning), or floats within `ulps`
    units in the last place."""
    assert (got[0] is None) == (want[0] is None) and (got[0] is None or torch.equal(got[0], want[0]))
    for (kd, kv), (pd, pv) in zip(got[1], want[1]):
        assert kd.dtype == pd.dtype and (kv is None) == (pv is None)
        assert kv is None or torch.equal(kv, pv)
        live = torch.ones_like(kd, dtype=torch.bool) if kv is None else kv
        a, b = kd[live], pd[live]
        if kd.dtype == torch.bool:
            assert torch.equal(a, b)
        elif kd.dtype.is_floating_point:
            off = ~((_bits(a) == _bits(b)) | (a.isnan() & b.isnan()))
            assert bool(((_bits(a) - _bits(b))[off].abs() <= ulps).all())
        else:
            assert torch.equal(_bits(a), _bits(b))


K1_SQL = {
    "all types": smoke.K1_ALL_TYPES,
    "ints": "SELECT i8 + i8, i16 * i16, i32 / j, i32 % j, i64 - i64 * 3, u8 + u8, u16 * u16, u32 + u32, "
            "CAST(i32 AS SMALLINT), CAST(i64 AS INT), CAST(u32 AS TINYINT) FROM t WHERE j IS NOT NULL OR b",
    "floats": "SELECT f32 * 2 + f32, f32 / f32, f64 - nv, f64 / 0.0, f64 % 3.5, CAST(f64 AS INT), CAST(f64 AS BIGINT), "
              "CAST(f32 AS DOUBLE), CAST(i64 AS FLOAT), CAST(u8 AS DOUBLE), abs(f64), floor(nv) FROM t "
              "WHERE f64 > -50 AND nv < 80",
    "compares": "SELECT i8 < i16, u16 >= 100, f32 = f32, f64 <> nv, nv IS NULL, CAST(f64 AS BOOLEAN) FROM t "
                "WHERE b OR u8 < 30",
    "case": "SELECT CASE WHEN j > 0 THEN i32 WHEN j < 0 THEN j END, CASE WHEN nv IS NULL THEN f64 ELSE nv END, "
            "sign(f64), round(f64, 2), trunc(nv, 1) FROM t WHERE j IS NOT NULL",
    "one register": "SELECT f64 FROM t WHERE b",
    "transcendental": "SELECT sqrt(f64), exp(nv / 30), ln(f64), log10(nv), log2(f64), sin(f64), cos(nv), tan(f64), "
                      "atan(f64), power(nv, 1.5), atan2(f64, nv), asin(nv / 100) FROM t",
}


@pytest.mark.parametrize("case,n", [("all types", 4099), ("ints", 5003), ("floats", 5003), ("compares", 5003),
                                    ("case", 100), ("one register", 3 * 2048), ("transcendental", 2049),
                                    ("limits", 3001), ("limits", 200), ("limits", 0), ("dates", 3001)])
def test_fused_stage_kernel_matches_plain(emu, monkeypatch, case, n):
    """K1 on programs the compiler builds over every value type (NULLs,
    integer /0 and INT_MIN / -1, NaN, +-inf, -0.0), tiles of 8, 4, 2 and 1
    rows a thread, smoke.limits_program() at the kernel's capacity, and
    smoke.K1_DATES (every date opcode) over the calendar's edges
    (smoke.date_edge_table: INT_MIN / INT_MAX days, +-2^62 seconds, leap
    days, ISO years of 53 weeks); `n` below one tile, not a multiple of
    it, and 0. The emulated card has 2 SMs, so each block walks several
    tiles."""
    monkeypatch.setenv("EMU_SMS", "2")
    if case == "limits":
        prog, ins = _limits_inputs(n, 7)
        assert (len(prog.code), prog.n_regs, len(prog.inputs), len(prog.outputs), len(prog.consts)) == (
            fs.MAX_INSTR, fs.MAX_REGS, fs.MAX_IN, fs.MAX_OUT, fs.MAX_CONST)
        programs = [(prog, ins)]
    elif case == "dates":
        t = smoke.date_edge_table(port, n, 11, "cpu")
        programs = [_sql_program(t, sql) for sql in smoke.K1_DATES]
    else:
        programs = [_sql_program(_typed_table(n, len(case)), K1_SQL[case])]
    for prog, ins in programs:
        got = run_k1(emu, prog, ins, n)
        assert_k1(got, fs.evaluate_plain(prog, *ins, n), ulps=1 if case == "transcendental" else 0)


def test_fused_stage_tiles_and_checks(emu):
    """Every tile size the wrapper picks occurs, the immediates shorten
    q1's program to 6 instructions over 3 registers, and the C entry
    refuses a program that names a register past n_regs."""
    t = _typed_table(64, 3)
    sizes = {fs.tile_rows(_sql_program(t, K1_SQL[c])[0].n_regs) for c in K1_SQL} | {fs.tile_rows(fs.MAX_REGS)}
    assert sizes == {1, 2, 4, 8}
    q1, _ = _sql_program(t, "SELECT i32, f64, nv, f64 + nv FROM t WHERE f64 > 51.0 AND f64 < 53")
    assert (len(q1.code), q1.n_regs) == (6, 3)
    prog, ins = _limits_inputs(64, 1)
    cp = fs.c_program(prog)
    fs.bind_program(cp, *ins, [(torch.empty(64, dtype=fs._storage(t)), torch.empty(64, dtype=torch.bool))
                                for _, t, _ in prog.outputs], torch.empty(64, dtype=torch.bool))
    assert emu.dft_fused_stage(ctypes.byref(cp), 64, prog.n_regs - 1, 1, None) != 0
    assert emu.dft_fused_stage(ctypes.byref(cp), 64, prog.n_regs, 3, None) != 0


# --- K5: the ragged exchange ---------------------------------------------------

K5_CASES = {  # senders, receivers, split_cap, chunk, dtypes, which senders' arrays sit one element off alignment
    "widths": (4, 4, 512, 128, (torch.uint8, torch.int16, torch.int32, torch.float64, torch.int64, torch.float32), ()),
    "chunk 1024": (3, 3, 2048, 1024, (torch.float64, torch.uint8, torch.int32), ()),
    "empty pairs": (4, 4, 256, 128, (torch.int32, torch.float64), ()),
    "one shard": (1, 1, 384, 128, (torch.int64, torch.uint8), ()),
    "batched": (2, 2, 256, 128, (torch.uint8, torch.int16, torch.int32, torch.float64) * 4 + (torch.int64,), ()),
    "unaligned": (4, 4, 256, 128, (torch.int16, torch.float64, torch.int32), (1, 2)),
    # a mesh spanning processes: every shard sends to this process's two
    "senders past receivers": (6, 2, 256, 128, (torch.int32, torch.uint8, torch.float64), (3,)),
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_ragged_exchange_kernel_matches_plain(emu, case):
    """K5 through `exchange_args` and `receivers`, as the wrapper calls it:
    every valid prefix bit-equal to the plain version; nothing written past
    a pair's live chunks; one launch per 16 arrays (17 arrays: two)."""
    n_send, n_dev, split_cap, chunk, dtypes, off = K5_CASES[case]
    rng = np.random.default_rng(len(case))
    sizes = rng.integers(0, split_cap + 1, (n_send, n_dev))
    sizes[0, -1] = split_cap
    if case == "empty pairs":
        sizes[1, :], sizes[:, 2] = 0, 0
    sizes = torch.from_numpy(sizes.astype(np.int32))
    width = n_dev * split_cap

    def region(dt, j):
        raw = torch.from_numpy(rng.integers(0, 256, (width + 1) * 8).astype(np.uint8))
        x = raw.view(dt)[: width + 1]
        return x[1:] if j in off else x[:width]

    sends = [[region(dt, j) for dt in dtypes] for j in range(n_send)]
    recv_width = n_send * split_cap
    bufs = [torch.full((n_dev * recv_width,), 0x5A, dtype=torch.uint8).view(torch.uint8).to(dt) for dt in dtypes]
    blank = [b.clone() for b in bufs]
    launches = rs.exchange_args(sends, bufs)
    assert len(launches) == (2 if len(dtypes) > rs.K5_MAX_ARRS else 1)
    for x in launches:
        assert emu.dft_ragged_exchange(ctypes.byref(x), sizes.data_ptr(), n_send, n_dev, split_cap, chunk, None) == 0
    got = rs.receivers(bufs, n_dev, n_send, split_cap)
    want = rs.ragged_exchange_plain(sends, sizes, n_dev=n_dev, split_cap=split_cap, chunk=chunk)
    sz = sizes.tolist()
    for i in range(n_dev):
        assert all(g.data_ptr() == b.data_ptr() + i * recv_width * b.element_size() for g, b in zip(got[i], bufs))
        for a, (g, w) in enumerate(zip(got[i], want[i])):
            for j in range(n_send):
                lo = j * split_cap
                assert torch.equal(_bits(g[lo: lo + sz[j][i]]), _bits(w[lo: lo + sz[j][i]])), (i, a, j)
                live = -(-sz[j][i] // chunk) * chunk
                tail = slice(i * recv_width + lo + live, i * recv_width + lo + split_cap)
                assert torch.equal(_bits(bufs[a][tail]), _bits(blank[a][tail])), (i, a, j)


# --- K6: the ragged exchange + fold -------------------------------------------


@pytest.mark.parametrize("n_send,n_recv", [(4, 4), (6, 2)], ids=["square", "senders past receivers"])
def test_ragged_exchange_fold_kernel_matches_plain(emu, monkeypatch, n_send, n_recv):
    """K6 through the wrapper's pointer table and zeroed tables, as the
    wrapper calls it: every shard a sender, and on a mesh that spans
    processes (6 x 2) only this process's shards as receivers. Counts and
    MIN/MAX equal to the plain version, f64 sums to rtol 1e-12."""
    monkeypatch.setenv("EMU_SMS", "3")
    rng = np.random.default_rng(n_send * 10 + n_recv)
    split_cap, num_groups = 1024, 300
    width = n_recv * split_cap
    sizes = rng.integers(0, split_cap + 1, (n_send, n_recv))
    sizes[0, 0] = 0
    sizes = torch.from_numpy(sizes.astype(np.int32))
    ops = ("sum", "count", "min", "max", "sum", "min")
    gids, vals, masks = [], [], []
    for _ in range(n_send):
        g = rng.integers(0, num_groups + 40, width).astype(np.int32)  # ids past num_groups are dropped
        f = rng.standard_normal(width) * 100
        f[::89], f[3::97] = np.nan, np.inf
        i = rng.integers(-10**9, 10**9, width)
        ft, it = torch.from_numpy(f), torch.from_numpy(i)
        gids.append(torch.from_numpy(g))
        vals.append([ft, None, ft, it, it, it])
        masks.append([torch.from_numpy(rng.random(width) < 0.8)])
    mask_map = (1, 0, 1, 0, 1, 0)
    tables, _ = _launch_k6(emu, gids, vals, masks, sizes, ops, mask_map, n_recv, split_cap, num_groups)
    want = rs.ragged_exchange_fold_plain(gids, vals, masks, sizes, ops=ops, mask_map=mask_map, n_dev=n_recv,
                                         split_cap=split_cap, num_groups=num_groups)
    for i in range(n_recv):
        _assert_tables(ops, [t[i] for t in tables], want[i])


# --- float SUMs: the same bits in every run ----------------------------------


def _wide(rng, n, lo=-40, hi=60):
    """f64 values of magnitude 2^lo to 2^hi, either sign, every third one
    the negation of the one before it (cancellation): their sums do not
    associate in f64."""
    x = 2.0 ** rng.uniform(lo, hi, n) * rng.choice([-1.0, 1.0], n)
    x[1::3] = -x[0::3][: len(x[1::3])]
    return x


def _float_case(rng, n, g, sorted_ids):
    """Ids over g slots plus a dropped one (sorted: runs of about 40
    warp tiles' rows), and float SUMs of f64 and f32 wide values, one
    masked, beside a COUNT and a MAX."""
    ids = rng.integers(0, g + 1, n)
    gid = torch.from_numpy((np.sort(ids) if sorted_ids else ids).astype(np.int32))
    x = torch.from_numpy(_wide(rng, n))
    m = torch.from_numpy(rng.random(n) < 0.7)
    ops = ("sum", "count", "sum", "sum", "max")
    return gid, [x, None, x.float(), x, x], [None, None, None, m, m], ops


def _k6_case(rng, n_send, n_recv, split_cap, num_groups, values):
    """K6's inputs: each sender's region-layout window ids (some past
    num_groups), `values(rng, width)` per sender, two masks, and the count
    matrix; ops and mask map as _float_case's."""
    width = n_recv * split_cap
    sizes = torch.from_numpy(rng.integers(16, split_cap + 1, (n_send, n_recv)).astype(np.int32))
    gids, vals, masks = [], [], []
    for _ in range(n_send):
        x = torch.from_numpy(values(rng, width))
        gids.append(torch.from_numpy(rng.integers(0, num_groups + 20, width).astype(np.int32)))
        vals.append([x, None, x.float(), x, x])
        masks.append([torch.from_numpy(rng.random(width) < 0.7)])
    ops, mask_map = ("sum", "count", "sum", "sum", "max"), (0, 0, 0, 1, 1)
    kw = dict(ops=ops, mask_map=mask_map, n_dev=n_recv, split_cap=split_cap, num_groups=num_groups)
    return (gids, vals, masks, sizes), kw


def _run(emu, kernel, case, monkeypatch, seed):
    """One emulated launch of `kernel` on `case`, its blocks in the order
    EMU_BLOCK_SEED=seed gives; the outputs (K6: receiver-major tables)."""
    monkeypatch.setenv("EMU_BLOCK_SEED", str(seed))
    if kernel == "k6":
        (gids, vals, masks, sizes), kw = case
        tables, _ = _launch_k6(emu, gids, vals, masks, sizes, kw["ops"], kw["mask_map"], kw["n_dev"],
                               kw["split_cap"], kw["num_groups"])
        return tables
    gid, vals, masks, ops, g = case
    return _launch(emu, {"dense": "dense", "window": "window", "sorted": "sorted"}[kernel], gid, vals, masks, ops, g)[0]


def _permuted(case, rng):
    """The same rows in another order: K2 dense's and K4's rows, or every
    K6 sender's rows within each of its regions' valid prefixes."""
    if len(case) == 2:
        (gids, vals, masks, sizes), kw = case
        cap = kw["split_cap"]
        perms = []
        for j in range(len(gids)):
            p = torch.arange(gids[j].shape[0])
            for i in range(kw["n_dev"]):
                c = int(sizes[j, i])
                p[i * cap: i * cap + c] = i * cap + torch.from_numpy(rng.permutation(c))
            perms.append(p)
        return ([g[p].contiguous() for g, p in zip(gids, perms)],
                [[None if v is None else v[p].contiguous() for v in vs] for vs, p in zip(vals, perms)],
                [[m[p].contiguous() for m in ms] for ms, p in zip(masks, perms)], sizes), kw
    gid, vals, masks, ops, g = case
    p = torch.from_numpy(rng.permutation(gid.shape[0]))
    return (gid[p].contiguous(), [None if v is None else v[p].contiguous() for v in vals],
            [None if m is None else m[p].contiguous() for m in masks], ops, g)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kernel", ["dense", "window", "k6", "sorted"])
def test_float_sums_are_the_same_in_every_block_order(emu, monkeypatch, kernel):
    """Float SUMs of values from 2^-40 to 2^60 with cancellation (their
    f64 sums do not associate), launched with two block orders
    (EMU_BLOCK_SEED): every output bit-equal, float SUMs included. The
    fold-tile kernels (K2 dense, K4 over 5,000 slots in 3 windows, K6 over
    4 senders and 2 receivers) also give the same bits for the rows in
    another order. K2 sorted runs on 4 blocks of 16 warps, each group
    spanning about 12 warps' spans, so its float SUMs combine edge runs of
    many warps and blocks. Each of these failed where float SUMs were f64
    atomics."""
    rng = np.random.default_rng({"dense": 1, "window": 2, "k6": 3, "sorted": 4}[kernel])
    monkeypatch.setenv("EMU_SMS", "4")
    if kernel == "k6":
        case = _k6_case(rng, 4, 2, 1024, 300, _wide)
    else:
        n, g = {"dense": (6001, 300), "window": (6001, 5000), "sorted": (16_384, 5)}[kernel]
        gid, vals, masks, ops = _float_case(rng, n, g, kernel == "sorted")
        case = (gid, vals, masks, ops, g)
    first = _run(emu, kernel, case, monkeypatch, 1)
    runs = [_run(emu, kernel, case, monkeypatch, 2)]
    if kernel != "sorted":
        runs.append(_run(emu, kernel, _permuted(case, rng), monkeypatch, 3))
    for other in runs:
        for a, (x, y) in enumerate(zip(first, other)):
            assert _bits_equal(x, y), a


DBL_MAX = np.finfo(np.float64).max


def _oracle(xs, e):
    """One slot's float SUM as the contract defines it, from its kept
    finite values `xs` and the launch's scale exponent e: the exact sum,
    and the grid total (each value rounded to nearest even on 2^(e-95))
    rounded once to f64 (+-inf past the largest double)."""
    from fractions import Fraction

    exact = sum((Fraction(x) for x in xs), Fraction(0))
    q = sum(round(Fraction(x) * Fraction(2) ** (95 - e)) for x in xs)
    try:
        want = float(Fraction(q) * Fraction(2) ** (e - 95))
    except OverflowError:
        want = float("inf") if q > 0 else float("-inf")
    return exact, want, len(xs)


def _check_oracle(got, gid, x, mask, g):
    """Every slot of `got` (one float SUM's f64 sums over `g` slots of the
    rows gid, x, mask) against _oracle: the flags' outcome for a slot with
    a NaN or an infinity, else the grid total rounded once, bit for bit,
    and within n * 2^(e-96) plus half an ulp of the exact sum."""
    keep = (gid >= 0) & (gid < g) & (True if mask is None else mask)
    xk, gk = x[keep].double().numpy(), gid[keep].numpy()
    fin = np.isfinite(xk)
    e = max(int(np.abs(xk[fin]).view(np.int64).max()) >> 52, 1) - 1023 if fin.any() else -1022
    for slot in range(g):
        xs = xk[gk == slot]
        r = float(got[slot])
        nan, pinf, ninf = np.isnan(xs).any(), (xs == np.inf).any(), (xs == -np.inf).any()
        if nan or (pinf and ninf):
            assert np.isnan(r), slot
        elif pinf or ninf:
            assert r == (np.inf if pinf else -np.inf), slot
        else:
            exact, want, n = _oracle(xs.tolist(), e)
            assert np.float64(r).view(np.int64) == np.float64(want).view(np.int64), (slot, r, want)
            if np.isfinite(r):
                from fractions import Fraction

                assert abs(Fraction(r) - exact) <= n * Fraction(2) ** (e - 96) + Fraction(np.spacing(abs(r))) / 2


@pytest.mark.parametrize("data", ["wide", "cancelling", "special"])
@pytest.mark.parametrize("kernel", ["dense", "window", "k6"])
def test_fixed_point_sums_are_exact(emu, monkeypatch, kernel, data):
    """The fold-tile kernels' float SUMs (f64 and f32 values, masked and
    not) equal segreduce.fixed_sum_plain bit for bit, and both equal the
    contract's oracle: each value rounded to the grid 2^(E-95) of the
    launch's largest kept finite |value|, the total rounded once, within
    n * 2^(E-96) plus half an ulp of the exact sum. Data: magnitudes
    2^-40..2^60; values that cancel to a small remainder; and slots of
    NaN, +inf, -inf, both infinities, -0.0 only, finite values whose exact
    sum overflows (E = 1023), a 1e300 outlier masked out (so it sets no
    scale) and an empty slot."""
    rng = np.random.default_rng(len(kernel) * 7 + len(data))
    monkeypatch.setenv("EMU_SMS", "3")

    def values(rng, n):
        if data == "wide":
            return _wide(rng, n)
        if data == "cancelling":
            x = rng.standard_normal(n) * 2.0**40
            x[1::2] = -x[0::2][: len(x[1::2])] + rng.standard_normal(len(x[1::2]))
            return x
        x = _wide(rng, n, -20, 20)
        x[0], x[1], x[2], x[3], x[4] = np.nan, np.inf, -np.inf, np.inf, -np.inf
        x[5:9] = -0.0
        x[9:12] = 1.5e308
        x[12] = 1e300  # masked out below
        return x

    def specials(gid, mask):
        gid[:12] = [0, 1, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5]
        gid[12] = 6
        gid[13:] = np.where(gid[13:] <= 7, gid[13:] + 8, gid[13:])  # slots 0-7 hold only the rows above
        mask[:12], mask[12] = True, False

    if kernel == "k6":
        case = _k6_case(rng, 3, 2, 512, 300, values)
        (gids, vals, masks, sizes), kw = case
        if data == "special":
            for j in range(len(gids)):
                g_, m_ = gids[j].numpy(), masks[j][0].numpy()
                for i in range(kw["n_dev"]):
                    lo = i * kw["split_cap"]
                    specials(g_[lo: lo + int(sizes[j, i])], m_[lo: lo + int(sizes[j, i])])
        got = _run(emu, kernel, case, monkeypatch, 5)
        want = smoke.k6_fixed_sums(*case)
        for a in want:
            assert _bits_equal(got[a], want[a]), a
        # the oracle over the launch's flat rows (smoke.k6_fixed_sums' layout)
        n_dev, cap, g = kw["n_dev"], kw["split_cap"], kw["num_groups"]
        spans = [(i, j, i * cap, i * cap + int(sizes[j, i])) for i in range(n_dev) for j in range(len(gids))]
        w = torch.cat([gids[j][lo:hi] for _, j, lo, hi in spans])
        recv = torch.cat([torch.full((hi - lo,), i, dtype=torch.int32) for i, _, lo, hi in spans])
        flat = torch.where((w >= 0) & (w < g), recv * g + w, -1)
        for a, u in ((0, 0), (2, 0), (3, 1)):
            x = torch.cat([vals[j][a][lo:hi] for _, j, lo, hi in spans])
            m = None if u == 0 else torch.cat([masks[j][0][lo:hi] for _, j, lo, hi in spans])
            _check_oracle(got[a].reshape(-1), flat, x, m, n_dev * g)
        return
    n, g = (5003, 300) if kernel == "dense" else (5003, 4000)
    gid, vals, masks, ops = _float_case(rng, n, g, False)
    x = torch.from_numpy(values(rng, n))
    vals = [x, None, x.float(), x, x]
    if data == "special":
        specials(gid.numpy(), masks[3].numpy())
    got = _run(emu, kernel, (gid, vals, masks, ops, g), monkeypatch, 5)
    want = smoke.fixed_sums(gid, vals, masks, ops, g)
    assert sorted(want) == [0, 2, 3]
    for a in want:
        assert _bits_equal(got[a], want[a]), a
        _check_oracle(got[a], gid, vals[a], masks[a], g)


def test_fixed_point_spread_holds_the_jax_tolerance(emu, monkeypatch):
    """The fold tile's scale is the launch's: a group whose values lie 2^40
    below the launch's largest keeps about 55 bits of each (the grid
    2^(E-95)). Emulated K2 dense mode and segreduce.fixed_sum_plain over
    such a launch against the JAX package's SQL SUM on the CPU, at the
    rtol 1e-12 the SQL parity tests hold: the documented bound n *
    2^(E-96) is measured here, not assumed."""
    import datafusion_tpu as ref

    monkeypatch.setenv("EMU_SMS", "3")
    rng = np.random.default_rng(40)
    n, g = 4001, 6
    gid = rng.integers(0, g, n).astype(np.int32)
    x = rng.uniform(1.0, 2.0, n) * 2.0**40
    small = gid == 0
    x[small] = rng.uniform(1.0, 2.0, int(small.sum()))  # 2^40 below the rest
    ctx = ref.ExecutionContext()
    ctx.register_table("t", ref.Table.from_pydict({"g": gid, "x": x}))
    rows = ctx.sql("SELECT g, SUM(x) AS s FROM t GROUP BY g ORDER BY g").to_pylist()
    want = torch.tensor([r["s"] for r in rows], dtype=torch.float64)
    assert [r["g"] for r in rows] == list(range(g))
    gt, xt = torch.from_numpy(gid), torch.from_numpy(x)
    got = _launch(emu, "dense", gt, [xt], [None], ("sum",), g)[0][0]
    assert _bits_equal(got, sr.fixed_sum_plain(gt, xt, None, g))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
