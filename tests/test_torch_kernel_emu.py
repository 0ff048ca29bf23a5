"""The reduce kernels' CUDA source (K2 both modes, K4) run on the CPU.

The kernels have no interpret mode, so this file compiles
`datafusion_tpu_torch/csrc/segreduce.cu` and `partition.cu` with the host
C++ compiler against a small emulation of the CUDA runtime (EMU_RUNTIME
below): each block's threads are std::threads, a warp's shuffles and
ballots and a block's __syncthreads are barriers, blocks run one after
another (so a static local is the block's shared memory), and atomics take
a mutex. The C entries are then called through ctypes exactly as the
wrappers call them, on small inputs, and held to the plain versions:
counts and MIN/MAX exact, f64 sums at rtol 1e-12. It checks the kernels'
logic (runs, carries, windows, flushes, the last block's decode); what the
card's compiler accepts and how fast the kernels run show only on the card
(chip_smoke.py, tests/test_torch_cuda.py). Skips where no g++ is found.
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

EMU_RUNTIME = r"""
#pragma once
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <barrier>
#include <cstdlib>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
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
inline double __dadd_rn(double a, double b) { return a + b; }
#define EMU_ATOMIC(T, NAME, EXPR) \
  inline T NAME(T* p, T v) { std::lock_guard<std::mutex> g(emu_mu); T old = *p; *p = EXPR; return old; }
EMU_ATOMIC(unsigned int, atomicAdd, old + v)
EMU_ATOMIC(int, atomicAdd, old + v)
EMU_ATOMIC(unsigned long long, atomicAdd, old + v)
EMU_ATOMIC(double, atomicAdd, old + v)
EMU_ATOMIC(unsigned int, atomicMax, v > old ? v : old)
EMU_ATOMIC(unsigned long long, atomicMax, v > old ? v : old)

alignas(16) inline unsigned char emu_smem[232448];  // the running block's dynamic shared memory

template <typename F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F f) {
  if (smem > sizeof(emu_smem) || block.x > 1024) { emu_err = cudaErrorInvalidConfiguration; return; }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {block.x, block.y, block.z};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
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
    """The reduce kernels' sources built against EMU_RUNTIME, as a ctypes library."""
    from datafusion_tpu_torch.ops.pallas.cuda_lib import SRC_DIR

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' emulation")
    d = tmp_path_factory.mktemp("kernel_emu")
    (d / "cuda_runtime.h").write_text(EMU_RUNTIME)
    procs = []
    for name in ("segreduce.cu", "partition.cu"):
        src = (SRC_DIR / name).read_text()
        src = src.replace("extern __shared__ __align__(16) unsigned char smem[];", "unsigned char* smem = emu_smem;")
        src = re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        (d / f"{name}.cpp").write_text(src)
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-pthread", "-Wno-unknown-pragmas", f"-I{d}", f"-I{SRC_DIR}", "-c",
             str(d / f"{name}.cpp"), "-o", str(d / f"{name}.o")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out
    lib_path = d / "libemu.so"
    subprocess.run([gxx, "-shared", "-pthread", str(d / "segreduce.cu.o"), str(d / "partition.cu.o"), "-o",
                    str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_segreduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp]
    for f in (lib.dft_segreduce, lib.dft_segreduce_dense, lib.dft_windowed_reduce):
        f.restype = i32
    return lib


def _launch(lib, mode, gid, vals, masks, ops, g):
    """The wrappers' launches on CPU tensors: `fold_tables`, one C call per
    launch of the mode's op split. Returns (tables, launches)."""
    if mode == "sorted":
        launches = [(lo, hi, 1) for lo, hi in sr.sorted_launch_ops(len(ops))]
    elif mode == "dense":
        launches = sr.fold_launches(len(ops), g)
    else:
        launches = [(0, len(ops), 1)]
    tables, done = sr.fold_tables(ops, vals, g, "cpu", counters=len(launches))
    kinds = [sr._KIND[(op, None if v is None else v.dtype)] for op, v in zip(ops, vals)]
    for (lo, hi, reps), counter in zip(launches, done):
        k = hi - lo
        arrays = ((ctypes.c_int * k)(*kinds[lo:hi]),
                  (ctypes.c_void_p * k)(*[None if v is None else v.data_ptr() for v in vals[lo:hi]]),
                  (ctypes.c_void_p * k)(*[None if m is None else m.data_ptr() for m in masks[lo:hi]]),
                  (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables[lo:hi]]))
        if mode == "sorted":
            rc = lib.dft_segreduce(gid.data_ptr(), gid.shape[0], g, k, *arrays, counter, None)
        elif mode == "dense":
            rc = lib.dft_segreduce_dense(gid.data_ptr(), gid.shape[0], g, reps, k, *arrays, counter, None)
        else:
            rc = lib.dft_windowed_reduce(gid.data_ptr(), gid.shape[0], g, k, *arrays, counter, None)
        assert rc == 0
    return tables, len(launches)


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


@pytest.mark.parametrize("case", ["slab", "shuffled", "widest", "skew", "unsorted ragged", "whole windows"])
def test_windowed_kernel_matches_plain(emu, monkeypatch, case):
    """K4 over K3's slab (10,001 slots, 5 buckets), the same slab shuffled
    (chunks mix buckets and windows: global atomics), 14 ops over 16,383
    slots, 80% of the rows on one gid, unsorted ids with negatives and a
    ragged last chunk, and a slot count that fills its last window."""
    monkeypatch.setenv("EMU_SMS", "6")
    rng = np.random.default_rng(len(case))
    nslots = {"widest": 16_383, "whole windows": 4096}.get(case, 10_001)
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
    k, _ = _launch(emu, "window", gid, vals, masks, ops, nslots)
    _assert_tables(ops, k, pt.windowed_reduce_plain(gid, vals, masks, ops=ops, num_groups=nslots))


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
