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
#define __grid_constant__
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
    lib.dft_segreduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.dft_fused_stage.argtypes = [vp, i64, i32, i32, vp]
    lib.dft_ragged_exchange.argtypes = [vp, vp, i32, i32, i64, i32, vp]
    lib.dft_ragged_exchange_fold.argtypes = [vp, vp, i32, i32, i64, i32, i32, i32, vp, vp, vp, vp]
    for f in (lib.dft_segreduce, lib.dft_segreduce_dense, lib.dft_windowed_reduce, lib.dft_fused_stage,
              lib.dft_ragged_exchange, lib.dft_ragged_exchange_fold):
        f.restype = i32
    assert lib.dft_fused_stage_program_size() == ctypes.sizeof(fs._CProgram)
    assert lib.dft_ragged_exchange_args_size() == ctypes.sizeof(rs.ExchangeArgs)
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
    k = len(ops)
    [(_, _, reps)] = sr.fold_launches(k, num_groups)
    tables, [done] = sr.fold_tables(ops, vals[0], num_groups, "cpu", lead=(n_recv,))
    per_op = [rs._op_masks(m, mask_map) for m in masks]
    ptrs = torch.tensor(rs.fold_pointer_table(gids, vals, per_op), dtype=torch.int64)
    kinds = (ctypes.c_int * k)(*[sr._KIND[(op, None if v is None else v.dtype)] for op, v in zip(ops, vals[0])])
    outs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables])
    assert emu.dft_ragged_exchange_fold(ptrs.data_ptr(), sizes.data_ptr(), n_send, n_recv, split_cap, num_groups,
                                        reps, k, kinds, outs, done, None) == 0
    want = rs.ragged_exchange_fold_plain(gids, vals, masks, sizes, ops=ops, mask_map=mask_map, n_dev=n_recv,
                                         split_cap=split_cap, num_groups=num_groups)
    for i in range(n_recv):
        _assert_tables(ops, [t[i] for t in tables], want[i])
