// Reduction op traits shared by K2 (segreduce.cu), K4 (partition.cu) and
// K6 (ragged_shuffle.cu): the op kinds, the order-preserving integer image
// of floats, the per-op contribution / combine / atomic, and the fold
// tile of K2 (both modes), K4 and K6.
//
// SUM accumulates in f64 for float values and in i64 for integers, COUNT
// is i64, and MIN/MAX keep the value type: f32/f64 reduce on their
// order-preserving integer image (NaN past +inf), held in the fold
// tile's zero-identity form below. `atomic` works on a shared or a global
// address.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "launch_fill.cuh"

// op kinds; mirrored in ops/pallas/segreduce.py `_KIND`
enum {
  K_SUM_F32 = 0, K_SUM_F64, K_SUM_I32, K_SUM_I64, K_COUNT,
  K_MIN_F32, K_MAX_F32, K_MIN_F64, K_MAX_F64,
  K_MIN_I32, K_MAX_I32, K_MIN_I64, K_MAX_I64
};

__device__ __forceinline__ int img32(float x) {
  int b = __float_as_int(x);
  return b < 0 ? (int)(0x80000000u - (unsigned int)b) : b;
}
__device__ __forceinline__ long long img64(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (long long)(0x8000000000000000ULL - (unsigned long long)b) : b;
}

// --- op traits: value type In, accumulator Acc, contribution, combine ---
// `of(x)` is value x's contribution. MIN/MAX's Acc is the signed
// order-preserving image; their tables hold it in the fold tile's form
// (Zero<Op> below).
template <typename InT, typename AccT>
struct SumOp {
  typedef InT In;
  typedef AccT Acc;
  static constexpr int MM = 0;  // neither MIN (1) nor MAX (2)
  static __device__ __forceinline__ Acc of(In x) { return (Acc)x; }
  static __device__ __forceinline__ Acc combine(Acc x, Acc y) { return x + y; }
};
struct SumF64Op : SumOp<double, double> {
  static __device__ __forceinline__ double combine(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ void atomic(double* p, double v) { atomicAdd(p, v); }
};
struct SumF32Op : SumOp<float, double> {
  static __device__ __forceinline__ double combine(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ void atomic(double* p, double v) { atomicAdd(p, v); }
};
template <typename InT>
struct SumIntOp : SumOp<InT, long long> {
  static __device__ __forceinline__ long long combine(long long x, long long y) {
    return (long long)((unsigned long long)x + (unsigned long long)y);  // wraps
  }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
};
struct CountOp {
  typedef uint8_t In;  // no value stream
  typedef long long Acc;
  static constexpr int MM = 0;
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
};
template <typename InT, typename AccT, bool IS_MIN>
struct MinMaxOp {
  typedef InT In;
  typedef AccT Acc;
  static constexpr int MM = IS_MIN ? 1 : 2;
  static __device__ __forceinline__ Acc of(In x);
};
#define MINMAX_OF(InT, AccT, EXPR)                                                  \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, true>::of(InT x) { return EXPR; }  \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, false>::of(InT x) { return EXPR; }
MINMAX_OF(float, int, img32(x))
MINMAX_OF(double, long long, img64(x))
MINMAX_OF(int, int, x)
MINMAX_OF(long long, long long, x)

typedef MinMaxOp<float, int, true> MinF32Op;
typedef MinMaxOp<float, int, false> MaxF32Op;
typedef MinMaxOp<double, long long, true> MinF64Op;
typedef MinMaxOp<double, long long, false> MaxF64Op;
typedef MinMaxOp<int, int, true> MinI32Op;
typedef MinMaxOp<int, int, false> MaxI32Op;
typedef MinMaxOp<long long, long long, true> MinI64Op;
typedef MinMaxOp<long long, long long, false> MaxI64Op;

// Calls FN<Op>(...) for op kind KIND; an unknown kind calls nothing (the
// host entries reject it before launching).
#define DFT_DISPATCH_KIND(KIND, FN, ...)                           \
  switch (KIND) {                                                  \
    case K_SUM_F32: FN<SumF32Op>(__VA_ARGS__); break;              \
    case K_SUM_F64: FN<SumF64Op>(__VA_ARGS__); break;              \
    case K_SUM_I32: FN<SumIntOp<int> >(__VA_ARGS__); break;        \
    case K_SUM_I64: FN<SumIntOp<long long> >(__VA_ARGS__); break;  \
    case K_COUNT: FN<CountOp>(__VA_ARGS__); break;                 \
    case K_MIN_F32: FN<MinF32Op>(__VA_ARGS__); break;              \
    case K_MAX_F32: FN<MaxF32Op>(__VA_ARGS__); break;              \
    case K_MIN_F64: FN<MinF64Op>(__VA_ARGS__); break;              \
    case K_MAX_F64: FN<MaxF64Op>(__VA_ARGS__); break;              \
    case K_MIN_I32: FN<MinI32Op>(__VA_ARGS__); break;              \
    case K_MAX_I32: FN<MaxI32Op>(__VA_ARGS__); break;              \
    case K_MIN_I64: FN<MinI64Op>(__VA_ARGS__); break;              \
    case K_MAX_I64: FN<MaxI64Op>(__VA_ARGS__); break;              \
    default: break;                                                \
  }

static inline bool dft_valid_kind(int kind) { return kind >= K_SUM_F32 && kind <= K_MAX_I64; }

// A window is DFT_WINDOW slots of 8 bytes per op (K4's bucket, K6's
// receiver table): DFT_MAX_OPS of them fit the 227 KB a Hopper block may
// hold.
#define DFT_WINDOW 2048
#define DFT_MAX_OPS 14

// --- the fold tile (K2 dense mode, K4, K6; K2 sorted mode shares its loads and tables)
// A block folds rows into one shared-memory table per op, `slots` live
// slots of 8-byte entries, each slot held `reps` times (a power of two up
// to 32): lane l of a warp updates replica l % reps, so the lanes of a
// warp on one slot do not contend; the flush combines the replicas. A
// thread takes DFT_TILE consecutive rows: their ids, then each op's values
// and mask bytes, load as one or two 16-byte vectors (4 bytes for masks)
// where the stream is aligned, and the op kind's switch is taken once per
// tile, not per row. Equal neighbouring ids combine in registers before
// the shared atomic.
//
// Every table, in shared and in device memory, holds each op's identity
// as 0 bits (Zero<Op>), so one memset clears them all: SUM and COUNT as
// they are; MIN and MAX on the unsigned order-preserving image u (the
// signed image with its sign bit flipped), MAX as u and MIN as ~u, both
// reduced by unsigned max. The last block to finish turns each MIN/MAX
// slot into the op's value in place (`fold_finish`): the value type, and
// +-inf for an empty float slot, as K2's wrapper decodes them.
#define DFT_TILE 4
#define DFT_FOLD_TPB 512
#define DFT_TILE_ROWS (DFT_FOLD_TPB * DFT_TILE)
#define DFT_FOLD_MAX_OPS 32
#define DFT_MAX_REPS 32
#define DFT_BLOCK_MAX_ROWS 0x7fffffffLL  // rows one block may fold: COUNT's shared counters are 32-bit

// the ops of a fold, in shared memory (indexed per op without a stack frame)
struct FoldShared {
  int kind[DFT_FOLD_MAX_OPS];
  const void* val[DFT_FOLD_MAX_OPS];
  const uint8_t* mask[DFT_FOLD_MAX_OPS];
  void* out[DFT_FOLD_MAX_OPS];
};

// the same, passed by value to a kernel
struct FoldArgs {
  int n;
  int kinds[DFT_FOLD_MAX_OPS];
  const void* vals[DFT_FOLD_MAX_OPS];
  const uint8_t* masks[DFT_FOLD_MAX_OPS];
  void* outs[DFT_FOLD_MAX_OPS];
};

// The C entries' op arrays into FoldArgs; false for a bad count or kind.
static inline bool fold_args(FoldArgs* o, int n_ops, const int* kinds, const void* const* vals,
                             const uint8_t* const* masks, void* const* outs) {
  if (n_ops < 0 || n_ops > DFT_FOLD_MAX_OPS) return false;
  o->n = n_ops;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return false;
    o->kinds[a] = kinds[a];
    o->vals[a] = vals[a];
    o->masks[a] = masks[a];
    o->outs[a] = outs[a];
  }
  return true;
}

// a block's copy of the kernel's FoldArgs; read after the next __syncthreads
__device__ __forceinline__ void load_fold_shared(FoldShared& s, const FoldArgs& o) {
  if (threadIdx.x < o.n) {
    s.kind[threadIdx.x] = o.kinds[threadIdx.x];
    s.val[threadIdx.x] = o.vals[threadIdx.x];
    s.mask[threadIdx.x] = o.masks[threadIdx.x];
    s.out[threadIdx.x] = o.outs[threadIdx.x];
  }
}

static inline bool dft_valid_reps(int reps) { return reps >= 1 && reps <= DFT_MAX_REPS && (reps & (reps - 1)) == 0; }

// Shared is what a block's shared table holds, Acc the device table;
// a shared value goes to the device table through widen().
template <class Op, int MM = Op::MM>
struct Zero {  // SUM: the op itself, whose identity is 0
  typedef typename Op::In In;
  typedef typename Op::Acc Acc;
  typedef Acc Shared;
  static __device__ __forceinline__ Shared of(In x) { return Op::of(x); }
  static __device__ __forceinline__ Shared combine(Shared x, Shared y) { return Op::combine(x, y); }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { Op::atomic(p, v); }
  static __device__ __forceinline__ Acc widen(Shared v) { return v; }
};

// COUNT counts in 32 bits in shared memory, where a 32-bit add is a native
// atomic and a 64-bit one a CAS loop; a block folds fewer than 2^32 rows
// (the C entries size the grid so).
template <>
struct Zero<CountOp, 0> {
  typedef CountOp::In In;
  typedef CountOp::Acc Acc;
  typedef unsigned int Shared;
  static __device__ __forceinline__ Shared of(In) { return 1u; }
  static __device__ __forceinline__ Shared combine(Shared x, Shared y) { return x + y; }
  static __device__ __forceinline__ void atomic(Shared* p, Shared v) { atomicAdd(p, v); }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { CountOp::atomic(p, v); }
  static __device__ __forceinline__ Acc widen(Shared v) { return (Acc)v; }
};

template <class Op, int MM>
struct ZeroMinMax {  // MIN (MM 1) and MAX (MM 2)
  typedef typename Op::In In;
  typedef typename Op::Acc Img;                        // the signed image
  typedef typename std::make_unsigned<Img>::type Acc;  // what the tables hold
  typedef Acc Shared;
  static constexpr Acc SIGN = (Acc)1 << (sizeof(Acc) * 8 - 1);
  static __device__ __forceinline__ Acc of(In x) {
    const Acc u = (Acc)Op::of(x) ^ SIGN;
    return MM == 1 ? (Acc)~u : u;
  }
  static __device__ __forceinline__ Acc combine(Acc x, Acc y) { return y > x ? y : x; }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { atomicMax(p, v); }
  static __device__ __forceinline__ Acc widen(Acc v) { return v; }
  // a finished slot into the value: the image back, floats from their image
  static __device__ __forceinline__ void decode(Acc* p) {
    const Acc t = __ldcg(p);
    const Img img = (Img)((MM == 1 ? (Acc)~t : t) ^ SIGN);
    Img out = img;
    if constexpr (std::is_floating_point<In>::value) {
      if (t == 0) {  // no row reached the slot
        const In inf = MM == 1 ? (In)INFINITY : (In)-INFINITY;
        memcpy(&out, &inf, sizeof(In));
      } else if (img < 0) {
        out = (Img)(SIGN - (Acc)img);  // the image is its own inverse
      }
    }
    *p = (Acc)out;
  }
};
template <class Op>
struct Zero<Op, 1> : ZeroMinMax<Op, 1> {};
template <class Op>
struct Zero<Op, 2> : ZeroMinMax<Op, 2> {};

// rows r .. r + cnt - 1 of p (cnt <= DFT_TILE); the rest read T()
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ p, long long r, int cnt, T (&x)[DFT_TILE]) {
  constexpr int bytes = (int)sizeof(T) * DFT_TILE;
  constexpr int align = bytes < 16 ? bytes : 16;
  static_assert(bytes == 4 || bytes % 16 == 0, "tile of 4-byte or 16-byte words");
  if (cnt == DFT_TILE && ((uintptr_t)(p + r) & (align - 1)) == 0) {
    if constexpr (bytes == 4) {
      const unsigned int u = __ldg((const unsigned int*)(p + r));
      memcpy(x, &u, 4);
    } else {
      uint4 u[bytes / 16];
#pragma unroll
      for (int i = 0; i < bytes / 16; ++i) u[i] = __ldg((const uint4*)(p + r) + i);
      memcpy(x, u, bytes);
    }
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) x[k] = k < cnt ? p[r + k] : T();
  }
}

// one op over one thread's tile: w[k] is row r + k's slot, or -1 (dropped)
template <class Op>
__device__ __forceinline__ void tile_fold(unsigned char* tbl, int reps, int rep, const void* vals,
                                          const uint8_t* mask, long long r, int cnt, const int (&w)[DFT_TILE]) {
  typedef Zero<Op> Z;
  typedef typename Op::In In;
  typedef typename Z::Shared Acc;
  bool any = false;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) any |= w[k] >= 0;
  if (!any) return;  // no row kept: read no values (K3's gaps)
  In x[DFT_TILE] = {};
  if constexpr (!std::is_same<Op, CountOp>::value) load_tile((const In*)vals, r, cnt, x);
  bool keep[DFT_TILE];
  if (mask != nullptr) {
    uint8_t m[DFT_TILE];
    load_tile(mask, r, cnt, m);
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) keep[k] = w[k] >= 0 && m[k];
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) keep[k] = w[k] >= 0;
  }
  Acc* t = (Acc*)tbl + rep;
  int cur = -1;
  Acc acc = 0;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    if (!keep[k]) continue;
    const Acc c = Z::of(x[k]);
    if (w[k] == cur) {
      acc = Z::combine(acc, c);
    } else {
      if (cur >= 0) Z::atomic(t + cur * reps, acc);
      cur = w[k];
      acc = c;
    }
  }
  if (cur >= 0) Z::atomic(t + cur * reps, acc);
}

// `bytes` (a multiple of 8) of shared tables to 0: every op's identity
__device__ __forceinline__ void fold_init(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 8; i += blockDim.x) ((unsigned long long*)smem)[i] = 0;
}

// Tiles t_first, t_first + t_step, ... of the `cnt` rows from row `base`
// (DFT_TILE_ROWS rows a tile) into the block's tables (op a's at
// smem + a * tbl_bytes); ids outside [0, slots) are dropped.
__device__ __forceinline__ void fold_range(unsigned char* smem, int tbl_bytes, int n_ops, const FoldShared& s,
                                           const int* __restrict__ gid, long long base, long long cnt,
                                           long long t_first, long long t_step, int slots, int reps) {
  const int rep = threadIdx.x & (reps - 1);  // the lane's replica: reps divides the warp
  const long long tiles = (cnt + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  for (long long t = t_first; t < tiles; t += t_step) {
    const long long rel = t * DFT_TILE_ROWS + (long long)threadIdx.x * DFT_TILE;
    if (rel >= cnt) continue;
    const int c = cnt - rel < DFT_TILE ? (int)(cnt - rel) : DFT_TILE;
    const long long r = base + rel;
    int w[DFT_TILE];
    load_tile(gid, r, c, w);
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k)
      if (k >= c || w[k] < 0 || w[k] >= slots) w[k] = -1;
    for (int a = 0; a < n_ops; ++a) {
      DFT_DISPATCH_KIND(s.kind[a], tile_fold, smem + a * tbl_bytes, reps, rep, s.val[a], s.mask[a], r, c, w)
    }
  }
}

// one op's rows of a tile whose slot lies outside the block's window
// (far[k] >= 0): each by a global atomic into the device table
template <class Op>
__device__ __forceinline__ void tile_far(void* out, const void* vals, const uint8_t* mask, long long r, int cnt,
                                         const int (&far)[DFT_TILE]) {
  typedef Zero<Op> Z;
  typedef typename Op::In In;
  In x[DFT_TILE] = {};
  if constexpr (!std::is_same<Op, CountOp>::value) load_tile((const In*)vals, r, cnt, x);
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k)
    if (far[k] >= 0 && (mask == nullptr || mask[r + k]))
      Z::atomic((typename Z::Acc*)out + far[k], Z::widen(Z::of(x[k])));
}

// One thread's tile, rows r .. r + c - 1, into the block's tables of the
// window [base, base + DFT_WINDOW) (one replica): a row whose id lies in
// [0, num_groups) but outside the window goes to the device table by a
// global atomic, and any other row is dropped.
__device__ __forceinline__ void fold_window_tile(unsigned char* smem, int tbl_bytes, int n_ops, const FoldShared& s,
                                                 const int* __restrict__ gid, long long r, int c, int base,
                                                 int num_groups) {
  int w[DFT_TILE], far[DFT_TILE];
  load_tile(gid, r, c, w);
  bool any_far = false;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    const int g = w[k];
    const bool keep = k < c && g >= 0 && g < num_groups;
    const bool in = keep && g >= base && g - base < DFT_WINDOW;
    far[k] = keep && !in ? g : -1;
    any_far |= far[k] >= 0;
    w[k] = in ? g - base : -1;
  }
  for (int a = 0; a < n_ops; ++a) {
    DFT_DISPATCH_KIND(s.kind[a], tile_fold, smem + a * tbl_bytes, 1, 0, s.val[a], s.mask[a], r, c, w)
    if (any_far) {
      DFT_DISPATCH_KIND(s.kind[a], tile_far, s.out[a], s.val[a], s.mask[a], r, c, far)
    }
  }
}

// one op's touched slots, replicas combined, into its device table from slot `base`
template <class Op>
__device__ __forceinline__ void tile_flush(unsigned char* tbl, void* out, long long base, int slots, int reps) {
  typedef Zero<Op> Z;
  typedef typename Z::Shared Shared;
  const Shared* t = (const Shared*)tbl;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    Shared v = t[s * reps];
    for (int r = 1; r < reps; ++r) v = Z::combine(v, t[s * reps + r]);
    if (v != (Shared)0) Z::atomic((typename Z::Acc*)out + base + s, Z::widen(v));
  }
}

template <class Op>
__device__ __forceinline__ void tile_decode(void* out, long long n) {
  typedef Zero<Op> Z;
  if constexpr (Op::MM != 0)
    for (long long i = threadIdx.x; i < n; i += blockDim.x) Z::decode((typename Z::Acc*)out + i);
}

// The last block of the grid to get here (a ticket on `done`, 0 before
// the launch) decodes the ops' `n_out`-slot device tables in place, once
// every block's writes to them are done.
__device__ __forceinline__ void fold_finish(int n_ops, const FoldShared& s, long long n_out, unsigned int* done) {
  __shared__ bool last;
  __threadfence();  // this block's writes reach every block before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int a = 0; a < n_ops; ++a) {
    DFT_DISPATCH_KIND(s.kind[a], tile_decode, s.out[a], n_out)
  }
}

// Every op's table into its device table from slot `base`, then
// fold_finish.
__device__ __forceinline__ void fold_flush(unsigned char* smem, int tbl_bytes, int n_ops, const FoldShared& s,
                                           long long base, int slots, int reps, long long n_out,
                                           unsigned int* done) {
  for (int a = 0; a < n_ops; ++a) {
    DFT_DISPATCH_KIND(s.kind[a], tile_flush, smem + a * tbl_bytes, s.out[a], base, slots, reps)
  }
  fold_finish(n_ops, s, n_out, done);
}

// The grid that fills the card: blocks of DFT_FOLD_TPB threads with
// `smem` dynamic bytes each that fit an SM at once, times the SMs
// (launch_fill.cuh). Returns 0 and sets *err when the kernel cannot take
// `smem`.
template <typename K>
static inline long long fold_blocks(K kernel, int smem, cudaError_t* err) {
  return dft_fill_blocks(kernel, DFT_FOLD_TPB, smem, err);
}
