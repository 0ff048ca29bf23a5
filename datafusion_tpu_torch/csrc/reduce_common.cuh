// Reduction op traits shared by K2 (segreduce.cu), K4 (partition.cu) and
// K6 (ragged_shuffle.cu): the op kinds, the order-preserving integer image
// of floats, the per-op contribution / combine / atomic, the fixed-point
// float SUM, and the fold tile of K2 (both modes), K4 and K6.
//
// SUM accumulates in f64 for float values and in i64 for integers, COUNT
// is i64, and MIN/MAX keep the value type: f32/f64 reduce on their
// order-preserving integer image (NaN past +inf), held in the fold
// tile's zero-identity form below. `atomic` works on a shared or a global
// address.
//
// What a float SUM gives, the same bits in every run:
// * In the fold tile (K2 dense, K4, K6), a float SUM (f64, and f32
//   widened to f64) of a slot is the same for any order of the launch's
//   rows and any schedule of its blocks and lanes. It is added in fixed
//   point by integer atomics, which associate (fix_tile_fold below): E is the
//   exponent of the largest finite |value| among the launch's kept rows
//   (a first pass, fold_scale_*, leaves it in device memory, so the
//   launch reads nothing back to the host; K4 takes it from K3 where K3
//   made its slab); each value splits into three signed 32-bit digits on
//   the grid 2^(E-95), rounded to nearest even in the last, each digit
//   summed exactly (in a block's shared memory as two 32-bit words, in
//   device memory in its own int64 table), and a fourth table ORs the
//   NaN / +inf / -inf flags. The last block turns the exact digit
//   totals into the f64 result, rounded once to nearest (fix_decode).
//   A value's error is at most half a grid step, so a slot of n rows is
//   within n * 2^(E-96) of the exact sum, plus the result's own rounding
//   (half an ulp): a value more than 95 bits below the launch's largest is
//   rounded to the grid, and one below half a step reads 0. The int64
//   totals are exact for fewer than 2^31 rows a launch (a digit is at most
//   2^32 in magnitude); the wrappers refuse more.
// * In K2 sorted mode, a float SUM is summed in f64 in row order, and the
//   runs that reach past a warp's span are combined in span order
//   (segreduce.cu): the same bits for the same rows in the same order on
//   the same card (the grid is fixed by the card's SM count).
// * IEEE outcomes hold in either: any NaN gives NaN, +inf with -inf NaN,
//   +inf alone +inf and -inf alone -inf; a slot no row reached reads +0.0;
//   finite values whose exact total overflows give +-inf.
// COUNT and integer SUM are integer atomics, MIN and MAX unsigned max: any
// order gives the same result.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "launch_fill.cuh"

// op kinds; mirrored in ops/pallas/segreduce.py `_KIND` and `_FIX`. A
// float SUM is K_SUM_F32 / K_SUM_F64 in sorted mode and K_FIX_F32 /
// K_FIX_F64 in the fold tile, whose device table is four tables of the
// launch's `stride` slots from its out pointer (the digits 0-2, then the
// flags) and which takes DFT_FIX_TABLES shared tables (the digits).
enum {
  K_SUM_F32 = 0, K_SUM_F64, K_SUM_I32, K_SUM_I64, K_COUNT,
  K_MIN_F32, K_MAX_F32, K_MIN_F64, K_MAX_F64,
  K_MIN_I32, K_MAX_I32, K_MIN_I64, K_MAX_I64,
  K_FIX_F32, K_FIX_F64, K_KINDS
};
#define DFT_FIX_TABLES 3

// Ablations, for scripts/fold_variants.py only (the engine's library
// never sets them): DFT_ABLATE 1 computes every float SUM's digits in the
// fold tile but adds none to the shared tables (a branch never taken keeps
// them alive), 2 skips the flush of the shared tables to the device tables.
#ifndef DFT_ABLATE
#define DFT_ABLATE 0
#endif

__device__ __forceinline__ int img32(float x) {
  int b = __float_as_int(x);
  return b < 0 ? (int)(0x80000000u - (unsigned int)b) : b;
}
__device__ __forceinline__ long long img64(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (long long)(0x8000000000000000ULL - (unsigned long long)b) : b;
}

// --- atomics on the device tables ---------------------------------------
// Explicitly global: a table pointer reaches these through shared memory,
// so a plain atomic on it compiles for a generic address, with a branch
// for a shared one that, for 64 bits, is a CAS loop (ATOMS.CAST.SPIN.64).
// No result is read, so each is a reduction (RED).
__device__ __forceinline__ void dft_red_add(unsigned long long* p, unsigned long long v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
#else
  atomicAdd(p, v);
#endif
}
__device__ __forceinline__ void dft_red_or(unsigned long long* p, unsigned long long v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.or.b64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
#else
  atomicOr(p, v);
#endif
}
__device__ __forceinline__ void dft_red_max(unsigned long long* p, unsigned long long v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.max.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
#else
  atomicMax(p, v);
#endif
}
__device__ __forceinline__ void dft_red_max(unsigned int* p, unsigned int v) {
#ifdef __CUDA_ARCH__
  asm volatile("red.global.max.u32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "r"(v) : "memory");
#else
  atomicMax(p, v);
#endif
}

// A 64-bit total in shared memory as two 32-bit words added by native
// 32-bit atomics (a 64-bit shared add is a CAS loop): the low word by v's
// low half, the high word by v's high half and the low add's carry, only
// where that is not 0. The words' wrap-arounds add up to the 64-bit total
// (mod 2^64) in any order.
__device__ __forceinline__ void dft_shared_add64(long long* p, long long v) {
  unsigned int* w = (unsigned int*)p;  // little-endian: w[0] the low word
  const unsigned int lo = (unsigned int)v;
  const unsigned int old = lo ? atomicAdd(w, lo) : 0u;
  const unsigned int hi = (unsigned int)((unsigned long long)v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi) atomicAdd(w + 1, hi);
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
// K2 sorted mode's float SUM: f64 in registers in row order (no atomic:
// segreduce.cu combines the runs that cross spans in span order)
struct SumF64Op : SumOp<double, double> {
  static __device__ __forceinline__ double combine(double x, double y) { return __dadd_rn(x, y); }
};
struct SumF32Op : SumOp<float, double> {
  static __device__ __forceinline__ double combine(double x, double y) { return __dadd_rn(x, y); }
};
template <typename InT>
struct SumIntOp : SumOp<InT, long long> {
  static __device__ __forceinline__ long long combine(long long x, long long y) {
    return (long long)((unsigned long long)x + (unsigned long long)y);  // wraps
  }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    dft_red_add((unsigned long long*)p, (unsigned long long)v);
  }
};
struct CountOp {
  typedef uint8_t In;  // no value stream
  typedef long long Acc;
  static constexpr int MM = 0;
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    dft_red_add((unsigned long long*)p, (unsigned long long)v);
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

// --- the fixed-point float SUM of the fold tile --------------------------
// The scale of one launch's float SUM: E from the largest finite |value|'s
// bits `m` (0 for none), and 2^(31 - E) as two factors s1 * s2, each a
// normal double, so x * s1 * s2 is exact for every finite x of the launch.
struct FixScale {
  double s1, s2;
};
__device__ __forceinline__ double dft_pow2(int k) {  // k in [-1022, 1023]
  return __longlong_as_double((long long)(k + 1023) << 52);
}
__device__ __forceinline__ int fix_exponent(unsigned long long m) {
  const int b = (int)(m >> 52);
  return (b < 1 ? 1 : b) - 1023;
}
__device__ __forceinline__ FixScale fix_scale(unsigned long long m) {
  const int t = 31 - fix_exponent(m);  // [-992, 1053]
  const int t1 = t > 1000 ? 1000 : t;
  return {dft_pow2(t1), dft_pow2(t - t1)};
}
__device__ __forceinline__ bool fix_finite(double x) {
  return (__double_as_longlong(x) & 0x7ff0000000000000LL) != 0x7ff0000000000000LL;
}

// The digits of finite x on the grid 2^(E-95): x * 2^(31-E) = d0 + d1
// 2^-32 + d2 2^-64, d0 and d1 truncated, d2 rounded to nearest even. Every
// step but the last rint is exact: a product by a power of two below
// 2^32, a fractional part. All 0 for a non-finite x (the flags carry it).
__device__ __forceinline__ void fix_digits(double x, const FixScale& sc, long long& d0, long long& d1,
                                           long long& d2) {
  if (!fix_finite(x)) {
    d0 = d1 = d2 = 0;
    return;
  }
  double a = __dmul_rn(__dmul_rn(x, sc.s1), sc.s2);
  double d = trunc(a);
  d0 = __double2ll_rz(d);
  a = __dmul_rn(__dsub_rn(a, d), 4294967296.0);
  d = trunc(a);
  d1 = __double2ll_rz(d);
  a = __dmul_rn(__dsub_rn(a, d), 4294967296.0);
  d2 = __double2ll_rz(rint(a));
}

// bit 0: NaN, bit 1: +inf, bit 2: -inf
__device__ __forceinline__ unsigned int fix_flags(double x) {
  const long long b = __double_as_longlong(x);
  if ((b & 0x7ff0000000000000LL) != 0x7ff0000000000000LL) return 0u;
  if (b & 0x000fffffffffffffLL) return 1u;
  return b < 0 ? 4u : 2u;
}

// The f64 value of the digit totals t0 2^64 + t1 2^32 + t2 on the grid
// 2^(e-95), rounded once to nearest even, or what the flags say. The
// totals are exact (fewer than 2^31 rows), so this is a function of the
// multiset of values alone.
__device__ __forceinline__ double fix_decode(long long t0, long long t1, long long t2, unsigned long long f, int e) {
  if ((f & 1) || (f & 6) == 6) return __longlong_as_double(0x7ff8000000000000LL);
  if (f & 2) return __longlong_as_double(0x7ff0000000000000LL);
  if (f & 4) return __longlong_as_double((long long)0xfff0000000000000ULL);
  // carries: the total as a 128-bit two's complement number hi:lo
  const long long m1 = t1 + (t2 >> 32);
  long long hi = t0 + (m1 >> 32);
  unsigned long long lo = ((unsigned long long)(unsigned int)m1 << 32) | (unsigned int)t2;
  const bool neg = hi < 0;
  unsigned long long h = (unsigned long long)hi;
  if (neg) {  // the magnitude
    lo = ~lo + 1ULL;
    h = ~h + (lo == 0 ? 1ULL : 0ULL);
  }
  double r;
  int k = 0;
  if (h == 0) {
    r = __ull2double_rn(lo);
  } else {  // the top 63 bits (bit 62 set), the rest as a sticky bit: one rounding
    const int s = __clzll((long long)h) - 1;  // h < 2^63: s in [0, 62]
    unsigned long long w = h << s;
    if (s) w |= lo >> (64 - s);
    w |= ((s ? lo << s : lo) != 0) ? 1ULL : 0ULL;
    r = __ll2double_rn((long long)w);
    k = 64 - s;
  }
  int p = k + e - 95;  // [-1117, 993]
  if (p < -1022) {
    r = __dmul_rn(r, dft_pow2(-1000));
    p += 1000;
  }
  r = __dmul_rn(r, dft_pow2(p));
  return neg ? -r : r;
}

// Calls FN<Op>(...) for op kind KIND; an unknown kind calls nothing (the
// host entries reject it before launching). DFT_DISPATCH_KIND takes K2
// sorted mode's kinds (float SUM in f64), DFT_DISPATCH_EXACT every kind
// but a float SUM (the fold tile calls its fixed-point SUM by name).
#define DFT_CASES_EXACT(FN, ...)                                   \
  case K_SUM_I32: FN<SumIntOp<int> >(__VA_ARGS__); break;          \
  case K_SUM_I64: FN<SumIntOp<long long> >(__VA_ARGS__); break;    \
  case K_COUNT: FN<CountOp>(__VA_ARGS__); break;                   \
  case K_MIN_F32: FN<MinF32Op>(__VA_ARGS__); break;                \
  case K_MAX_F32: FN<MaxF32Op>(__VA_ARGS__); break;                \
  case K_MIN_F64: FN<MinF64Op>(__VA_ARGS__); break;                \
  case K_MAX_F64: FN<MaxF64Op>(__VA_ARGS__); break;                \
  case K_MIN_I32: FN<MinI32Op>(__VA_ARGS__); break;                \
  case K_MAX_I32: FN<MaxI32Op>(__VA_ARGS__); break;                \
  case K_MIN_I64: FN<MinI64Op>(__VA_ARGS__); break;                \
  case K_MAX_I64: FN<MaxI64Op>(__VA_ARGS__); break;
#define DFT_DISPATCH_KIND(KIND, FN, ...)                           \
  switch (KIND) {                                                  \
    case K_SUM_F32: FN<SumF32Op>(__VA_ARGS__); break;              \
    case K_SUM_F64: FN<SumF64Op>(__VA_ARGS__); break;              \
    DFT_CASES_EXACT(FN, __VA_ARGS__)                               \
    default: break;                                                \
  }
#define DFT_DISPATCH_EXACT(KIND, FN, ...)                          \
  switch (KIND) {                                                  \
    DFT_CASES_EXACT(FN, __VA_ARGS__)                               \
    default: break;                                                \
  }

__host__ __device__ __forceinline__ bool dft_fix_kind(int kind) { return kind == K_FIX_F32 || kind == K_FIX_F64; }
__host__ __device__ __forceinline__ bool dft_float_sum(int kind) { return kind == K_SUM_F32 || kind == K_SUM_F64; }
// the fold tile's kinds, or sorted mode's
static inline bool dft_valid_kind(int kind, bool fold) {
  if (kind < 0 || kind >= K_KINDS) return false;
  return fold ? !dft_float_sum(kind) : !dft_fix_kind(kind);
}

// A window is DFT_WINDOW slots (K4's bucket, K6's receiver table). The
// host counts a launch's shared tables in 8-byte-slot units (`ntbl`: one
// an op, DFT_FIX_TABLES a float SUM), and DFT_MAX_OPS units of a window fit
// the 227 KB a Hopper block may hold; a table whose slot is narrower
// (dft_slot_bytes) takes fewer bytes than its units.
#define DFT_WINDOW 2048
#define DFT_MAX_OPS 14

// --- the fold tile (K2 dense mode, K4, K6; K2 sorted mode shares its loads and tables)
// A block folds rows into one shared-memory table per op, `slots` live
// slots, each slot held `reps` times (a power of two up to 32): lane l of
// a warp updates replica l % reps, so the lanes of a warp on one slot do
// not contend; the flush combines the replicas. A thread takes DFT_TILE
// consecutive rows: their ids, then each op's values and mask bytes (one
// or two 16-byte vectors, 4 bytes for masks, where the stream is
// aligned), and the kind's switch is taken once per tile, not per row.
// Equal neighbouring ids combine in registers before the shared atomic,
// and a zero contribution makes none. COUNT and 32-bit MIN/MAX take
// 4-byte slots and a float SUM six 4-byte words (below), each added by a
// native atomic whose result is not read; integer SUM (two 32-bit words
// and a carry) and 64-bit MIN/MAX (a CAS loop) keep 8-byte slots.
//
// Every table, in shared and in device memory, holds each op's identity
// as 0 bits (Zero<Op>), so one memset clears them all: SUM, COUNT and the
// fixed-point digits and flags as they are; MIN and MAX on the unsigned
// order-preserving image u (the signed image with its sign bit flipped),
// MAX as u and MIN as ~u, both reduced by unsigned max. The last block to
// finish turns each MIN/MAX slot into the op's value in place, and each
// float SUM's four tables into its f64 value in the first
// (`fold_decode`): the value type, and +-inf for an empty float MIN/MAX
// slot, as K2's wrapper decodes them.
#define DFT_TILE 4
#define DFT_FOLD_TPB 512
#define DFT_TILE_ROWS (DFT_FOLD_TPB * DFT_TILE)
#define DFT_FOLD_MAX_OPS 32  // ops, and shared tables, of one launch
#define DFT_MAX_REPS 32
#define DFT_BLOCK_MAX_ROWS 0x7fffffffLL  // rows one block may fold: COUNT's shared counters are 32-bit
#define DFT_FIX_MAX_ROWS 0x7fffffffLL    // rows one launch may fold with a float SUM: the digit totals' headroom
#define DFT_MAX_FIX (DFT_FOLD_MAX_OPS / DFT_FIX_TABLES)  // fixed-point float SUMs a launch holds

// A float SUM's shared slot: each of its three digits d (an exact int64
// partial) as two 32-bit words, hi = d >> 16 and lo = d & 0xffff, so d =
// hi * 2^16 + lo; each word is added by one native atomic whose result is
// not read. A row adds less than 2^16 + 1 to a word's magnitude (a digit
// is at most 2^32), so a word stays exact while a block folds
// DFT_FIX_CHECK_ROWS rows from a magnitude of at most DFT_FIX_CHECK_LIMIT:
// at every such check (fix_check) the block moves each word past the limit
// into its device table and zeroes it. A table of rows spread over many
// slots moves nothing until its flush; a hot slot moves its words. Both
// are macros so that the CPU emulation can make the checks move words.
#define DFT_FIX_WORDS 6
#ifndef DFT_FIX_CHECK_ROWS
#define DFT_FIX_CHECK_ROWS 16384
#endif
#ifndef DFT_FIX_CHECK_LIMIT
#define DFT_FIX_CHECK_LIMIT (1 << 29)
#endif
static_assert(DFT_FIX_CHECK_ROWS % DFT_TILE_ROWS == 0, "checks fall between a block's steps of DFT_TILE_ROWS rows");
static_assert((long long)DFT_FIX_CHECK_LIMIT + (long long)DFT_FIX_CHECK_ROWS * 65537 <= 0x7fffffffLL,
              "a float SUM's shared word stays within int32 between two checks");

// Bytes of one slot (one replica) of a fold-tile op's shared table, and
// of one row of its value stream (0: COUNT reads none)
static inline int dft_slot_bytes(int kind) {
  switch (kind) {
    case K_COUNT: case K_MIN_F32: case K_MAX_F32: case K_MIN_I32: case K_MAX_I32: return 4;
    case K_FIX_F32: case K_FIX_F64: return 4 * DFT_FIX_WORDS;
    default: return 8;
  }
}
__device__ __forceinline__ int dft_value_bytes(int kind) {
  switch (kind) {
    case K_COUNT: return 0;
    case K_SUM_F32: case K_SUM_I32: case K_MIN_F32: case K_MAX_F32: case K_MIN_I32: case K_MAX_I32:
    case K_FIX_F32: return 4;
    default: return 8;
  }
}

// the ops of a fold, in shared memory (indexed per op without a stack
// frame); aux is a float SUM's scale word (the fold tile) or its edge
// slots (K2 sorted), sc the fold tile's scale from it, soff the byte
// offset of the op's shared table, mbit the bit of a packed id that
// holds the op's mask (-1: its mask stream, or none), stride the slots of
// each device table (a fixed-point float SUM's four lie one stride
// apart), sr the slots times replicas of a shared table, and id_mod the
// power of two the ids are packed below (0: the ids as given)
struct FoldShared {
  int kind[DFT_FOLD_MAX_OPS];
  int soff[DFT_FOLD_MAX_OPS];
  int mbit[DFT_FOLD_MAX_OPS];
  const void* val[DFT_FOLD_MAX_OPS];
  const uint8_t* mask[DFT_FOLD_MAX_OPS];
  void* out[DFT_FOLD_MAX_OPS];
  void* aux[DFT_FOLD_MAX_OPS];
  FixScale sc[DFT_FOLD_MAX_OPS];
  int fix[DFT_MAX_FIX];
  long long stride;
  int sr, id_mod;
};

// the same, passed by value to a kernel, with what the host counts: the
// shared tables in 8-byte-slot units (ntbl), their layout (smem bytes,
// soff per op: fold_layout), the fixed-point float SUMs (nfix; fix)
struct FoldArgs {
  int n, ntbl, nfix, smem, sr, id_mod;
  long long stride;
  int kinds[DFT_FOLD_MAX_OPS];
  int soff[DFT_FOLD_MAX_OPS];
  int mbit[DFT_FOLD_MAX_OPS];
  int fix[DFT_MAX_FIX];
  const void* vals[DFT_FOLD_MAX_OPS];
  const uint8_t* masks[DFT_FOLD_MAX_OPS];
  void* outs[DFT_FOLD_MAX_OPS];
  void* aux[DFT_FOLD_MAX_OPS];
};

// The C entries' op arrays into FoldArgs, each device table of `stride`
// slots; false for a bad count or kind, more than DFT_FOLD_MAX_OPS shared
// tables, or a float SUM without its aux pointer. `fold`: the fold tile's
// kinds, else K2 sorted mode's.
static inline bool fold_args(FoldArgs* o, int n_ops, const int* kinds, const void* const* vals,
                             const uint8_t* const* masks, void* const* outs, void* const* aux, long long stride,
                             bool fold) {
  if (n_ops < 0 || n_ops > DFT_FOLD_MAX_OPS) return false;
  o->n = n_ops;
  o->stride = stride;
  o->ntbl = o->nfix = o->smem = o->sr = o->id_mod = 0;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a], fold)) return false;
    o->kinds[a] = kinds[a];
    o->vals[a] = vals[a];
    o->masks[a] = masks[a];
    o->mbit[a] = -1;
    o->outs[a] = outs[a];
    o->aux[a] = aux[a];
    o->soff[a] = 0;
    const bool fix = dft_fix_kind(kinds[a]);
    if ((fix || dft_float_sum(kinds[a])) && aux[a] == nullptr) return false;
    o->ntbl += fix ? DFT_FIX_TABLES : 1;
    if (fix) o->fix[o->nfix++] = a;
  }
  return o->ntbl <= DFT_FOLD_MAX_OPS;
}

// The shared tables of `sr` slots times replicas each, one after another
// on 16-byte boundaries: each op's offset, and the block's bytes (false
// past what a block may hold).
static inline bool fold_layout(FoldArgs* o, long long sr) {
  long long off = 0;
  for (int a = 0; a < o->n; ++a) {
    o->soff[a] = (int)off;
    off += ((long long)dft_slot_bytes(o->kinds[a]) * sr + 15) / 16 * 16;
  }
  o->sr = (int)sr;
  o->smem = (int)off;
  return sr <= 0x7fffffffLL && off <= 232448;
}

// a block's copy of the kernel's FoldArgs; read after the next
// __syncthreads. `rows`: copy vals and masks too (K6 copies them per
// sender). `scale`: each fixed-point float SUM's scale from the word the
// first pass left (the first pass itself reads none).
__device__ __forceinline__ void load_fold_shared(FoldShared& s, const FoldArgs& o, bool rows = true,
                                                 bool scale = true) {
  const int a = threadIdx.x;
  if (a < o.n) {
    s.kind[a] = o.kinds[a];
    s.soff[a] = o.soff[a];
    s.mbit[a] = o.mbit[a];
    if (rows) {
      s.val[a] = o.vals[a];
      s.mask[a] = o.masks[a];
    }
    s.out[a] = o.outs[a];
    s.aux[a] = o.aux[a];
    if (scale && dft_fix_kind(o.kinds[a])) s.sc[a] = fix_scale(*(const unsigned long long*)o.aux[a]);
  }
  if (a < o.nfix) s.fix[a] = o.fix[a];
  if (a == 0) {
    s.stride = o.stride;
    s.sr = o.sr;
    s.id_mod = o.id_mod;
  }
}

static inline bool dft_valid_reps(int reps) { return reps >= 1 && reps <= DFT_MAX_REPS && (reps & (reps - 1)) == 0; }

// Shared is what a block's shared table holds, Acc the device table;
// a shared value goes to the device table through widen(). `of(x)` is
// value x's contribution.
template <class Op, int MM = Op::MM>
struct Zero {  // SUM: the op itself, whose identity is 0
  typedef typename Op::In In;
  typedef typename Op::Acc Acc;
  typedef Acc Shared;
  static __device__ __forceinline__ Shared of(In x) { return Op::of(x); }
  static __device__ __forceinline__ Shared combine(Shared x, Shared y) { return Op::combine(x, y); }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { Op::atomic(p, v); }
  static __device__ __forceinline__ void satomic(Shared* p, Shared v) { dft_shared_add64(p, v); }  // integer SUM
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
  static __device__ __forceinline__ void satomic(Shared* p, Shared v) { atomicAdd(p, v); }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { CountOp::atomic(p, v); }
  static __device__ __forceinline__ Acc widen(Shared v) { return (Acc)v; }
};

// A fixed-point digit's device table: int64 totals, added with
// wrap-around (exact below 2^31 rows a launch).
typedef SumIntOp<long long> FixDigitOp;

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
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) { dft_red_max(p, v); }
  static __device__ __forceinline__ void satomic(Acc* p, Acc v) { atomicMax(p, v); }
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

// One op's rows of a thread's tile: the values as bits (a 4-byte type in
// the low half), and each row's mask (true without one).
struct OpTile {
  unsigned long long x[DFT_TILE];
  bool on[DFT_TILE];
};

template <typename In>
__device__ __forceinline__ In tile_value(const OpTile& t, int k) {
  In v;
  memcpy(&v, &t.x[k], sizeof(In));
  return v;
}

// op a's rows r .. r + c - 1 into t; g holds the rows' ids as read (a
// packed id carries the op's mask bit, s.mbit)
__device__ __forceinline__ void op_load(const FoldShared& s, int a, long long r, int c, const int (&g)[DFT_TILE],
                                        OpTile& t) {
  const int vb = dft_value_bytes(s.kind[a]);
  if (vb == 8) {
    load_tile((const unsigned long long*)s.val[a], r, c, t.x);
  } else if (vb == 4) {
    unsigned int u[DFT_TILE];
    load_tile((const unsigned int*)s.val[a], r, c, u);
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) t.x[k] = u[k];
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) t.x[k] = 0;
  }
  const int bit = s.mbit[a];
  const uint8_t* mask = s.mask[a];
  if (bit >= 0) {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) t.on[k] = (g[k] >> bit) & 1;
  } else if (mask != nullptr) {
    uint8_t m[DFT_TILE];
    load_tile(mask, r, c, m);
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) t.on[k] = m[k];
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) t.on[k] = true;
  }
}

// one op (not a float SUM) over one thread's tile into its shared table
// `tbl`: w[k] is row k's slot, or -1 (dropped)
template <class Op>
__device__ __forceinline__ void tile_fold(unsigned char* tbl, int reps, int rep, const OpTile& t,
                                          const int (&w)[DFT_TILE]) {
  typedef Zero<Op> Z;
  typedef typename Op::In In;
  typedef typename Z::Shared Acc;
  Acc* p = (Acc*)tbl + rep;
  int cur = -1;
  Acc acc = 0;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    if (w[k] < 0 || !t.on[k]) continue;
    const Acc c = Z::of(tile_value<In>(t, k));
    if (w[k] == cur) {
      acc = Z::combine(acc, c);
    } else {
      if (cur >= 0 && acc != (Acc)0) Z::satomic(p + cur * reps, acc);
      cur = w[k];
      acc = c;
    }
  }
  if (cur >= 0 && acc != (Acc)0) Z::satomic(p + cur * reps, acc);
}

// the same op's rows whose slot lies outside the block's table (far[k] >=
// 0: the device table's slot), each by a global atomic
template <class Op>
__device__ __forceinline__ void tile_far(void* out, const OpTile& t, const int (&far)[DFT_TILE]) {
  typedef Zero<Op> Z;
  typedef typename Op::In In;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k)
    if (far[k] >= 0 && t.on[k]) Z::atomic((typename Z::Acc*)out + far[k], Z::widen(Z::of(tile_value<In>(t, k))));
}

__device__ __forceinline__ void word_add(int* p, int v) {
  if (v) atomicAdd(p, v);
}

// A float SUM's exact digit partials d0, d1, d2 into its six words of one
// slot replica (p: word 0; word j lies j * sr ints further)
__device__ __forceinline__ void fix_add(int* p, int sr, long long d0, long long d1, long long d2) {
  word_add(p, (int)(d0 >> 16));
  word_add(p + sr, (int)(d0 & 0xffff));
  word_add(p + 2 * sr, (int)(d1 >> 16));
  word_add(p + 3 * sr, (int)(d1 & 0xffff));
  word_add(p + 4 * sr, (int)(d2 >> 16));
  word_add(p + 5 * sr, (int)(d2 & 0xffff));
}

// A float SUM (op a, values of type In) over one thread's tile: each
// row's three digits and flags computed once, equal neighbouring slots
// combined in registers, the digits into op a's shared words and the
// flags (a non-finite value is rare: no shared table) into its flag table
// from slot `gbase`.
template <typename In>
__device__ __forceinline__ void fix_tile_fold(unsigned char* smem, const FoldShared& s, int a, long long gbase,
                                              int reps, int rep, const OpTile& t, const int (&w)[DFT_TILE]) {
  const FixScale sc = s.sc[a];
  int* p = (int*)(smem + s.soff[a]) + rep;
  const int sr = s.sr;
  unsigned long long* gf = (unsigned long long*)s.out[a] + 3 * s.stride + gbase;
  int cur = -1;
  long long a0 = 0, a1 = 0, a2 = 0;
  unsigned long long af = 0;
#pragma unroll
  for (int k = 0; k <= DFT_TILE; ++k) {
    if (k < DFT_TILE && (w[k] < 0 || !t.on[k])) continue;
    long long d0 = 0, d1 = 0, d2 = 0;
    unsigned long long f = 0;
    if (k < DFT_TILE) {
      const double x = (double)tile_value<In>(t, k);
      fix_digits(x, sc, d0, d1, d2);
      f = fix_flags(x);
      if (w[k] == cur) {
        a0 += d0;
        a1 += d1;
        a2 += d2;
        af |= f;
        continue;
      }
    }
    if (cur >= 0 && (DFT_ABLATE != 1 || (a0 ^ a1 ^ a2) == 0x5a5a5a5a5a5a5a5aLL)) {  // the run of `cur` ends
      fix_add(p + cur * reps, sr, a0, a1, a2);
      if (af) dft_red_or(gf + cur, af);
    }
    if (k < DFT_TILE) {
      cur = w[k];
      a0 = d0;
      a1 = d1;
      a2 = d2;
      af = f;
    }
  }
}

// A float SUM's far rows (far[k] >= 0): each row's digits and flags by
// global atomics into op a's four device tables.
template <typename In>
__device__ __forceinline__ void fix_tile_far(const FoldShared& s, int a, const OpTile& t,
                                             const int (&far)[DFT_TILE]) {
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k)
    if (far[k] >= 0 && t.on[k]) {
      const double x = (double)tile_value<In>(t, k);
      long long d[3];
      fix_digits(x, s.sc[a], d[0], d[1], d[2]);
      unsigned long long* out = (unsigned long long*)s.out[a] + far[k];
      for (int i = 0; i < 3; ++i)
        if (d[i]) dft_red_add(out + i * s.stride, (unsigned long long)d[i]);
      const unsigned long long f = fix_flags(x);
      if (f) dft_red_or(out + 3 * s.stride, f);
    }
}

// op a's loaded tile t: rows with a slot w[k] >= 0 into its shared table,
// rows with far[k] >= 0 into its device table (`any_far`: some row has one)
__device__ __forceinline__ void op_fold(unsigned char* smem, const FoldShared& s, int a, long long gbase, int reps,
                                        int rep, const OpTile& t, const int (&w)[DFT_TILE],
                                        const int (&far)[DFT_TILE], bool any_far) {
  const int kind = s.kind[a];
  if (kind == K_FIX_F32) {
    fix_tile_fold<float>(smem, s, a, gbase, reps, rep, t, w);
    if (any_far) fix_tile_far<float>(s, a, t, far);
  } else if (kind == K_FIX_F64) {
    fix_tile_fold<double>(smem, s, a, gbase, reps, rep, t, w);
    if (any_far) fix_tile_far<double>(s, a, t, far);
  } else {
    DFT_DISPATCH_EXACT(kind, tile_fold, smem + s.soff[a], reps, rep, t, w)
    if (any_far) {
      DFT_DISPATCH_EXACT(kind, tile_far, s.out[a], t, far)
    }
  }
}

// Every op over one thread's tile, rows r .. r + c - 1 with ids g as read:
// w[k] the row's slot in the block's tables or -1, far[k] its slot in the
// device tables or -1 (a float SUM's flags go to its device table from
// slot `gbase`). No value is read where no row has a slot.
__device__ __forceinline__ void fold_tile(unsigned char* smem, int n_ops, const FoldShared& s, long long gbase,
                                          int reps, int rep, long long r, int c, const int (&g)[DFT_TILE],
                                          const int (&w)[DFT_TILE], const int (&far)[DFT_TILE]) {
  bool any = false, any_far = false;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    any |= w[k] >= 0 || far[k] >= 0;
    any_far |= far[k] >= 0;
  }
  if (!any) return;  // no row kept: read no values (K3's gaps)
  for (int a = 0; a < n_ops; ++a) {
    OpTile t;
    op_load(s, a, r, c, g, t);
    op_fold(smem, s, a, gbase, reps, rep, t, w, far, any_far);
  }
}

// `bytes` (a multiple of 16) of shared tables to 0: every op's identity
__device__ __forceinline__ void fold_init(unsigned char* smem, int bytes) {
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) ((uint4*)smem)[i] = zero;
}

// A thread's tile of `cnt` rows from `base`: its ids g as read and slots w
// (-1 for a row past cnt or an id outside [0, slots)); false when the tile
// starts past cnt.
__device__ __forceinline__ bool tile_slots(const int* __restrict__ gid, long long base, long long cnt, long long t,
                                           int slots, long long& r, int& c, int (&g)[DFT_TILE],
                                           int (&w)[DFT_TILE]) {
  const long long rel = t * DFT_TILE_ROWS + (long long)threadIdx.x * DFT_TILE;
  if (rel >= cnt) return false;
  c = cnt - rel < DFT_TILE ? (int)(cnt - rel) : DFT_TILE;
  r = base + rel;
  load_tile(gid, r, c, g);
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) w[k] = k >= c || g[k] < 0 || g[k] >= slots ? -1 : g[k];
  return true;
}

// Every float SUM's shared words whose magnitude passed DFT_FIX_CHECK_LIMIT
// into its device digit tables from slot `base`, and to 0; the block's
// threads between two barriers (no atomic is in flight).
__device__ __forceinline__ void fix_check(unsigned char* smem, int nfix, const FoldShared& s, long long base,
                                          int reps) {
  const int sr = s.sr;
  for (int j = 0; j < nfix; ++j) {
    const int a = s.fix[j];
    int* words = (int*)(smem + s.soff[a]);
    long long* out = (long long*)s.out[a];
    for (int i = threadIdx.x; i < DFT_FIX_WORDS * sr; i += blockDim.x) {
      const int v = words[i];
      if (v > DFT_FIX_CHECK_LIMIT || v < -DFT_FIX_CHECK_LIMIT) {
        const int word = i / sr, slot = (i % sr) / reps;
        dft_red_add((unsigned long long*)out + (word >> 1) * s.stride + base + slot,
                    (unsigned long long)((word & 1) ? (long long)v : (long long)v * 65536));
        words[i] = 0;
      }
    }
  }
}

// A block's step of DFT_TILE_ROWS rows is done: every DFT_FIX_CHECK_ROWS
// rows (`steps` counts them; block-uniform) the float SUMs' words pass
// fix_check. Every thread of the block calls it.
__device__ __forceinline__ void fold_step(unsigned char* smem, const FoldShared& s, int nfix, long long base,
                                          int reps, int& steps) {
  if (nfix == 0 || ++steps < DFT_FIX_CHECK_ROWS / DFT_TILE_ROWS) return;
  steps = 0;
  __syncthreads();
  fix_check(smem, nfix, s, base, reps);
  __syncthreads();
}

// Tiles t_first, t_first + t_step, ... of the `cnt` rows from row `base`
// (DFT_TILE_ROWS rows a tile) into the block's tables (a float SUM's flags
// and checked words into its device tables from slot `gbase`); ids outside
// [0, slots) are dropped. `steps` carries fold_step's count from call to call.
__device__ __forceinline__ void fold_range(unsigned char* smem, int n_ops, int nfix, const FoldShared& s,
                                           const int* __restrict__ gid, long long base, long long cnt,
                                           long long t_first, long long t_step, int slots, int reps,
                                           long long gbase, int& steps) {
  const int rep = threadIdx.x & (reps - 1);  // the lane's replica: reps divides the warp
  const long long tiles = (cnt + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  const int none[DFT_TILE] = {-1, -1, -1, -1};
  for (long long t = t_first; t < tiles; t += t_step) {
    long long r;
    int c, g[DFT_TILE], w[DFT_TILE];
    if (tile_slots(gid, base, cnt, t, slots, r, c, g, w)) fold_tile(smem, n_ops, s, gbase, reps, rep, r, c, g, w, none);
    fold_step(smem, s, nfix, gbase, reps, steps);
  }
}

// one table's touched slots, replicas combined, into its device table from slot `base`
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

// A float SUM's six words of each touched slot, replicas combined, as its
// three digits into its device tables from slot `base`
__device__ __forceinline__ void fix_flush(const int* words, long long* out, long long stride, long long base,
                                          int slots, int reps, int sr) {
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      long long v = 0;
      for (int r = 0; r < reps; ++r)
        v += (long long)words[2 * d * sr + s * reps + r] * 65536 + words[(2 * d + 1) * sr + s * reps + r];
      if (v) dft_red_add((unsigned long long*)out + d * stride + base + s, (unsigned long long)v);
    }
  }
}

// The last block's pass over op a's `n`-slot device table: MIN/MAX into
// the value type; nothing for the others.
template <class Op>
__device__ __forceinline__ void tile_decode(const FoldShared& s, int a, long long n) {
  if constexpr (Op::MM != 0) {
    typedef Zero<Op> Z;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) Z::decode((typename Z::Acc*)s.out[a] + i);
  }
}

// The same for a fixed-point float SUM: its four tables into its f64
// value, in the first.
__device__ __forceinline__ void fix_tile_decode(const FoldShared& s, int a, long long n) {
  const int e = fix_exponent(__ldcg((const unsigned long long*)s.aux[a]));
  long long* t0 = (long long*)s.out[a];
  const long long* t1 = t0 + s.stride;
  const long long* t2 = t0 + 2 * s.stride;
  const unsigned long long* f = (const unsigned long long*)(t0 + 3 * s.stride);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const double v = fix_decode(__ldcg(t0 + i), __ldcg(t1 + i), __ldcg(t2 + i), __ldcg(f + i), e);
    memcpy(t0 + i, &v, 8);
  }
}

// True in the last block of the grid to get here (a ticket on `done`, 0
// before the launch), once every block's writes to the device tables are
// visible to it.
__device__ __forceinline__ bool fold_last(unsigned int* done) {
  __shared__ bool last;
  __threadfence();  // this block's writes reach every block before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block decodes the ops' `n_out`-slot device tables in place
// (either mode's kinds; a sorted-mode float SUM needs nothing).
__device__ __forceinline__ void fold_decode(int n_ops, const FoldShared& s, long long n_out) {
  for (int a = 0; a < n_ops; ++a) {
    if (dft_fix_kind(s.kind[a])) {
      fix_tile_decode(s, a, n_out);
    } else {
      DFT_DISPATCH_EXACT(s.kind[a], tile_decode, s, a, n_out)
    }
  }
}

// Every op's shared tables (`slots` slots of `reps` replicas) into its
// device tables from slot `base`.
__device__ __forceinline__ void fold_flush(unsigned char* smem, int n_ops, const FoldShared& s, long long base,
                                           int slots, int reps) {
  for (int a = 0; a < n_ops && DFT_ABLATE != 2; ++a) {
    unsigned char* tbl = smem + s.soff[a];
    if (dft_fix_kind(s.kind[a])) {  // block-uniform
      fix_flush((const int*)tbl, (long long*)s.out[a], s.stride, base, slots, reps, s.sr);
    } else {
      DFT_DISPATCH_EXACT(s.kind[a], tile_flush, tbl, s.out[a], base, slots, reps)
    }
  }
}

// fold_flush, then the last block decodes the `n_out`-slot device tables.
__device__ __forceinline__ void fold_finish(unsigned char* smem, int n_ops, const FoldShared& s, long long base,
                                            int slots, int reps, long long n_out, unsigned int* done) {
  fold_flush(smem, n_ops, s, base, slots, reps);
  if (fold_last(done)) fold_decode(n_ops, s, n_out);
}

// --- the first pass of a launch with a fixed-point float SUM ----------------
// The largest finite |x| among a float SUM's kept rows of a tile, as its
// bits (which order non-negative doubles); 0 for none.
__device__ __forceinline__ unsigned long long finite_abs_bits(double x) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x) & 0x7fffffffffffffffULL;
  return b < 0x7ff0000000000000ULL ? b : 0ULL;
}

template <typename In>
__device__ __forceinline__ void tile_scale(const void* vals, const uint8_t* mask, long long r, int cnt,
                                           const int (&w)[DFT_TILE], unsigned long long& best) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) any |= w[k] >= 0;
  if (!any) return;
  In x[DFT_TILE];
  load_tile((const In*)vals, r, cnt, x);
  uint8_t m[DFT_TILE];
  if (mask != nullptr) {
    load_tile(mask, r, cnt, m);
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) m[k] = 1;
  }
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    const unsigned long long b = finite_abs_bits((double)x[k]);
    if (w[k] >= 0 && m[k] && b > best) best = b;
  }
}

// every float SUM of the launch over one thread's tile (best[j]: s.fix[j]'s)
__device__ __forceinline__ void tile_scales(const FoldShared& s, int nfix, long long r, int c,
                                            const int (&w)[DFT_TILE], unsigned long long (&best)[DFT_MAX_FIX]) {
#pragma unroll
  for (int j = 0; j < DFT_MAX_FIX; ++j) {
    if (j >= nfix) break;
    const int a = s.fix[j];
    if (s.kind[a] == K_FIX_F32) tile_scale<float>(s.val[a], s.mask[a], r, c, w, best[j]);
    else tile_scale<double>(s.val[a], s.mask[a], r, c, w, best[j]);
  }
}

// the block's largest `best` into *out by one atomic (every thread calls
// it; a block of at most 1024 threads)
__device__ __forceinline__ void block_max_to(unsigned long long best, unsigned long long* out) {
  __shared__ unsigned long long s_best[32];
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, d);
    if (o > best) best = o;
  }
  if ((threadIdx.x & 31) == 0) s_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
      if (s_best[i] > best) best = s_best[i];
    if (best) dft_red_max(out, best);
  }
  __syncthreads();  // s_best is free for the next float SUM
}

// each float SUM's block maximum into its scale word
__device__ __forceinline__ void scale_flush(const FoldShared& s, int nfix, unsigned long long (&best)[DFT_MAX_FIX]) {
#pragma unroll
  for (int j = 0; j < DFT_MAX_FIX; ++j) {
    if (j >= nfix) break;
    block_max_to(best[j], (unsigned long long*)s.aux[s.fix[j]]);
  }
}

// The first pass over the rows [0, n) (K2 dense, K4 without K3's scale
// words): each fixed-point float SUM's largest finite |value| among its
// kept rows (ids in [0, num_groups), mask set) into its scale word by
// atomic max; the grid strides over DFT_TILE_ROWS-row tiles and reads the
// ids once.
static __global__ void __launch_bounds__(DFT_FOLD_TPB)
fold_scale_kernel(const int* __restrict__ gid, long long n, int num_groups, FoldArgs ops) {
  __shared__ FoldShared s;
  load_fold_shared(s, ops, true, false);
  __syncthreads();
  const long long tiles = (n + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  unsigned long long best[DFT_MAX_FIX] = {};
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    long long r;
    int c, g[DFT_TILE], w[DFT_TILE];
    if (tile_slots(gid, 0, n, t, num_groups, r, c, g, w)) tile_scales(s, ops.nfix, r, c, w, best);
  }
  scale_flush(s, ops.nfix, best);
}

static inline bool fold_has_fix(const FoldArgs& o) { return o.nfix > 0; }

// The grid that fills the card: blocks of DFT_FOLD_TPB threads with
// `smem` dynamic bytes each that fit an SM at once, times the SMs
// (launch_fill.cuh). Returns 0 and sets *err when the kernel cannot take
// `smem`.
template <typename K>
static inline long long fold_blocks(K kernel, int smem, cudaError_t* err) {
  return dft_fill_blocks(kernel, DFT_FOLD_TPB, smem, err);
}
