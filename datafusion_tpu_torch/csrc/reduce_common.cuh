// Reduction op traits shared by K2 (segreduce.cu), K4 (partition.cu) and
// K6 (ragged_shuffle.cu): the op kinds, the order-preserving integer image
// of floats, the per-op identity / contribution / combine / atomic, and
// the shared-memory windows of K4 and K6.
//
// SUM accumulates in f64 for float values and in i64 for integers, COUNT
// is i64, and MIN/MAX keep the value type: f32/f64 reduce on their
// order-preserving integer image (NaN past +inf). `atomic` works on a
// shared or a global address: f64 atomicAdd is native, and 64-bit
// MIN/MAX use atomicMin/atomicMax on the signed image.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename InT, typename AccT>
struct SumOp {
  typedef InT In;
  typedef AccT Acc;
  static __device__ __forceinline__ Acc identity() { return (Acc)0; }
  static __device__ __forceinline__ Acc contrib(const In* v, long long r) { return (Acc)v[r]; }
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
  static __device__ __forceinline__ Acc identity() { return 0; }
  static __device__ __forceinline__ Acc contrib(const In*, long long) { return 1; }
  static __device__ __forceinline__ Acc combine(Acc x, Acc y) { return x + y; }
  static __device__ __forceinline__ void atomic(long long* p, long long v) {
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  }
};
template <typename InT, typename AccT, bool IS_MIN>
struct MinMaxOp {
  typedef InT In;
  typedef AccT Acc;
  static __device__ __forceinline__ Acc identity();
  static __device__ __forceinline__ Acc contrib(const In* v, long long r);
  static __device__ __forceinline__ Acc combine(Acc x, Acc y) {
    return IS_MIN ? (y < x ? y : x) : (y > x ? y : x);
  }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) {
    if (IS_MIN) atomicMin(p, v); else atomicMax(p, v);
  }
};
#define MINMAX_IDENTITY(InT, AccT, LO, HI)                                             \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, true>::identity() { return HI; }  \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, false>::identity() { return LO; }
MINMAX_IDENTITY(float, int, (int)0x80000000, 0x7FFFFFFF)
MINMAX_IDENTITY(double, long long, (long long)0x8000000000000000LL, 0x7FFFFFFFFFFFFFFFLL)
MINMAX_IDENTITY(int, int, (int)0x80000000, 0x7FFFFFFF)
MINMAX_IDENTITY(long long, long long, (long long)0x8000000000000000LL, 0x7FFFFFFFFFFFFFFFLL)
#define MINMAX_CONTRIB(InT, AccT, EXPR)                                                          \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, true>::contrib(const InT* v, long long r) { return EXPR; }  \
  template <> __device__ __forceinline__ AccT MinMaxOp<InT, AccT, false>::contrib(const InT* v, long long r) { return EXPR; }
MINMAX_CONTRIB(float, int, img32(v[r]))
MINMAX_CONTRIB(double, long long, img64(v[r]))
MINMAX_CONTRIB(int, int, v[r])
MINMAX_CONTRIB(long long, long long, v[r])

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

// --- shared-memory windows (K4, K6) -------------------------------------
// One DFT_WINDOW-slot window per op, WIN_BYTES each (8-byte slots), in a
// block's dynamic shared memory: at most DFT_MAX_OPS of them fit the
// 227 KB a Hopper block may hold.
#define DFT_WINDOW 2048
#define WIN_BYTES (DFT_WINDOW * 8)
#define DFT_MAX_OPS 14

template <class Op>
__device__ __forceinline__ void win_init(unsigned char* win) {
  typedef typename Op::Acc Acc;
  for (int i = threadIdx.x; i < DFT_WINDOW; i += blockDim.x) ((Acc*)win)[i] = Op::identity();
}

// every touched slot of the window into the device table, and back to identity
template <class Op>
__device__ __forceinline__ void win_flush(unsigned char* win, void* out, int base) {
  typedef typename Op::Acc Acc;
  for (int i = threadIdx.x; i < DFT_WINDOW; i += blockDim.x) {
    const Acc v = ((Acc*)win)[i];
    if (v != Op::identity()) {
      Op::atomic((Acc*)out + base + i, v);
      ((Acc*)win)[i] = Op::identity();
    }
  }
}

// row r (slot g of the table, `local` of the window) into the window, or
// straight into the table when it lies outside the window
template <class Op>
__device__ __forceinline__ void win_add(unsigned char* win, void* out, const void* vals, const uint8_t* mask,
                                        long long r, int g, int local) {
  typedef typename Op::Acc Acc;
  if (mask != nullptr && !mask[r]) return;
  const Acc c = Op::contrib((const typename Op::In*)vals, r);
  if (local < DFT_WINDOW) Op::atomic((Acc*)win + local, c);
  else Op::atomic((Acc*)out + g, c);
}
