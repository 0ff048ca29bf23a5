// K1 — fused scan -> filter -> project stage for Hopper (sm_90a).
//
// Replaces: datafusion_tpu/ops/pallas/fused_stage.py `run_fused` (Pallas
// kernel body at :76, pallas_call at :85), which traced an arbitrary
// closure of compiled JAX expressions into one TPU kernel. A precompiled
// CUDA kernel cannot trace closures, so this kernel is an interpreter of
// a short linear register program (the design of cuDF's compute_column):
// datafusion_tpu_torch/ops/pallas/fused_stage.py lowers the predicate and
// every computed projection into one Program at plan time, allocates its
// registers by liveness and folds constants into operands, and this
// kernel evaluates that program over tiles of rows.
//
// What bounds it on this card: bytes. Every input column the program
// references is read once and every output (the uint8 selection mask,
// each computed column and its optional validity) is written once, at a
// handful of operations per byte — far below the H100's ~20 FLOP/byte
// ridge for f64. So the only device-memory traffic is that one read and
// one write, and the design keeps the interpreter's own costs off it:
//   * one dispatch per tile, not per row: a block of FS_THREADS threads
//     owns a tile of R x FS_THREADS rows and walks the tiles in a
//     persistent grid; each instruction is decoded once per tile (the
//     program sits in the parameter space, so the dispatch is uniform)
//     and runs a loop over the thread's R rows with no switch inside;
//   * the register file is in shared memory, not local memory: n_regs
//     rows of R x FS_THREADS 8-byte slots, each thread on its own slots
//     (lane-consecutive, so no bank conflicts and no barriers), validity
//     one 32-bit mask per row in the thread's registers; the wrapper
//     picks R so that a block holds about 64 KB;
//   * with R >= 2 a thread owns rows in pairs, so a LOAD is R / 2 vector
//     loads in flight where the column is aligned, coalesced across the
//     warp; the outputs are stored the same way at the end of the tile;
//   * an instruction's second operand may be an immediate constant.
//
// Semantics carried exactly from the JAX package (ops/expr_eval.py):
//   * integer `/` truncates and `%` is the C remainder (lax.div/lax.rem);
//     integer x/0 and x%0 give NULL; INT_MIN / -1 gives INT_MIN, % -1 gives 0
//   * integer results wrap to their logical width after every operation
//   * float arithmetic uses the round-to-nearest intrinsics, so nothing is
//     contracted into an FMA; float division stays IEEE-exact (no fast math)
//   * AND/OR validity is the AND of both validities (no Kleene logic)
//   * a NULL predicate drops the row
//   * the date opcodes are utils/dates.py's functions: int32 arithmetic
//     that wraps (as XLA's and torch's do; done in unsigned here, where
//     signed overflow is undefined) and floor division and modulo, which
//     C's `/` and `%` are not for negative values (OP_DIV / OP_MOD keep
//     SQL's truncation)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_fill.cuh"

#define DFT_MAX_INSTR 64
#define DFT_MAX_REGS 32
#define DFT_MAX_IN 12
#define DFT_MAX_OUT 12
#define DFT_MAX_CONST 32
#define FS_THREADS 256
#define FS_MAX_SMEM 232448  // an H100 block's shared memory

// value types (logical width + signedness); mirrored in fused_stage.py
enum {
  T_BOOL = 0, T_I8, T_I16, T_I32, T_I64, T_U8, T_U16, T_U32, T_F32, T_F64
};

// opcodes; mirrored in fused_stage.py
enum {
  OP_LOAD = 0, OP_CONST, OP_NULL,
  OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD,
  OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
  OP_AND, OP_OR,
  OP_CAST, OP_ISNULL, OP_ISNOTNULL, OP_SELECT, OP_KEEPV,
  OP_MATH1, OP_MATH2,
  OP_DATE, OP_DTRUNC, OP_ADDMONTHS
};

// unary / binary math function ids (OP_MATH1 / OP_MATH2, in `c`)
enum {
  F_SQRT = 0, F_ABS, F_EXP, F_LOG, F_LOG10, F_LOG2, F_SIN, F_COS, F_TAN,
  F_ASIN, F_ACOS, F_ATAN, F_FLOOR, F_CEIL, F_SIGN
};
enum { F_POW = 0, F_FMOD, F_ATAN2, F_ROUND, F_TRUNC };

// OP_DATE's fields (in `c`; the source type, T_I32 days or T_I64 seconds,
// in `b`) and OP_DTRUNC's units (in `c`); mirrored in fused_stage.py
enum {
  D_YEAR = 0, D_MONTH, D_DAY, D_HOUR, D_MINUTE, D_SECOND, D_DOW, D_DOY, D_QUARTER, D_WEEK, D_EPOCH, D_DAYS,
  D_N_FIELDS
};
enum { U_YEAR = 0, U_QUARTER, U_MONTH, U_WEEK, U_DAY, U_HOUR, U_MINUTE, U_SECOND, U_N_UNITS };

// imm: operand b is consts[b], valid on every row, not a register;
// imm_ty is the constant's type, which only the plain version reads
struct Instr {
  uint8_t op, ty, dst, a, b, c, imm, imm_ty;
};

// Laid out with 8-byte members first so the ctypes mirror in
// fused_stage.py has the same layout. Passed by value (kernel params).
struct Program {
  long long consts[DFT_MAX_CONST];
  const void* in_data[DFT_MAX_IN];
  const uint8_t* in_valid[DFT_MAX_IN];
  void* out_data[DFT_MAX_OUT];
  uint8_t* out_valid[DFT_MAX_OUT];
  uint8_t* sel;
  int n_instr, n_in, n_out, sel_reg;
  int in_type[DFT_MAX_IN];
  int out_type[DFT_MAX_OUT];
  int out_reg[DFT_MAX_OUT];
  Instr code[DFT_MAX_INSTR];
};

union Reg {
  double f;
  long long i;
};

__host__ __device__ __forceinline__ bool is_float(int t) { return t == T_F32 || t == T_F64; }

// Wrapping an integer to its logical width (two's complement / modular)
// as one shift pair and a mask, chosen once per instruction.
struct Wrap {
  int sh;         // 64 - width for the signed narrow types, else 0
  long long msk;  // the unsigned types' value mask, else all ones
  bool to_bool;
  __device__ __forceinline__ long long operator()(long long x) const {
    const long long y = ((long long)((unsigned long long)x << sh) >> sh) & msk;
    return to_bool ? (long long)(x != 0) : y;
  }
};

__device__ __forceinline__ Wrap wrap_of(int t) {
  switch (t) {
    case T_BOOL: return {0, -1LL, true};
    case T_I8: return {56, -1LL, false};
    case T_I16: return {48, -1LL, false};
    case T_I32: return {32, -1LL, false};
    case T_U8: return {0, 0xFFLL, false};
    case T_U16: return {0, 0xFFFFLL, false};
    case T_U32: return {0, 0xFFFFFFFFLL, false};
    default: return {0, -1LL, false};
  }
}

__device__ __forceinline__ double sign_of(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);  // lax.sign: keeps +-0, NaN
}

__device__ __forceinline__ double sql_round(double x, double y) {  // half away from zero
  const double m = pow(10.0, y);
  const double v = __dmul_rn(x, m);
  return __ddiv_rn(__dmul_rn(sign_of(v), floor(__dadd_rn(fabs(v), 0.5))), m);
}

__device__ __forceinline__ double sql_trunc(double x, double y) {
  const double m = pow(10.0, y);
  return __ddiv_rn(trunc(__dmul_rn(x, m)), m);
}

// value range of an integer type, for saturating float -> int casts
__device__ __forceinline__ void int_bounds(int t, long long* lo, long long* hi) {
  switch (t) {
    case T_I8: *lo = -128; *hi = 127; break;
    case T_I16: *lo = -32768; *hi = 32767; break;
    case T_I32: *lo = -2147483648LL; *hi = 2147483647LL; break;
    case T_U8: *lo = 0; *hi = 255; break;
    case T_U16: *lo = 0; *hi = 65535; break;
    case T_U32: *lo = 0; *hi = 4294967295LL; break;
    default: *lo = (long long)0x8000000000000000ULL; *hi = 0x7FFFFFFFFFFFFFFFLL; break;
  }
}

// --- the calendar (utils/dates.py), on int32 days and int64 seconds -------

__host__ __device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__host__ __device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__host__ __device__ __forceinline__ int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
// floor division and modulo by a positive constant (jnp.floor_divide, jnp.remainder)
__host__ __device__ __forceinline__ int floor_div(int a, int b) { return a / b - (a % b < 0); }
__host__ __device__ __forceinline__ int floor_mod(int a, int b) { const int r = a % b; return r < 0 ? r + b : r; }
__host__ __device__ __forceinline__ long long floor_div64(long long a, long long b) { return a / b - (a % b < 0); }
__host__ __device__ __forceinline__ long long floor_mod64(long long a, long long b) {
  const long long r = a % b;
  return r < 0 ? r + b : r;
}

// Hinnant's civil_from_days as the JAX package writes it: the era offset
// for negative days and then a floor division
__device__ __forceinline__ void civil_from_days(int days, int& y, int& m, int& d) {
  const int z = wadd(days, 719468);
  const int era = floor_div(z >= 0 ? z : wsub(z, 146096), 146097);
  const int doe = wsub(z, wmul(era, 146097));
  const int yoe = floor_div(wadd(wsub(doe, floor_div(doe, 1460)), wsub(floor_div(doe, 36524), floor_div(doe, 146096))),
                            365);
  const int doy = wsub(doe, wadd(wmul(365, yoe), wsub(floor_div(yoe, 4), floor_div(yoe, 100))));
  const int mp = floor_div(wadd(wmul(5, doy), 2), 153);
  d = wadd(wsub(doy, floor_div(wadd(wmul(153, mp), 2), 5)), 1);
  m = mp < 10 ? wadd(mp, 3) : wsub(mp, 9);
  y = wadd(wadd(yoe, wmul(era, 400)), m <= 2);
}

__device__ __forceinline__ int days_from_civil(int y, int m, int d) {
  y = wsub(y, m <= 2);
  const int era = floor_div(y >= 0 ? y : wsub(y, 399), 400);
  const int yoe = wsub(y, wmul(era, 400));
  const int doy = wsub(wadd(floor_div(wadd(wmul(153, wadd(m, m > 2 ? -3 : 9)), 2), 5), d), 1);
  const int doe = wadd(wadd(wmul(yoe, 365), wsub(floor_div(yoe, 4), floor_div(yoe, 100))), doy);
  return wsub(wadd(wmul(era, 146097), doe), 719468);
}

__device__ __forceinline__ bool is_leap(int y) { return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0; }

// month m's length (m in 1..12): 30 or 31 by its parity, flipped from
// August on; February 28 or 29. No table indexed by data.
__device__ __forceinline__ int days_in_month(int y, int m) {
  return m == 2 ? (is_leap(y) ? 29 : 28) : 30 + ((m + (m >> 3)) & 1);
}

__device__ __forceinline__ int iso_weekday(int days) { return floor_mod(wadd(days, 3), 7) + 1; }  // Monday = 1

__device__ __forceinline__ int weeks_in(int y) {  // 52, or 53 in an ISO long year
  const int wd = iso_weekday(days_from_civil(y, 1, 1));
  return 52 + (wd == 4 || (is_leap(y) && wd == 3));
}

// the day of a Date32 (int32 days) or Timestamp (int64 seconds) value,
// its int32 wrap as the JAX package's astype(int32)
template <bool SECS>
__device__ __forceinline__ int day_of(long long x) {
  return SECS ? (int)(unsigned)(unsigned long long)floor_div64(x, 86400) : (int)x;
}

template <int F, bool SECS>
__device__ __forceinline__ long long date_field(long long x) {
  if (F == D_EPOCH) return SECS ? x : x * 86400;
  if (F == D_HOUR || F == D_MINUTE || F == D_SECOND) {
    const int sod = (int)floor_mod64(x, 86400);
    return F == D_HOUR ? sod / 3600 : F == D_MINUTE ? sod / 60 % 60 : sod % 60;
  }
  const int days = day_of<SECS>(x);
  if (F == D_DAYS) return days;
  if (F == D_DOW) return floor_mod(wadd(days, 4), 7);  // Sunday = 0
  int y, m, d;
  civil_from_days(days, y, m, d);
  if (F == D_YEAR) return y;
  if (F == D_MONTH) return m;
  if (F == D_DAY) return d;
  if (F == D_QUARTER) return floor_div(wsub(m, 1), 3) + 1;
  const int doy = wadd(wsub(days, days_from_civil(y, 1, 1)), 1);
  if (F == D_DOY) return doy;
  const int w = floor_div(wadd(wsub(doy, iso_weekday(days)), 10), 7);  // D_WEEK: ISO 8601
  return w < 1 ? weeks_in(wsub(y, 1)) : (w > weeks_in(y) ? 1 : w);
}

template <int U>
__device__ __forceinline__ int trunc_days(int days) {
  if (U == U_DAY) return days;
  if (U == U_WEEK) return wsub(days, iso_weekday(days) - 1);
  int y, m, d;
  civil_from_days(days, y, m, d);
  return days_from_civil(y, U == U_YEAR ? 1 : U == U_QUARTER ? wadd(wmul(floor_div(wsub(m, 1), 3), 3), 1) : m, 1);
}

template <int U, bool SECS>
__device__ __forceinline__ long long date_trunc(long long x) {
  if (!SECS) return trunc_days<U>((int)x);
  if (U == U_SECOND) return x;
  if (U == U_MINUTE || U == U_HOUR)
    return (long long)((unsigned long long)x - (unsigned long long)floor_mod64(x, U == U_HOUR ? 3600 : 60));
  return (long long)trunc_days<U>(day_of<true>(x)) * 86400;
}

// days (or seconds) plus n calendar months, the day clamped to the
// target month's length, seconds keeping their time of day
template <bool SECS>
__device__ __forceinline__ long long add_months(long long x, int n) {
  int y, m, d;
  civil_from_days(day_of<SECS>(x), y, m, d);
  const int total = wadd(wadd(wmul(y, 12), wsub(m, 1)), n);
  const int y2 = floor_div(total, 12);
  const int m2 = wadd(wsub(total, wmul(y2, 12)), 1);
  const int dim = days_in_month(y2, m2);
  const int d2 = d < dim ? d : dim;
  const int days = days_from_civil(y2, m2, d2);
  return SECS ? (long long)days * 86400 + floor_mod64(x, 86400) : days;
}

// One tile: rows [base, base + R * FS_THREADS) of n. Thread t's slot r of
// register x is file[x * R * FS_THREADS + r * FS_THREADS] (file points at
// the thread's own column). With R >= 2, slots 2q and 2q + 1 hold two
// neighbouring rows, so a column's rows of one warp are one contiguous
// range for each q.
template <int R>
struct Tile {
  Reg* file;
  long long base, n;
  __device__ __forceinline__ Reg* reg(int x) const { return file + x * (R * FS_THREADS); }
  __device__ __forceinline__ long long row(int r) const {
    return R == 1 ? base + threadIdx.x : base + (long long)(r >> 1) * (2 * FS_THREADS) + 2 * threadIdx.x + (r & 1);
  }
  __device__ __forceinline__ bool whole() const { return base + R * FS_THREADS <= n; }
};

template <typename S>
struct alignas(2 * sizeof(S)) Pair {
  S x, y;
};

// The thread's R rows of a column; rows past n read as 0. Pairs by one
// vector load where the tile is whole and the column aligned.
template <int R, typename S>
__device__ __forceinline__ void fetch(const S* __restrict__ p, const Tile<R>& t, S (&v)[R]) {
  if (R > 1 && t.whole() && ((uintptr_t)p & (2 * sizeof(S) - 1)) == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const Pair<S> w = *(const Pair<S>*)(p + t.row(2 * q));
      v[2 * q] = w.x;
      v[2 * q + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = t.row(r);
      v[r] = row < t.n ? p[row] : (S)0;
    }
  }
}

// The thread's R rows into a column; rows past n are not written.
template <int R, typename S>
__device__ __forceinline__ void put(S* __restrict__ p, const Tile<R>& t, const S (&v)[R]) {
  if (R > 1 && t.whole() && ((uintptr_t)p & (2 * sizeof(S) - 1)) == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      Pair<S> w;
      w.x = v[2 * q];
      w.y = v[2 * q + 1];
      *(Pair<S>*)(p + t.row(2 * q)) = w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = t.row(r);
      if (row < t.n) p[row] = v[r];
    }
  }
}

#define FS_ROWS _Pragma("unroll") for (int r = 0; r < R; ++r)

template <int R, typename S>
__device__ __forceinline__ void load_int(const void* p, const Tile<R>& t, Reg* D) {
  S v[R];
  fetch<R>((const S*)p, t, v);
  FS_ROWS D[r * FS_THREADS].i = (long long)v[r];
}

template <int R, typename S>
__device__ __forceinline__ void load_float(const void* p, const Tile<R>& t, Reg* D) {
  S v[R];
  fetch<R>((const S*)p, t, v);
  FS_ROWS D[r * FS_THREADS].f = (double)v[r];
}

template <int R>
__device__ __forceinline__ void load_bool(const void* p, const Tile<R>& t, Reg* D) {
  uint8_t v[R];
  fetch<R>((const uint8_t*)p, t, v);
  FS_ROWS D[r * FS_THREADS].i = v[r] != 0;
}

template <int R, typename S>
__device__ __forceinline__ void store_int(void* p, const Tile<R>& t, const Reg* X) {
  S v[R];
  FS_ROWS v[r] = (S)X[r * FS_THREADS].i;
  put<R>((S*)p, t, v);
}

template <int R>
__device__ __forceinline__ void store_bool(void* p, const Tile<R>& t, const Reg* X) {
  uint8_t v[R];
  FS_ROWS v[r] = X[r * FS_THREADS].i != 0;
  put<R>((uint8_t*)p, t, v);
}

template <int R>
__device__ __forceinline__ void store_f32(void* p, const Tile<R>& t, const Reg* X) {
  float v[R];
  FS_ROWS v[r] = __double2float_rn(X[r * FS_THREADS].f);
  put<R>((float*)p, t, v);
}

template <int R>
__device__ __forceinline__ void store_f64(void* p, const Tile<R>& t, const Reg* X) {
  double v[R];
  FS_ROWS v[r] = X[r * FS_THREADS].f;
  put<R>((double*)p, t, v);
}

// per-row operand access inside one instruction (see run_instr)
#define AR(r) A[(r) * FS_THREADS]
#define BR(r) B[(r) * bstride]
#define CR(r) C[(r) * FS_THREADS]
#define DR(r) D[(r) * FS_THREADS]
#define VA(r) ((valid[r] >> a) & 1u)
#define VB(r) (((valid[r] >> bsh) & 1u) | bimm)
#define SETV(r, v) valid[r] = (valid[r] & ~(1u << d)) | ((unsigned)(v) << d)

#define FS_F64_BIN(E) FS_ROWS { const double x = AR(r).f, y = BR(r).f; DR(r).f = (E); }
#define FS_F32_BIN(E) \
  FS_ROWS { const float x = __double2float_rn(AR(r).f), y = __double2float_rn(BR(r).f); DR(r).f = (double)(E); }
#define FS_INT_BIN(E) \
  FS_ROWS { const unsigned long long x = AR(r).i, y = BR(r).i; DR(r).i = w((long long)(E)); }
#define FS_CMP(OPC, E)                                                             \
  case OPC:                                                                        \
    if (is_float(ty)) {                                                            \
      FS_ROWS { const double x = AR(r).f, y = BR(r).f; DR(r).i = (E); }            \
    } else {                                                                       \
      FS_ROWS { const long long x = AR(r).i, y = BR(r).i; DR(r).i = (E); }         \
    }                                                                              \
    break;
#define FS_MATH1(F, E) \
  case F: { FS_ROWS { const double x = AR(r).f; DR(r).f = (E); } } break;
#define FS_MATH2(F, E) \
  case F: { FS_ROWS { const double x = AR(r).f, y = BR(r).f; DR(r).f = (E); } } break;
// a date opcode's per-row function F<K, SECS>, SECS from the source type
#define FS_DATE(K, F)                                                      \
  case K:                                                                  \
    if (secs) {                                                            \
      FS_ROWS DR(r).i = F<K, true>(AR(r).i);                               \
    } else {                                                               \
      FS_ROWS DR(r).i = F<K, false>(AR(r).i);                              \
    }                                                                      \
    break;

// One instruction over the thread's R rows of the tile: decoded once,
// then one loop per (opcode, type) with no switch inside. A destination
// may be one of the operands' registers: each row reads its operands
// before it writes.
template <int R>
__device__ __forceinline__ void run_instr(const Program& P, const Instr in, const Tile<R>& t, unsigned (&valid)[R],
                                          const Reg* s_const) {
  const int op = in.op, ty = in.ty, d = in.dst, a = in.a, c = in.c;
  Reg* D = t.reg(d);
  const Reg* A = t.reg(a);
  const Reg* C = t.reg(c);
  // operand b: a register, or the immediate consts[b] read by every row
  const Reg* B = in.imm ? s_const + in.b : t.reg(in.b);
  const int bstride = in.imm ? 0 : FS_THREADS;
  const int bsh = in.imm ? 0 : in.b;
  const unsigned bimm = in.imm ? 1u : 0u;
  switch (op) {
    case OP_LOAD: {
      const void* p = P.in_data[a];
      switch (P.in_type[a]) {
        case T_BOOL: load_bool<R>(p, t, D); break;
        case T_I8: load_int<R, int8_t>(p, t, D); break;
        case T_I16: load_int<R, int16_t>(p, t, D); break;
        case T_I32: case T_U16: load_int<R, int32_t>(p, t, D); break;
        case T_I64: case T_U32: load_int<R, long long>(p, t, D); break;
        case T_U8: load_int<R, uint8_t>(p, t, D); break;
        case T_F32: load_float<R, float>(p, t, D); break;
        default: load_float<R, double>(p, t, D); break;
      }
      const uint8_t* vp = P.in_valid[a];
      if (vp) {
        uint8_t v[R];
        fetch<R>(vp, t, v);
        FS_ROWS SETV(r, v[r] != 0);
      } else {
        FS_ROWS SETV(r, 1u);
      }
      break;
    }
    case OP_CONST: {
      const long long k = s_const[a].i;
      FS_ROWS { DR(r).i = k; SETV(r, 1u); }
      break;
    }
    case OP_NULL: {
      FS_ROWS { DR(r).i = 0; SETV(r, 0u); }
      break;
    }
    case OP_ADD: case OP_SUB: case OP_MUL: {
      if (ty == T_F64) {
        if (op == OP_ADD) {
          FS_F64_BIN(__dadd_rn(x, y))
        } else if (op == OP_SUB) {
          FS_F64_BIN(__dsub_rn(x, y))
        } else {
          FS_F64_BIN(__dmul_rn(x, y))
        }
      } else if (ty == T_F32) {
        if (op == OP_ADD) {
          FS_F32_BIN(__fadd_rn(x, y))
        } else if (op == OP_SUB) {
          FS_F32_BIN(__fsub_rn(x, y))
        } else {
          FS_F32_BIN(__fmul_rn(x, y))
        }
      } else {
        const Wrap w = wrap_of(ty);
        if (op == OP_ADD) {
          FS_INT_BIN(x + y)
        } else if (op == OP_SUB) {
          FS_INT_BIN(x - y)
        } else {
          FS_INT_BIN(x * y)
        }
      }
      FS_ROWS SETV(r, VA(r) & VB(r));
      break;
    }
    case OP_DIV: case OP_MOD: {
      if (ty == T_F64) {
        if (op == OP_DIV) {
          FS_F64_BIN(__ddiv_rn(x, y))
        } else {
          FS_F64_BIN(fmod(x, y))
        }
        FS_ROWS SETV(r, VA(r) & VB(r));
      } else if (ty == T_F32) {
        if (op == OP_DIV) {
          FS_F32_BIN(__fdiv_rn(x, y))
        } else {
          FS_F32_BIN(fmodf(x, y))
        }
        FS_ROWS SETV(r, VA(r) & VB(r));
      } else {
        const Wrap w = wrap_of(ty);
        const bool div = op == OP_DIV;
        FS_ROWS {
          const long long x = AR(r).i, y = BR(r).i;
          unsigned vd = VA(r) & VB(r);
          long long o;
          if (y == 0) {  // NULL on a zero divisor (divide by 1 underneath)
            vd = 0u;
            o = div ? x : 0;
          } else if (y == -1) {  // no INT_MIN / -1 overflow trap
            o = div ? w((long long)(0ULL - (unsigned long long)x)) : 0;
          } else {
            o = w(div ? x / y : x % y);
          }
          DR(r).i = o;
          SETV(r, vd);
        }
      }
      break;
    }
    case OP_EQ: case OP_NE: case OP_LT: case OP_LE: case OP_GT: case OP_GE:
      switch (op) {
        FS_CMP(OP_EQ, x == y)
        FS_CMP(OP_NE, x != y)
        FS_CMP(OP_LT, x < y)
        FS_CMP(OP_LE, x <= y)
        FS_CMP(OP_GT, x > y)
        FS_CMP(OP_GE, x >= y)
      }
      FS_ROWS SETV(r, VA(r) & VB(r));
      break;
    case OP_AND: {
      FS_ROWS { DR(r).i = (AR(r).i != 0) && (BR(r).i != 0); SETV(r, VA(r) & VB(r)); }
      break;
    }
    case OP_OR: {
      FS_ROWS { DR(r).i = (AR(r).i != 0) || (BR(r).i != 0); SETV(r, VA(r) & VB(r)); }
      break;
    }
    case OP_CAST: {  // from type c to type ty
      // float -> integer truncates and saturates at the target's range, NaN
      // giving 0 (XLA's conversion); integer -> integer wraps
      if (ty == T_F32) {
        if (is_float(c)) {
          FS_ROWS DR(r).f = (double)__double2float_rn(AR(r).f);
        } else {
          FS_ROWS DR(r).f = (double)__ll2float_rn(AR(r).i);
        }
      } else if (ty == T_F64) {
        if (is_float(c)) {
          FS_ROWS DR(r) = AR(r);
        } else {
          FS_ROWS DR(r).f = (double)AR(r).i;
        }
      } else if (ty == T_BOOL) {
        if (is_float(c)) {
          FS_ROWS DR(r).i = AR(r).f != 0.0;
        } else {
          FS_ROWS DR(r).i = AR(r).i != 0;
        }
      } else if (is_float(c)) {
        long long lo, hi;
        int_bounds(ty, &lo, &hi);
        const double flo = (double)lo, fhi = (double)hi;
        FS_ROWS {
          const double x = AR(r).f;
          DR(r).i = x != x ? 0 : (x >= fhi ? hi : (x <= flo ? lo : __double2ll_rz(x)));
        }
      } else {
        const Wrap w = wrap_of(ty);
        FS_ROWS DR(r).i = w(AR(r).i);
      }
      FS_ROWS SETV(r, VA(r));
      break;
    }
    case OP_ISNULL: {
      FS_ROWS { DR(r).i = !VA(r); SETV(r, 1u); }
      break;
    }
    case OP_ISNOTNULL: {
      FS_ROWS { DR(r).i = VA(r); SETV(r, 1u); }
      break;
    }
    case OP_SELECT: {  // CASE arm: a = condition, b = then, c = else
      FS_ROWS {
        const bool take = (AR(r).i != 0) && VA(r);
        const Reg o = take ? BR(r) : CR(r);
        const unsigned vd = take ? VB(r) : ((valid[r] >> c) & 1u);
        DR(r) = o;
        SETV(r, vd);
      }
      break;
    }
    case OP_KEEPV: {  // value of a, validity of b
      FS_ROWS { const unsigned vd = VB(r); DR(r) = AR(r); SETV(r, vd); }
      break;
    }
    case OP_MATH1:
      switch (c) {
        FS_MATH1(F_SQRT, sqrt(x))
        FS_MATH1(F_ABS, fabs(x))
        FS_MATH1(F_EXP, exp(x))
        FS_MATH1(F_LOG, log(x))
        FS_MATH1(F_LOG10, log10(x))
        FS_MATH1(F_LOG2, log2(x))
        FS_MATH1(F_SIN, sin(x))
        FS_MATH1(F_COS, cos(x))
        FS_MATH1(F_TAN, tan(x))
        FS_MATH1(F_ASIN, asin(x))
        FS_MATH1(F_ACOS, acos(x))
        FS_MATH1(F_ATAN, atan(x))
        FS_MATH1(F_FLOOR, floor(x))
        FS_MATH1(F_CEIL, ceil(x))
        default: { FS_ROWS { const double x = AR(r).f; DR(r).f = sign_of(x); } } break;
      }
      FS_ROWS SETV(r, VA(r));
      break;
    case OP_MATH2:
      switch (c) {
        FS_MATH2(F_POW, pow(x, y))
        FS_MATH2(F_FMOD, fmod(x, y))
        FS_MATH2(F_ATAN2, atan2(x, y))
        FS_MATH2(F_ROUND, sql_round(x, y))
        default: { FS_ROWS { const double x = AR(r).f, y = BR(r).f; DR(r).f = sql_trunc(x, y); } } break;
      }
      FS_ROWS SETV(r, VA(r) & VB(r));
      break;
    case OP_DATE: {  // field c of a Date32 (b == T_I32) or Timestamp (b == T_I64)
      const bool secs = in.b == T_I64;
      switch (c) {
        FS_DATE(D_YEAR, date_field)
        FS_DATE(D_MONTH, date_field)
        FS_DATE(D_DAY, date_field)
        FS_DATE(D_HOUR, date_field)
        FS_DATE(D_MINUTE, date_field)
        FS_DATE(D_SECOND, date_field)
        FS_DATE(D_DOW, date_field)
        FS_DATE(D_DOY, date_field)
        FS_DATE(D_QUARTER, date_field)
        FS_DATE(D_WEEK, date_field)
        FS_DATE(D_EPOCH, date_field)
        FS_DATE(D_DAYS, date_field)
      }
      FS_ROWS SETV(r, VA(r));
      break;
    }
    case OP_DTRUNC: {  // DATE_TRUNC to unit c, keeping the type ty
      const bool secs = ty == T_I64;
      switch (c) {
        FS_DATE(U_YEAR, date_trunc)
        FS_DATE(U_QUARTER, date_trunc)
        FS_DATE(U_MONTH, date_trunc)
        FS_DATE(U_WEEK, date_trunc)
        FS_DATE(U_DAY, date_trunc)
        FS_DATE(U_HOUR, date_trunc)
        FS_DATE(U_MINUTE, date_trunc)
        FS_DATE(U_SECOND, date_trunc)
      }
      FS_ROWS SETV(r, VA(r));
      break;
    }
    case OP_ADDMONTHS: {  // a + b calendar months, b an int32
      if (ty == T_I64) {
        FS_ROWS DR(r).i = add_months<true>(AR(r).i, (int)(unsigned)(unsigned long long)BR(r).i);
      } else {
        FS_ROWS DR(r).i = add_months<false>(AR(r).i, (int)(unsigned)(unsigned long long)BR(r).i);
      }
      FS_ROWS SETV(r, VA(r) & VB(r));
      break;
    }
    default:
      break;
  }
}

template <int R>
__global__ void __launch_bounds__(FS_THREADS) fused_stage_kernel(const __grid_constant__ Program P, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Reg s_const[DFT_MAX_CONST];
  if (threadIdx.x < DFT_MAX_CONST) s_const[threadIdx.x].i = P.consts[threadIdx.x];
  __syncthreads();
  Tile<R> t;
  t.file = (Reg*)smem + threadIdx.x;
  t.n = n;
  const long long step = (long long)gridDim.x * (R * FS_THREADS);
  for (t.base = (long long)blockIdx.x * (R * FS_THREADS); t.base < n; t.base += step) {
    unsigned valid[R];
    FS_ROWS valid[r] = 0xFFFFFFFFu;
    for (int pc = 0; pc < P.n_instr; ++pc) run_instr<R>(P, P.code[pc], t, valid, s_const);
    if (P.sel_reg >= 0) {  // a NULL predicate drops the row
      const int s = P.sel_reg;
      const Reg* X = t.reg(s);
      uint8_t v[R];
      FS_ROWS v[r] = (X[r * FS_THREADS].i != 0) && ((valid[r] >> s) & 1u);
      put<R>(P.sel, t, v);
    }
    for (int o = 0; o < P.n_out; ++o) {
      const int reg = P.out_reg[o];
      const Reg* X = t.reg(reg);
      void* p = P.out_data[o];
      switch (P.out_type[o]) {
        case T_BOOL: store_bool<R>(p, t, X); break;
        case T_I8: store_int<R, int8_t>(p, t, X); break;
        case T_I16: store_int<R, int16_t>(p, t, X); break;
        case T_I32: case T_U16: store_int<R, int32_t>(p, t, X); break;
        case T_I64: case T_U32: store_int<R, long long>(p, t, X); break;
        case T_U8: store_int<R, uint8_t>(p, t, X); break;
        case T_F32: store_f32<R>(p, t, X); break;
        default: store_f64<R>(p, t, X); break;
      }
      if (P.out_valid[o]) {
        uint8_t v[R];
        FS_ROWS v[r] = (valid[r] >> reg) & 1u;
        put<R>(P.out_valid[o], t, v);
      }
    }
  }
}

template <int R>
static int fs_launch(const Program* p, long long n, int n_regs, cudaStream_t stream) {
  const int smem = n_regs * R * FS_THREADS * (int)sizeof(Reg);
  if (smem > FS_MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = fused_stage_kernel<R>;
  cudaError_t err;
  long long blocks = dft_fill_blocks(kernel, FS_THREADS, smem, &err);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + R * FS_THREADS - 1) / (R * FS_THREADS);
  if (blocks > tiles) blocks = tiles;
  kernel<<<(unsigned int)blocks, FS_THREADS, smem, stream>>>(*p, n);
  return (int)cudaGetLastError();
}

// Does every register, input, constant and output the program names lie
// inside the capacities and the n_regs-register file?
static bool fs_valid(const Program* p, int n_regs) {
  if (p->n_instr < 0 || p->n_instr > DFT_MAX_INSTR || p->n_in < 0 || p->n_in > DFT_MAX_IN || p->n_out < 0 ||
      p->n_out > DFT_MAX_OUT || p->sel_reg >= n_regs)
    return false;
  for (int i = 0; i < p->n_instr; ++i) {
    const Instr& in = p->code[i];
    if (in.dst >= n_regs || in.op > OP_ADDMONTHS) return false;
    const bool reads_a = in.op >= OP_ADD, reads_b = (in.op >= OP_ADD && in.op <= OP_OR) || in.op == OP_SELECT ||
                         in.op == OP_KEEPV || in.op == OP_MATH2 || in.op == OP_ADDMONTHS;
    const bool dated = in.op == OP_DATE ? (in.b == T_I32 || in.b == T_I64) && in.c < D_N_FIELDS
                                        : (in.ty == T_I32 || in.ty == T_I64) && (in.op != OP_DTRUNC || in.c < U_N_UNITS);
    if (in.op >= OP_DATE && !dated) return false;
    if (in.op == OP_LOAD ? in.a >= p->n_in : in.op == OP_CONST ? in.a >= DFT_MAX_CONST : reads_a && in.a >= n_regs)
      return false;
    if (reads_b && in.b >= (in.imm ? DFT_MAX_CONST : n_regs)) return false;
    if (in.op == OP_SELECT && in.c >= n_regs) return false;
  }
  for (int o = 0; o < p->n_out; ++o)
    if (p->out_reg[o] < 0 || p->out_reg[o] >= n_regs) return false;
  return true;
}

// K1. p: the program with this call's pointers; n_regs: the registers
// its code names (1-32); rows: rows per thread of a tile (1, 2, 4 or 8;
// the wrapper's tile_rows), so a block holds n_regs * rows * 2 KB of
// shared memory.
extern "C" int dft_fused_stage(const Program* p, long long n, int n_regs, int rows, void* stream) {
  if (n <= 0) return 0;
  if (n_regs < 1 || n_regs > DFT_MAX_REGS || !fs_valid(p, n_regs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: return fs_launch<1>(p, n, n_regs, s);
    case 2: return fs_launch<2>(p, n, n_regs, s);
    case 4: return fs_launch<4>(p, n, n_regs, s);
    case 8: return fs_launch<8>(p, n, n_regs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dft_fused_stage_program_size() { return (int)sizeof(Program); }
