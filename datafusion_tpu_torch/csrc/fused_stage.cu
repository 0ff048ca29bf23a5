// K1 — fused scan -> filter -> project stage for Hopper (sm_90a).
//
// Replaces: datafusion_tpu/ops/pallas/fused_stage.py `run_fused` (Pallas
// kernel body at :76, pallas_call at :85), which traced an arbitrary
// closure of compiled JAX expressions into one TPU kernel. A precompiled
// CUDA kernel cannot trace closures, so this kernel is an interpreter of
// a short linear register program (the design of cuDF's compute_column):
// datafusion_tpu_torch/ops/pallas/fused_stage.py lowers the predicate and
// every computed projection into one Program at plan time, and each
// thread evaluates that program for its rows.
//
// What bounds it on this card: bytes. Every input column the program
// references is read once and every output (the uint8 selection mask,
// each computed column and its optional validity) is written once, at a
// handful of operations per byte — far below the H100's ~20 FLOP/byte
// ridge for f64. The design therefore keeps every intermediate in the
// thread's register file (8-byte slots plus one validity bit each): the
// only device-memory traffic is the one read of each input and the one
// write of each output, with neighbouring threads on neighbouring rows so
// loads and stores coalesce. The program itself sits in the kernel
// parameter space (constant bank), so the interpreter's dispatch is
// uniform across a warp and does not diverge.
//
// Semantics carried exactly from the JAX package (ops/expr_eval.py):
//   * integer `/` truncates and `%` is the C remainder (lax.div/lax.rem);
//     integer x/0 and x%0 give NULL; INT_MIN / -1 gives INT_MIN, % -1 gives 0
//   * integer results wrap to their logical width after every operation
//   * float arithmetic uses the round-to-nearest intrinsics, so nothing is
//     contracted into an FMA; float division stays IEEE-exact (no fast math)
//   * AND/OR validity is the AND of both validities (no Kleene logic)
//   * a NULL predicate drops the row

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DFT_MAX_INSTR 64
#define DFT_MAX_REGS 32
#define DFT_MAX_IN 12
#define DFT_MAX_OUT 12
#define DFT_MAX_CONST 32

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
  OP_MATH1, OP_MATH2
};

// unary / binary math function ids (OP_MATH1 / OP_MATH2, in `c`)
enum {
  F_SQRT = 0, F_ABS, F_EXP, F_LOG, F_LOG10, F_LOG2, F_SIN, F_COS, F_TAN,
  F_ASIN, F_ACOS, F_ATAN, F_FLOOR, F_CEIL, F_SIGN
};
enum { F_POW = 0, F_FMOD, F_ATAN2, F_ROUND, F_TRUNC };

struct Instr {
  uint8_t op, ty, dst, a, b, c, pad0, pad1;
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

__device__ __forceinline__ bool is_float(int t) { return t == T_F32 || t == T_F64; }

// wrap an integer to its logical width (two's complement / modular)
__device__ __forceinline__ long long wrap(long long x, int t) {
  switch (t) {
    case T_BOOL: return x != 0;
    case T_I8: return (long long)(int8_t)x;
    case T_I16: return (long long)(int16_t)x;
    case T_I32: return (long long)(int32_t)x;
    case T_U8: return x & 0xFFLL;
    case T_U16: return x & 0xFFFFLL;
    case T_U32: return x & 0xFFFFFFFFLL;
    default: return x;
  }
}

__device__ __forceinline__ Reg load(const void* p, int t, long long row) {
  Reg r;
  switch (t) {
    case T_BOOL: r.i = ((const uint8_t*)p)[row] != 0; break;
    case T_I8: r.i = ((const int8_t*)p)[row]; break;
    case T_I16: r.i = ((const int16_t*)p)[row]; break;
    case T_I32: case T_U16: r.i = ((const int32_t*)p)[row]; break;
    case T_I64: case T_U32: r.i = ((const long long*)p)[row]; break;
    case T_U8: r.i = ((const uint8_t*)p)[row]; break;
    case T_F32: r.f = (double)((const float*)p)[row]; break;
    default: r.f = ((const double*)p)[row]; break;
  }
  return r;
}

__device__ __forceinline__ void store(void* p, int t, long long row, Reg r) {
  switch (t) {
    case T_BOOL: ((uint8_t*)p)[row] = r.i != 0; break;
    case T_I8: ((int8_t*)p)[row] = (int8_t)r.i; break;
    case T_I16: ((int16_t*)p)[row] = (int16_t)r.i; break;
    case T_I32: case T_U16: ((int32_t*)p)[row] = (int32_t)r.i; break;
    case T_I64: case T_U32: ((long long*)p)[row] = r.i; break;
    case T_U8: ((uint8_t*)p)[row] = (uint8_t)r.i; break;
    case T_F32: ((float*)p)[row] = __double2float_rn(r.f); break;
    default: ((double*)p)[row] = r.f; break;
  }
}

__device__ __forceinline__ double farith(int op, int t, double x, double y) {
  if (t == T_F32) {
    float a = __double2float_rn(x), b = __double2float_rn(y);
    switch (op) {
      case OP_ADD: return (double)__fadd_rn(a, b);
      case OP_SUB: return (double)__fsub_rn(a, b);
      case OP_MUL: return (double)__fmul_rn(a, b);
      case OP_DIV: return (double)__fdiv_rn(a, b);
      default: return (double)fmodf(a, b);
    }
  }
  switch (op) {
    case OP_ADD: return __dadd_rn(x, y);
    case OP_SUB: return __dsub_rn(x, y);
    case OP_MUL: return __dmul_rn(x, y);
    case OP_DIV: return __ddiv_rn(x, y);
    default: return fmod(x, y);
  }
}

__device__ __forceinline__ double sign_of(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);  // lax.sign: keeps +-0, NaN
}

__device__ double math1(int f, double x) {
  switch (f) {
    case F_SQRT: return sqrt(x);
    case F_ABS: return fabs(x);
    case F_EXP: return exp(x);
    case F_LOG: return log(x);
    case F_LOG10: return log10(x);
    case F_LOG2: return log2(x);
    case F_SIN: return sin(x);
    case F_COS: return cos(x);
    case F_TAN: return tan(x);
    case F_ASIN: return asin(x);
    case F_ACOS: return acos(x);
    case F_ATAN: return atan(x);
    case F_FLOOR: return floor(x);
    case F_CEIL: return ceil(x);
    default: return sign_of(x);
  }
}

__device__ double math2(int f, double x, double y) {
  switch (f) {
    case F_POW: return pow(x, y);
    case F_FMOD: return fmod(x, y);
    case F_ATAN2: return atan2(x, y);
    case F_ROUND: {  // SQL ROUND: half away from zero
      double m = pow(10.0, y);
      double v = __dmul_rn(x, m);
      return __ddiv_rn(__dmul_rn(sign_of(v), floor(__dadd_rn(fabs(v), 0.5))), m);
    }
    default: {
      double m = pow(10.0, y);
      return __ddiv_rn(trunc(__dmul_rn(x, m)), m);
    }
  }
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

// CAST between value types: `from` is the source type (in `c`). Float ->
// integer truncates and saturates at the target's range, NaN giving 0
// (XLA's conversion); integer -> integer wraps to the target width.
__device__ __forceinline__ Reg cast(Reg v, int from, int to) {
  Reg r;
  if (is_float(to)) {
    double d = is_float(from) ? v.f : (double)v.i;
    if (to == T_F32) {
      float f = is_float(from) ? __double2float_rn(v.f) : __ll2float_rn(v.i);
      d = (double)f;
    }
    r.f = d;
  } else if (to == T_BOOL) {
    r.i = is_float(from) ? (v.f != 0.0) : (v.i != 0);
  } else if (is_float(from)) {
    long long lo, hi;
    int_bounds(to, &lo, &hi);
    const double x = v.f;
    r.i = x != x ? 0 : (x >= (double)hi ? hi : (x <= (double)lo ? lo : __double2ll_rz(x)));
  } else {
    r.i = wrap(v.i, to);
  }
  return r;
}

__global__ void fused_stage_kernel(const Program P, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += stride) {
    Reg r[DFT_MAX_REGS];
    unsigned int valid = 0xFFFFFFFFu;
    for (int pc = 0; pc < P.n_instr; ++pc) {
      const Instr in = P.code[pc];
      const int d = in.dst, a = in.a, b = in.b, t = in.ty;
      const unsigned int va = (valid >> a) & 1u, vb = (valid >> b) & 1u;
      unsigned int vd = 1u;
      Reg out;
      out.i = 0;
      switch (in.op) {
        case OP_LOAD: {
          out = load(P.in_data[a], P.in_type[a], row);
          const uint8_t* vp = P.in_valid[a];
          vd = vp ? (vp[row] != 0) : 1u;
          break;
        }
        case OP_CONST: out.i = P.consts[a]; break;
        case OP_NULL: vd = 0u; break;
        case OP_ADD: case OP_SUB: case OP_MUL:
          if (is_float(t)) {
            out.f = farith(in.op, t, r[a].f, r[b].f);
          } else {
            unsigned long long x = (unsigned long long)r[a].i;
            unsigned long long y = (unsigned long long)r[b].i;
            unsigned long long z = in.op == OP_ADD ? x + y : (in.op == OP_SUB ? x - y : x * y);
            out.i = wrap((long long)z, t);
          }
          vd = va & vb;
          break;
        case OP_DIV: case OP_MOD:
          vd = va & vb;
          if (is_float(t)) {
            out.f = farith(in.op, t, r[a].f, r[b].f);
          } else {
            long long x = r[a].i, y = r[b].i;
            if (y == 0) {  // NULL on a zero divisor (divide by 1 underneath)
              vd = 0u;
              out.i = in.op == OP_DIV ? x : 0;
            } else if (y == -1) {  // no INT_MIN / -1 overflow trap
              out.i = in.op == OP_DIV ? wrap((long long)(0ULL - (unsigned long long)x), t) : 0;
            } else {
              out.i = wrap(in.op == OP_DIV ? x / y : x % y, t);
            }
          }
          break;
        case OP_EQ: case OP_NE: case OP_LT: case OP_LE: case OP_GT: case OP_GE: {
          bool res;
          if (is_float(t)) {
            double x = r[a].f, y = r[b].f;
            res = in.op == OP_EQ ? x == y : in.op == OP_NE ? x != y : in.op == OP_LT ? x < y
                : in.op == OP_LE ? x <= y : in.op == OP_GT ? x > y : x >= y;
          } else {
            long long x = r[a].i, y = r[b].i;
            res = in.op == OP_EQ ? x == y : in.op == OP_NE ? x != y : in.op == OP_LT ? x < y
                : in.op == OP_LE ? x <= y : in.op == OP_GT ? x > y : x >= y;
          }
          out.i = res;
          vd = va & vb;
          break;
        }
        case OP_AND: out.i = (r[a].i != 0) && (r[b].i != 0); vd = va & vb; break;
        case OP_OR: out.i = (r[a].i != 0) || (r[b].i != 0); vd = va & vb; break;
        case OP_CAST: out = cast(r[a], in.c, t); vd = va; break;
        case OP_ISNULL: out.i = !va; break;
        case OP_ISNOTNULL: out.i = va; break;
        case OP_SELECT: {  // CASE arm: a = condition, b = then, c = else
          const bool take = (r[a].i != 0) && va;
          out = take ? r[b] : r[in.c];
          vd = take ? vb : ((valid >> in.c) & 1u);
          break;
        }
        case OP_KEEPV: out = r[a]; vd = vb; break;  // value of a, validity of b
        case OP_MATH1: out.f = math1(in.c, r[a].f); vd = va; break;
        case OP_MATH2: out.f = math2(in.c, r[a].f, r[b].f); vd = va & vb; break;
        default: break;
      }
      r[d] = out;
      valid = (valid & ~(1u << d)) | (vd << d);
    }
    if (P.sel_reg >= 0) {
      const int s = P.sel_reg;
      P.sel[row] = (r[s].i != 0) && ((valid >> s) & 1u);  // NULL predicate drops
    }
    for (int o = 0; o < P.n_out; ++o) {
      const int reg = P.out_reg[o];
      store(P.out_data[o], P.out_type[o], row, r[reg]);
      if (P.out_valid[o]) P.out_valid[o][row] = (valid >> reg) & 1u;
    }
  }
}

extern "C" int dft_fused_stage(const Program* p, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  fused_stage_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(*p, n);
  return (int)cudaGetLastError();
}

extern "C" int dft_fused_stage_program_size() { return (int)sizeof(Program); }
