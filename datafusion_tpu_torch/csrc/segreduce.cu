// K2 — segmented reduce (per-group SUM / COUNT / MIN / MAX) for Hopper
// (sm_90a), in two modes.
//
// Replaces: datafusion_tpu/ops/pallas/segreduce.py
// `segmented_reduce_sorted` (:524) -> `_segmented_reduce_sorted` (:563),
// kernel `_kernel` (:112), pallas_call at :672. The TPU kernel walked the
// rows in one sequential grid with every accumulator table resident in
// VMEM and summed in f32 — the f32 sums were a TPU narrowing (no f64
// hardware). Here SUM accumulates in f64 for float values and in i64 for
// integers, COUNT is i64, and MIN/MAX keep the value type: f32/f64 reduce
// on their order-preserving integer image (NaN past +inf, as
// datafusion_tpu/ops/aggregate.py:1165-1172 does). Float sums follow IEEE
// for NaN and +-inf, so no sanitize / exact-restore pass exists, and give
// the same bits in every run (reduce_common.cuh states what holds in
// each mode).
//
// What bounds it on this card: bytes. Both modes read the group ids once
// per launch and each value (and optional mask) stream once, with one
// combine per row and op; the accumulator tables are small next to the
// row streams. In dense mode the shared atomics come next: a small table
// takes many lanes to one slot.
//
// Both modes make one launch for every op (up to DFT_FOLD_MAX_OPS, passed
// by value), load a thread's DFT_TILE consecutive rows as vectors with the
// fold tile's loads, take the op kind's switch once per tile, and write
// the fold tile's zero-identity tables (reduce_common.cuh): the wrapper's
// one zeroed buffer comes back as the outputs, the last block having
// decoded MIN/MAX in place.
//
// * Sorted mode (group ids ascending; ids outside [0, num_groups) only
//   at the ends): each warp reduces a span of consecutive 128-row tiles,
//   the grid filling the card. A lane walks its 4 rows' runs in
//   registers; a run bounded inside the lane is complete and stored
//   directly. A segmented scan over the lanes (shuffles, no shared
//   memory) completes the runs that cross lanes, and the run open at the
//   tile's end is carried in registers to the next tile (op a's in lane
//   a). So a run is written once, by a plain store, unless it may reach
//   past the warp's span (its id is that of the row before or after the
//   span). Such an edge run of an integer SUM, a COUNT or a MIN/MAX goes
//   to device memory by a global atomic (64-bit add and unsigned max,
//   native there). An edge run of a float SUM goes to its warp's edge slot
//   in shared memory instead; the block combines its warps' slots in warp
//   order, stores the runs that end inside the block, and leaves the two
//   that may reach past it in the launch's edge slots (two per block and
//   float SUM, `aux`); the last block adds each such run's partials in
//   block order. So a float SUM is added in row order within a warp and in
//   span order across warps and blocks: the same bits in every run on the
//   same card, whose SM count fixes the grid. The accumulator table lives
//   in device memory, so the TPU's VMEM budget gate (`accum_fits_vmem`)
//   has no counterpart.
// * Dense mode (ids in any order, num_groups <= 2048): the grid fills
//   the card at the occupancy the tables' shared memory allows
//   (fold_blocks); each 512-thread block folds a grid-stride range of
//   DFT_TILE_ROWS-row tiles into per-op shared tables with the fold tile,
//   each slot held `reps` times so the lanes of a warp on a small table do
//   not contend, then flushes each touched slot into the device table by
//   one global atomic. A float SUM is six 32-bit words a slot in fixed
//   point (reduce_common.cuh), after a first pass over its rows for the
//   scale.
//   The caller (ops/pallas/segreduce.py `fold_launches`) picks `reps` and
//   splits an op list whose tables do not fit one block's shared memory
//   into the fewest launches that fit.
//
// The op kinds and traits live in reduce_common.cuh, shared with K4 and
// K6.

#include "reduce_common.cuh"

#define DENSE_MAX_SLOTS 2048
#define SORTED_WARPS (DFT_FOLD_TPB / 32)
#define SORTED_TILE_ROWS (32 * DFT_TILE)  // a warp's tile
#define SORTED_MAX_BLOCKS (SORTED_WARPS * DFT_FOLD_MAX_OPS * 2)  // the last block stages one edge slot per block
#define FULL_MASK 0xffffffffu

// --- sorted mode ---------------------------------------------------------
template <typename T>
__device__ __forceinline__ unsigned long long to_bits(T v) {
  unsigned long long b = 0;
  memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b) {
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

// A float SUM's partial of a run that may reach past a span: id + 1 (0:
// none) and the partial. A warp's two slots sit in shared memory, a
// block's two in the launch's edge slots.
struct EdgeSlot {
  double v;
  int id1;
};

template <class Op>
struct IsFloatSum : std::integral_constant<bool, std::is_same<Op, SumF64Op>::value ||
                                                     std::is_same<Op, SumF32Op>::value> {};

// run g's total v into the device table: a float SUM's run that may reach
// past the warp's span (its id is that of the row before or after the
// span) into the warp's edge slot e[0] or e[1], another op's by an atomic;
// any other run by a store (no other warp holds a row of it)
template <class Op>
__device__ __forceinline__ void run_store(void* out, int g, typename Zero<Op>::Shared v, int edge_lo, int edge_hi,
                                          EdgeSlot* e) {
  typedef Zero<Op> Z;
  typedef typename Z::Acc Acc;
  if (g == edge_lo || g == edge_hi) {
    if constexpr (IsFloatSum<Op>::value) {
      EdgeSlot& slot = e[g == edge_lo ? 0 : 1];
      slot.v = v;
      slot.id1 = g + 1;
    } else {
      Z::atomic((Acc*)out + g, Z::widen(v));
    }
  } else {
    ((Acc*)out)[g] = Z::widen(v);
  }
}

template <class Op>
__device__ __forceinline__ void carry_store(void* out, int g, unsigned long long bits, int edge_lo, int edge_hi,
                                            EdgeSlot* e) {
  run_store<Op>(out, g, from_bits<typename Zero<Op>::Shared>(bits), edge_lo, edge_hi, e);
}

// The runs of a warp's tile, the same for every op: each lane's DFT_TILE
// ids (-1 for a dropped row), its first and last run, the first lane of
// its last run's segment in the warp, the last run of the lane before
// (lane 0: the run carried from the previous tile, or -1) and the first
// run of the lane after (lane 31: its own last run, which goes on).
struct Runs {
  int w[DFT_TILE];
  int fid, lid, head, prev, next;
};

__device__ __forceinline__ Runs tile_runs(const int* __restrict__ gid, long long r, int c, int num_groups) {
  const int lane = threadIdx.x & 31;
  Runs R;
  load_tile(gid, r, c, R.w);
  R.fid = R.lid = -1;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    if (k >= c || R.w[k] < 0 || R.w[k] >= num_groups) {
      R.w[k] = -1;
    } else {
      if (R.fid < 0) R.fid = R.w[k];
      R.lid = R.w[k];
    }
  }
  const int up = __shfl_up_sync(FULL_MASK, R.lid, 1);
  const unsigned heads = __ballot_sync(FULL_MASK, lane == 0 || up != R.lid);
  R.head = 31 - __clz(heads & (FULL_MASK >> (31 - lane)));
  R.prev = up;
  const int down = __shfl_down_sync(FULL_MASK, R.fid, 1);
  R.next = lane == 31 ? R.lid : down;
  return R;
}

// One op over a warp's tile. A lane walks its rows' runs in registers: a
// run bounded inside the lane is complete and stored; its first run waits
// for the lanes before it and its last one for the lanes after it. A
// segmented scan (shuffles) over the lanes' last runs, with the carried
// run added to the warp's first segment, completes both; the run still
// open at lane 31 is carried to the next tile, op a's in lane a's `carry`.
template <class Op>
__device__ __forceinline__ void sorted_tile(const Runs& R, const void* vals, const uint8_t* mask, void* out,
                                            long long r, int cnt, int a, unsigned long long& carry, int ckey,
                                            int lid31, int edge_lo, int edge_hi, EdgeSlot* e) {
  typedef Zero<Op> Z;
  typedef typename Op::In In;
  typedef typename Z::Shared Acc;
  const int lane = threadIdx.x & 31;
  In x[DFT_TILE] = {};
  uint8_t m[DFT_TILE];
  if (R.lid < 0) cnt = 0;  // no row kept: read no values
  if constexpr (!std::is_same<Op, CountOp>::value) load_tile((const In*)vals, r, cnt, x);
  if (mask != nullptr) {
    load_tile(mask, r, cnt, m);
  } else {
#pragma unroll
    for (int k = 0; k < DFT_TILE; ++k) m[k] = 1;
  }
  Acc first = 0, acc = 0;
  int cur = -1, runs = 0;
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    const int g = R.w[k];
    if (g < 0) continue;
    if (g != cur) {
      if (cur >= 0) {
        if (runs == 0) first = acc;
        else run_store<Op>(out, cur, acc, edge_lo, edge_hi, e);
        ++runs;
      }
      cur = g;
      acc = 0;  // from the identity, as the plain version's table: -0.0 sums read +0.0
    }
    acc = Z::combine(acc, m[k] ? Z::of(x[k]) : (Acc)0);
  }
  Acc S = acc;  // the last run, then its total over the lanes so far
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc o = __shfl_up_sync(FULL_MASK, S, d);
    if (lane - d >= R.head) S = Z::combine(o, S);
  }
  const Acc cv = from_bits<Acc>(__shfl_sync(FULL_MASK, carry, a));
  if (ckey >= 0 && R.head == 0 && R.lid == ckey) S = Z::combine(cv, S);
  Acc before = __shfl_up_sync(FULL_MASK, S, 1);
  if (lane == 0) before = cv;
  if (runs > 0) run_store<Op>(out, R.fid, R.prev == R.fid ? Z::combine(before, first) : first, edge_lo, edge_hi, e);
  if (R.lid >= 0 && R.next != R.lid) run_store<Op>(out, R.lid, S, edge_lo, edge_hi, e);
  const Acc s31 = __shfl_sync(FULL_MASK, S, 31);
  if (lane == a) carry = lid31 >= 0 ? to_bits(s31) : 0ULL;
}

// A float SUM's edge partials of a block (thread a, op a's slots of its
// warps in warp order, in shared memory): each run of equal ids added in
// that order; a run that may reach past the block (the id of the row
// before or after it) into the block's edge slot ge[0] / ge[1], any other
// stored in the table.
__device__ __forceinline__ void edge_block(double* out, EdgeSlot (*se)[DFT_FOLD_MAX_OPS][2], int a, int block_lo,
                                           int block_hi, EdgeSlot* ge) {
  int cur = 0;
  double acc = 0.0;
  for (int i = 0; i <= SORTED_WARPS * 2; ++i) {
    const EdgeSlot e = i < SORTED_WARPS * 2 ? se[i >> 1][a][i & 1] : EdgeSlot{0.0, -1};
    if (e.id1 == 0) continue;
    if (e.id1 == cur) {
      acc = __dadd_rn(acc, e.v);
      continue;
    }
    if (cur) {
      const int g = cur - 1;
      if (g == block_lo || g == block_hi) ge[g == block_lo ? 0 : 1] = EdgeSlot{acc, cur};
      else out[g] = acc;
    }
    cur = e.id1;
    acc = e.v;
  }
}

// The last block: each float SUM's runs that cross blocks, their block
// partials added in block order. A run starts in a block's slot 1 and
// goes on through the next blocks' slot 0 while the id repeats; slot 0 of
// every block is staged in shared memory (`stage`, SORTED_MAX_BLOCKS
// slots) first.
__device__ __forceinline__ void edge_final(const FoldShared& s, int n_ops, EdgeSlot* stage) {
  const int B = gridDim.x;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_float_sum(s.kind[a])) continue;  // block-uniform
    const EdgeSlot* ge = (const EdgeSlot*)s.aux[a];
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      stage[b] = EdgeSlot{__ldcg(&ge[2 * b].v), __ldcg(&ge[2 * b].id1)};
    __syncthreads();
    double* out = (double*)s.out[a];
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const int id1 = __ldcg(&ge[2 * t + 1].id1);
      if (id1 == 0) continue;
      double acc = __ldcg(&ge[2 * t + 1].v);
      for (int b = t + 1; b < B && stage[b].id1 == id1; ++b) acc = __dadd_rn(acc, stage[b].v);
      out[id1 - 1] = acc;
    }
    __syncthreads();
  }
}

// Each warp reduces one span of `warp_tiles` consecutive tiles, every op
// of `ops` per tile, carrying the open run from tile to tile; then the
// block combines its float SUMs' edge partials, and the last block adds
// those that cross blocks and decodes MIN/MAX.
__global__ void __launch_bounds__(DFT_FOLD_TPB)
seg_sorted_kernel(const int* __restrict__ gid, long long n, int num_groups, long long warp_tiles, FoldArgs ops,
                  unsigned int* done) {
  __shared__ FoldShared s;
  __shared__ EdgeSlot s_edge[SORTED_WARPS][DFT_FOLD_MAX_OPS][2];
  load_fold_shared(s, ops);
  for (int i = threadIdx.x; i < SORTED_WARPS * DFT_FOLD_MAX_OPS * 2; i += blockDim.x)
    (&s_edge[0][0][0])[i] = EdgeSlot{0.0, 0};
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long span = warp_tiles * SORTED_TILE_ROWS;
  const long long rb0 = (long long)blockIdx.x * SORTED_WARPS * span;
  const long long r0 = rb0 + warp * span;
  if (r0 < n) {  // warp-uniform
    const long long r1 = r0 + span < n ? r0 + span : n;
    const int edge_lo = r0 > 0 ? __ldg(gid + r0 - 1) : -1;
    const int edge_hi = r1 < n ? __ldg(gid + r1) : -1;
    unsigned long long carry = 0;
    int ckey = -1;  // the carried run's id, -1 for none
    for (long long t = r0; t < r1; t += SORTED_TILE_ROWS) {
      const long long r = t + lane * DFT_TILE;
      const int c = r >= r1 ? 0 : r1 - r < DFT_TILE ? (int)(r1 - r) : DFT_TILE;
      Runs R = tile_runs(gid, r, c, num_groups);
      if (ckey >= 0 && __shfl_sync(FULL_MASK, R.fid, 0) != ckey) {  // the carried run ended with the last tile
        if (lane < ops.n) {
          DFT_DISPATCH_KIND(s.kind[lane], carry_store, s.out[lane], ckey, carry, edge_lo, edge_hi,
                            s_edge[warp][lane])
        }
        ckey = -1;
      }
      if (lane == 0) R.prev = ckey;
      const int lid31 = __shfl_sync(FULL_MASK, R.lid, 31);
      for (int a = 0; a < ops.n; ++a) {
        DFT_DISPATCH_KIND(s.kind[a], sorted_tile, R, s.val[a], s.mask[a], s.out[a], r, c, a, carry, ckey, lid31,
                          edge_lo, edge_hi, s_edge[warp][a])
      }
      ckey = lid31;
    }
    if (ckey >= 0 && lane < ops.n) {
      DFT_DISPATCH_KIND(s.kind[lane], carry_store, s.out[lane], ckey, carry, edge_lo, edge_hi, s_edge[warp][lane])
    }
  }
  __syncthreads();  // every warp's edge slots
  const int a = threadIdx.x;
  if (a < ops.n && dft_float_sum(s.kind[a])) {
    const long long rb1 = rb0 + SORTED_WARPS * span < n ? rb0 + SORTED_WARPS * span : n;
    edge_block((double*)s.out[a], s_edge, a, rb0 > 0 ? __ldg(gid + rb0 - 1) : -1, rb1 < n ? __ldg(gid + rb1) : -1,
               (EdgeSlot*)s.aux[a] + 2 * blockIdx.x);
  }
  if (fold_last(done)) {
    edge_final(s, ops.n, &s_edge[0][0][0]);
    fold_decode(ops.n, s, num_groups);
  }
}

// --- dense mode ----------------------------------------------------------
__global__ void __launch_bounds__(DFT_FOLD_TPB, 2)
seg_dense_kernel(const int* __restrict__ gid, long long n, int num_groups, int reps, FoldArgs ops,
                 unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  load_fold_shared(s, ops);
  fold_init(smem, ops.smem);
  __syncthreads();
  int steps = 0;
  fold_range(smem, ops.n, ops.nfix, s, gid, 0, n, blockIdx.x, gridDim.x, num_groups, reps, 0, steps);
  __syncthreads();
  fold_finish(smem, ops.n, s, 0, num_groups, reps, num_groups, done);
}

// --- C entries ---------------------------------------------------------------
// Both modes: kinds[a] selects op a's kind (reduce_common.cuh), vals[a]
// / masks[a] are its device streams (either may be null), outs[a] is its
// [num_groups] device table and `done` a device counter, all zeroed (the
// fold tile's tables): op a's table ends as the op's output (f64/i64 SUM,
// i64 COUNT, MIN/MAX in the value type with +-inf for an empty float
// slot). aux[a] is a float SUM's zeroed device scratch, null for other
// ops: in sorted mode its edge slots (2 * max_blocks EdgeSlots), in dense
// mode its 8-byte scale word. A dense-mode float SUM's outs[a] is four
// [num_groups] tables, one after another, its f64 result ending in the
// first.

// Sorted mode, one launch for every op given (at most DFT_FOLD_MAX_OPS),
// on at most max_blocks blocks.
extern "C" int dft_segreduce(const int* gid, long long n, int num_groups, int n_ops, const int* kinds,
                             const void* const* vals, const uint8_t* const* masks, void* const* outs,
                             void* const* aux, unsigned int* done, int max_blocks, void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  FoldArgs o;
  if (max_blocks < 1 || !fold_args(&o, n_ops, kinds, vals, masks, outs, aux, num_groups, false)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  long long blocks = fold_blocks(seg_sorted_kernel, 0, &err);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + SORTED_TILE_ROWS - 1) / SORTED_TILE_ROWS;
  const long long warps = (tiles + SORTED_WARPS - 1) / SORTED_WARPS;
  if (blocks > warps) blocks = warps;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > SORTED_MAX_BLOCKS) blocks = SORTED_MAX_BLOCKS;
  long long warp_tiles = (tiles + blocks * SORTED_WARPS - 1) / (blocks * SORTED_WARPS);
  // a span of fewer than 2^31 rows: COUNT's carry is 32-bit
  if (warp_tiles > DFT_BLOCK_MAX_ROWS / SORTED_TILE_ROWS) return (int)cudaErrorInvalidValue;
  blocks = (tiles + warp_tiles * SORTED_WARPS - 1) / (warp_tiles * SORTED_WARPS);
  seg_sorted_kernel<<<(unsigned int)blocks, DFT_FOLD_TPB, 0, (cudaStream_t)stream>>>(gid, n, num_groups, warp_tiles,
                                                                                     o, done);
  return (int)cudaGetLastError();
}

// Dense mode, one launch for every op given, each slot held `reps`
// times in shared memory; with a float SUM, the first pass for its scale
// before it.
extern "C" int dft_segreduce_dense(const int* gid, long long n, int num_groups, int reps, int n_ops,
                                   const int* kinds, const void* const* vals, const uint8_t* const* masks,
                                   void* const* outs, void* const* aux, unsigned int* done, void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  FoldArgs o;
  if (num_groups > DENSE_MAX_SLOTS || !dft_valid_reps(reps) ||
      !fold_args(&o, n_ops, kinds, vals, masks, outs, aux, num_groups, true) ||
      (fold_has_fix(o) && n > DFT_FIX_MAX_ROWS) || !fold_layout(&o, (long long)num_groups * reps))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  long long blocks = fold_blocks(seg_dense_kernel, o.smem, &err);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  if (fold_has_fix(o)) {
    long long sblocks = fold_blocks(fold_scale_kernel, 0, &err);
    if (err != cudaSuccess) return (int)err;
    if (sblocks > tiles) sblocks = tiles;
    fold_scale_kernel<<<(unsigned int)sblocks, DFT_FOLD_TPB, 0, (cudaStream_t)stream>>>(gid, n, num_groups, o);
  }
  if (blocks > tiles) blocks = tiles;
  if (blocks < n / DFT_BLOCK_MAX_ROWS + 1) blocks = n / DFT_BLOCK_MAX_ROWS + 1;
  seg_dense_kernel<<<(unsigned int)blocks, DFT_FOLD_TPB, (size_t)o.smem, (cudaStream_t)stream>>>(
      gid, n, num_groups, reps, o, done);
  return (int)cudaGetLastError();
}
