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
// for NaN and +-inf natively, so no sanitize / exact-restore pass exists.
//
// What bounds it on this card: bytes. Sorted mode reads the group ids
// once per op, dense mode once per launch, and each value (and optional
// mask) stream once, with one combine per row and op; the accumulator
// tables are small next to the row streams. In dense mode the shared
// atomics come next: a small table takes many lanes to one slot.
//
// * Sorted mode (group ids ascending; ids >= num_groups only in the
//   tail): each block takes a contiguous tile of TPB x IT rows, each
//   thread IT consecutive rows. A thread reduces the runs of equal id in
//   its rows sequentially; a run bounded inside the thread is complete and
//   is stored directly. The threads' first/last run partials go to shared
//   memory, where the last entry of each run combines its run in order. A
//   run bounded inside the tile is stored directly; only the tile's first
//   and last runs reach device memory through atomics. The accumulator
//   table lives in device memory, so the TPU's VMEM budget gate
//   (`accum_fits_vmem`) has no counterpart.
// * Dense mode (ids in any order, num_groups <= 2048): one launch folds
//   every op (up to DFT_FOLD_MAX_OPS, passed by value as K4's ops are), so
//   the ids and each value and mask stream are read once per row. The
//   grid fills the card at the occupancy the tables' shared memory allows
//   (fold_blocks); each 512-thread block folds a grid-stride range of
//   DFT_TILE_ROWS-row tiles into per-op shared tables with the fold tile of
//   reduce_common.cuh (4 rows a thread, vector loads, one kind switch per
//   tile and op), each slot held `reps` times so the lanes of a warp on a
//   small table do not contend, then flushes each touched slot into the
//   device table by one global atomic; the last block decodes MIN/MAX in
//   place, so the wrapper's one zeroed buffer comes back as the outputs.
//   f64 / i64 sums, i64 counts, MIN/MAX on the order-preserving image.
//   The caller (ops/pallas/
//   segreduce.py `fold_launches`) picks `reps` and splits an op list
//   whose tables do not fit one block's shared memory into the fewest
//   launches that fit.
//
// The sorted-mode entry launches one kernel per op; ops read their own
// value and mask streams (the Python wrapper passes each distinct stream
// once). The op kinds and traits live in reduce_common.cuh, shared with
// K4 and K6.

#include "reduce_common.cuh"

#define TPB 256
#define IT 8
#define DENSE_MAX_SLOTS 2048

// --- sorted mode ---------------------------------------------------------
template <class Op>
__global__ void seg_sorted_kernel(const int* __restrict__ gid, const typename Op::In* __restrict__ vals,
                                  const uint8_t* __restrict__ mask, typename Op::Acc* __restrict__ out,
                                  long long n, int num_groups) {
  typedef typename Op::Acc Acc;
  __shared__ int s_gid[2 * TPB];
  __shared__ Acc s_acc[2 * TPB];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * (TPB * IT) + (long long)t * IT;

  int cur = -1, gF = -1;
  Acc acc = Op::identity(), aF = Op::identity();
  for (int k = 0; k < IT; ++k) {
    const long long r = r0 + k;
    if (r >= n) break;
    const int g = gid[r];
    if (g < 0 || g >= num_groups) break;  // dropped rows form the tail
    const Acc c = (mask == nullptr || mask[r]) ? Op::contrib(vals, r) : Op::identity();
    if (g != cur) {
      if (cur >= 0) {
        if (gF < 0) { gF = cur; aF = acc; }
        else out[cur] = acc;  // run bounded inside this thread: complete
      }
      cur = g;
      acc = c;
    } else {
      acc = Op::combine(acc, c);
    }
  }
  // entries (first run, last run); a single-run thread pairs its run with
  // an identity entry of the same id, so the valid entries stay a prefix
  if (cur >= 0 && gF < 0) { gF = cur; aF = acc; acc = Op::identity(); }
  s_gid[2 * t] = gF;
  s_acc[2 * t] = aF;
  s_gid[2 * t + 1] = cur;
  s_acc[2 * t + 1] = acc;
  __syncthreads();

  // each run's last entry combines the run, in entry order
  for (int e = 2 * t; e < 2 * t + 2; ++e) {
    const int g = s_gid[e];
    if (g < 0) continue;
    const bool last_of_tile = (e == 2 * TPB - 1) || s_gid[e + 1] < 0;
    if (!last_of_tile && s_gid[e + 1] == g) continue;
    int s = e;
    while (s > 0 && s_gid[s - 1] == g) --s;
    Acc total = s_acc[s];
    for (int j = s + 1; j <= e; ++j) total = Op::combine(total, s_acc[j]);
    if (s == 0 || last_of_tile) Op::atomic(&out[g], total);  // may span tiles
    else out[g] = total;  // bounded inside the tile: complete
  }
}

// --- dense mode ----------------------------------------------------------
struct DenseOps {
  int n;
  int kinds[DFT_FOLD_MAX_OPS];
  const void* vals[DFT_FOLD_MAX_OPS];
  const uint8_t* masks[DFT_FOLD_MAX_OPS];
  void* outs[DFT_FOLD_MAX_OPS];
};

__global__ void __launch_bounds__(DFT_FOLD_TPB)
seg_dense_kernel(const int* __restrict__ gid, long long n, int num_groups, int reps, DenseOps ops,
                 unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  if (threadIdx.x < ops.n) {
    s.kind[threadIdx.x] = ops.kinds[threadIdx.x];
    s.val[threadIdx.x] = ops.vals[threadIdx.x];
    s.mask[threadIdx.x] = ops.masks[threadIdx.x];
    s.out[threadIdx.x] = ops.outs[threadIdx.x];
  }
  const int tbl_bytes = num_groups * reps * 8;
  fold_init(smem, ops.n * tbl_bytes);
  __syncthreads();
  fold_range(smem, tbl_bytes, ops.n, s, gid, 0, n, blockIdx.x, gridDim.x, num_groups, reps);
  __syncthreads();
  fold_flush(smem, tbl_bytes, ops.n, s, 0, num_groups, reps, num_groups, done);
}

// --- C entries ---------------------------------------------------------------

template <class Op>
static void launch_sorted(const int* gid, const void* vals, const uint8_t* mask, void* out, long long n,
                          int num_groups, cudaStream_t stream) {
  typedef typename Op::In In;
  typedef typename Op::Acc Acc;
  const long long blocks = (n + TPB * IT - 1) / (TPB * IT);
  seg_sorted_kernel<Op><<<(unsigned int)blocks, TPB, 0, stream>>>(gid, (const In*)vals, mask, (Acc*)out, n,
                                                                   num_groups);
}

// Sorted mode, one launch per op. kinds[a] selects the op kind, vals[a] /
// masks[a] / outs[a] are device pointers (vals/masks may be null). The
// output tables arrive initialised to each op's identity.
extern "C" int dft_segreduce(const int* gid, long long n, int num_groups, int n_ops, const int* kinds,
                             const void* const* vals, const uint8_t* const* masks, void* const* outs,
                             void* stream) {
  if (n <= 0 || num_groups <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    DFT_DISPATCH_KIND(kinds[a], launch_sorted, gid, vals[a], masks[a], outs[a], n, num_groups, s)
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Dense mode, one launch for every op given, each slot held `reps` times
// in shared memory. kinds, vals and masks as for dft_segreduce; outs[a]
// is op a's [num_groups] device table and `done` a device counter, all
// zeroed (reduce_common.cuh, the fold tile): op a's table ends as the
// op's output (f64/i64 SUM, i64 COUNT, MIN/MAX in the value type with
// +-inf for an empty float slot).
extern "C" int dft_segreduce_dense(const int* gid, long long n, int num_groups, int reps, int n_ops,
                                   const int* kinds, const void* const* vals, const uint8_t* const* masks,
                                   void* const* outs, unsigned int* done, void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  if (num_groups > DENSE_MAX_SLOTS || n_ops < 0 || n_ops > DFT_FOLD_MAX_OPS || !dft_valid_reps(reps))
    return (int)cudaErrorInvalidValue;
  DenseOps o;
  o.n = n_ops;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    o.kinds[a] = kinds[a];
    o.vals[a] = vals[a];
    o.masks[a] = masks[a];
    o.outs[a] = outs[a];
  }
  const long long smem = (long long)n_ops * num_groups * reps * 8;
  if (smem > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  long long blocks = fold_blocks(seg_dense_kernel, (int)smem, &err);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  if (blocks > tiles) blocks = tiles;
  if (blocks < n / DFT_BLOCK_MAX_ROWS + 1) blocks = n / DFT_BLOCK_MAX_ROWS + 1;
  seg_dense_kernel<<<(unsigned int)blocks, DFT_FOLD_TPB, (size_t)smem, (cudaStream_t)stream>>>(
      gid, n, num_groups, reps, o, done);
  return (int)cudaGetLastError();
}
