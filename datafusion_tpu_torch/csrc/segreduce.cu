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
// What bounds it on this card: bytes. Each op reads the group ids and its
// value (and optional mask) stream once and does one combine per row; the
// accumulator tables are small next to the row streams.
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
// * Dense mode (ids in any order, num_groups <= 2048): each block builds a
//   shared-memory table with shared-memory atomics over a grid-stride
//   range of rows, then merges it into the device table with one global
//   atomic per touched slot. f64 atomicAdd is native; 64-bit MIN/MAX use
//   atomicMin/atomicMax on the signed sortable image.
//
// The host entry launches one kernel per op; ops read their own value and
// mask streams (the Python wrapper passes each distinct stream once). The
// op kinds and traits live in reduce_common.cuh, shared with K4.

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
template <class Op>
__global__ void seg_dense_kernel(const int* __restrict__ gid, const typename Op::In* __restrict__ vals,
                                 const uint8_t* __restrict__ mask, typename Op::Acc* __restrict__ out,
                                 long long n, int num_groups) {
  typedef typename Op::Acc Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* table = reinterpret_cast<Acc*>(smem_raw);
  for (int i = threadIdx.x; i < num_groups; i += blockDim.x) table[i] = Op::identity();
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    const int g = gid[r];
    if (g < 0 || g >= num_groups) continue;
    if (mask != nullptr && !mask[r]) continue;
    Op::atomic(&table[g], Op::contrib(vals, r));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_groups; i += blockDim.x) {
    const Acc v = table[i];
    if (v != Op::identity()) Op::atomic(&out[i], v);
  }
}

template <class Op>
static void launch(bool dense, const int* gid, const void* vals, const uint8_t* mask, void* out,
                   long long n, int num_groups, int dense_blocks, cudaStream_t stream) {
  typedef typename Op::In In;
  typedef typename Op::Acc Acc;
  if (dense) {
    long long blocks = (n + TPB - 1) / TPB;
    if (blocks > dense_blocks) blocks = dense_blocks;
    seg_dense_kernel<Op><<<(unsigned int)blocks, TPB, num_groups * sizeof(Acc), stream>>>(
        gid, (const In*)vals, mask, (Acc*)out, n, num_groups);
  } else {
    const long long blocks = (n + TPB * IT - 1) / (TPB * IT);
    seg_sorted_kernel<Op><<<(unsigned int)blocks, TPB, 0, stream>>>(
        gid, (const In*)vals, mask, (Acc*)out, n, num_groups);
  }
}

// One call reduces every op. kinds[a] selects the op kind, vals[a] /
// masks[a] / outs[a] are device pointers (vals/masks may be null). The
// output tables arrive initialised to each op's identity.
extern "C" int dft_segreduce(const int* gid, long long n, int num_groups, int dense, int n_ops,
                             const int* kinds, const void* const* vals,
                             const uint8_t* const* masks, void* const* outs, void* stream) {
  if (n <= 0 || num_groups <= 0) return 0;
  if (dense && num_groups > DENSE_MAX_SLOTS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int dense_blocks = 2 * sms;
  const bool d = dense != 0;
  for (int a = 0; a < n_ops; ++a) {
    const void* v = vals[a];
    const uint8_t* m = masks[a];
    void* o = outs[a];
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    DFT_DISPATCH_KIND(kinds[a], launch, d, gid, v, m, o, n, num_groups, dense_blocks, s)
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
