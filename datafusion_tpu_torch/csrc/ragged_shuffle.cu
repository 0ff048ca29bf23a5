// K5 — ragged exchange, and K6 — ragged exchange fused with a dense fold,
// for Hopper (sm_90a): the distributed engine's shuffle between the logical
// shards of a mesh on one card.
//
// Replaces: datafusion_tpu/ops/pallas/ragged_shuffle.py
//   K5 `ragged_exchange` (:544), pallas_call at :566, body `_exchange_kernel`
//      (:64)
//   K6 `ragged_exchange_fold` (:456), pallas_call at :512, body
//      `_exchange_fold_kernel` (:242) and `_fold_sub` (:186)
// The TPU kernels start one remote DMA per chunk, array and peer over ICI,
// behind a semaphore barrier; K6 stages the arrived chunks through VMEM and
// folds them with one-hot MXU products. On one card every shard's buffers
// lie in the same HBM, so there is no peer, no barrier and no landing
// buffer: K5 is one launch of plain copies, and K6 reads each routed row
// straight from its sender's send buffer, so exchange and fold are one pass.
//
// Layout (both kernels): every array is a sender's [n_dev * split_cap]
// region layout; region i holds the rows for receiver i, valid prefix
// sizes[j, i] (sizes is the [n_dev, n_dev] int32 count matrix, row j =
// sender j). K5's pointer tables are int64 device arrays, array-major:
// ptr[a * n_dev + shard]; K6 takes one packed table (below).
//
// What bounds both on this card: bytes. K5 reads and writes each live
// chunk once (a region's last chunk copies up to chunk - 1 rows of its
// padding); K6 reads each routed row's window id, values and masks once and
// writes each receiver's tables once. Neither computes more than a few
// operations per byte.
//
// * K5: one block of 256 threads per (chunk k, sender j, receiver i,
//   array a); a block past ceil(sizes[j, i] / chunk) returns at once. The
//   block copies chunk k of region i of sender j to region j of receiver
//   i, in 16-byte words when both addresses allow it. Tails past
//   sizes[j, i] are not written: the receive validity is
//   slot % split_cap < sizes[j, i], so no validity rides the exchange.
// * K6: a grid of (B, n_dev receivers) blocks of DFT_FOLD_TPB threads;
//   B x n_dev blocks fill the SMs at the occupancy the tables' shared
//   memory allows. Block b of receiver i walks every sender's region i,
//   sender by sender, taking the DFT_TILE_ROWS-row tiles b, b + B, ... of
//   their concatenation, so the blocks of a receiver share its rows evenly
//   whatever the skew between senders. The receiver's table has at most
//   DFT_WINDOW slots, so each op's whole table sits in the block's shared
//   memory, each slot held `reps` times; the rows fold in with K2 dense
//   mode's fold tile (reduce_common.cuh: 4 rows a thread, vector loads, one
//   kind switch per tile and op, equal neighbours combined in registers),
//   and each block inits its tables once and flushes each touched slot
//   into the receiver's row of the device tables by one global atomic at
//   the end; the last block decodes MIN/MAX in place. Op traits are K2's:
//   f64 / i64 sums (IEEE NaN and +-inf), i64 counts, MIN/MAX on the
//   order-preserving image. Rows with a window id outside [0, num_groups)
//   are dropped; an op's mask pointer may be null (every routed row).

#include "reduce_common.cuh"

#include <stdint.h>

#define K5_THREADS 256
#define DFT_MAX_DEV 255  // n_dev * n_dev pairs must fit gridDim.y

// --- K5 ragged exchange --------------------------------------------------------
__global__ void __launch_bounds__(K5_THREADS)
ragged_exchange_kernel(const long long* __restrict__ send, const long long* __restrict__ recv,
                       const int* __restrict__ esize, const int* __restrict__ sizes, int n_dev,
                       long long split_cap, int chunk) {
  const long long k = blockIdx.x;
  const int pair = blockIdx.y;  // j * n_dev + i
  const int a = blockIdx.z;
  const int j = pair / n_dev, i = pair % n_dev;
  if (k * chunk >= (long long)sizes[pair]) return;
  const long long es = esize[a];
  const unsigned char* src =
      (const unsigned char*)send[(long long)a * n_dev + j] + ((long long)i * split_cap + k * chunk) * es;
  unsigned char* dst = (unsigned char*)recv[(long long)a * n_dev + i] + ((long long)j * split_cap + k * chunk) * es;
  const long long bytes = (long long)chunk * es;
  if ((((uintptr_t)src | (uintptr_t)dst | (uintptr_t)bytes) & 15) == 0) {
    const long long words = bytes / 16;
    for (long long w = threadIdx.x; w < words; w += K5_THREADS) ((uint4*)dst)[w] = ((const uint4*)src)[w];
  } else {
    for (long long b = threadIdx.x; b < bytes; b += K5_THREADS) dst[b] = src[b];
  }
}

// --- K6 ragged exchange + fold -------------------------------------------------
struct FoldOps {
  int n;
  int kinds[DFT_MAX_OPS];
  void* outs[DFT_MAX_OPS];
};

__global__ void __launch_bounds__(DFT_FOLD_TPB)
ragged_exchange_fold_kernel(const long long* __restrict__ ptrs, const int* __restrict__ sizes, int n_dev,
                            long long split_cap, int num_groups, int reps, FoldOps ops, unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  const int i = blockIdx.y;  // the receiver
  const int k = ops.n;
  if (threadIdx.x < k) {
    s.kind[threadIdx.x] = ops.kinds[threadIdx.x];
    s.out[threadIdx.x] = ops.outs[threadIdx.x];
  }
  const int tbl_bytes = num_groups * reps * 8;
  fold_init(smem, k * tbl_bytes);
  const long long B = gridDim.x, b = blockIdx.x;
  long long toff = 0;  // tiles of the senders before j
  for (int j = 0; j < n_dev; ++j) {
    const long long cnt = sizes[(long long)j * n_dev + i];
    if (cnt == 0) continue;  // block-uniform
    __syncthreads();  // the previous sender's pointers are no longer read
    if (threadIdx.x < k) {  // sender j's values and masks, from the packed table
      s.val[threadIdx.x] = (const void*)ptrs[n_dev + (long long)threadIdx.x * n_dev + j];
      s.mask[threadIdx.x] = (const uint8_t*)ptrs[(long long)(1 + k + threadIdx.x) * n_dev + j];
    }
    __syncthreads();
    const long long first = ((b - toff) % B + B) % B;  // this block's first tile of sender j
    fold_range(smem, tbl_bytes, k, s, (const int*)ptrs[j], (long long)i * split_cap, cnt, first, B, num_groups,
               reps);
    toff += (cnt + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  }
  __syncthreads();
  fold_flush(smem, tbl_bytes, k, s, (long long)i * num_groups, num_groups, reps, (long long)n_dev * num_groups,
             done);
}

// --- C entries -------------------------------------------------------------------

// K5. send / recv: [n_arrs * n_dev] device pointer tables; esize: [n_arrs]
// device element widths (1, 2, 4 or 8; checked by the wrapper); sizes:
// [n_dev, n_dev] device int32 counts, each at most split_cap (the caller's
// contract). chunk is a power of two in [128, 1024] dividing split_cap.
extern "C" int dft_ragged_exchange(const long long* send, const long long* recv, const int* esize, const int* sizes,
                                   int n_dev, int n_arrs, long long split_cap, int chunk, void* stream) {
  if (n_arrs == 0 || split_cap == 0) return 0;
  if (n_dev < 1 || n_dev > DFT_MAX_DEV || n_arrs < 0 || n_arrs > 65535 || chunk < 128 || chunk > 1024 ||
      (chunk & (chunk - 1)) != 0 || split_cap < 0 || split_cap % chunk != 0 || split_cap / chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(split_cap / chunk), (unsigned int)(n_dev * n_dev), (unsigned int)n_arrs);
  ragged_exchange_kernel<<<grid, K5_THREADS, 0, (cudaStream_t)stream>>>(send, recv, esize, sizes, n_dev, split_cap,
                                                                        chunk);
  return (int)cudaGetLastError();
}

// K6. ptrs: one packed device table of (1 + 2 * n_ops) * n_dev pointers:
// the senders' int32 window ids, then op a's values by sender (at
// (1 + a) * n_dev), then op a's masks by sender (at (1 + n_ops + a) *
// n_dev); values and masks may be 0. kinds: host array of op kinds
// (reduce_common.cuh); outs: host array of op a's [n_dev, num_groups]
// device table (receiver i's row at i * num_groups) and `done` a device
// counter, all zeroed (reduce_common.cuh, the fold tile): op a's table
// ends as the op's output, as for K2 dense mode. Each slot is held `reps`
// times in shared memory. sizes as for K5.
extern "C" int dft_ragged_exchange_fold(const long long* ptrs, const int* sizes, int n_dev, long long split_cap,
                                        int num_groups, int reps, int n_ops, const int* kinds, void* const* outs,
                                        unsigned int* done, void* stream) {
  if (n_ops == 0 || split_cap == 0 || num_groups == 0) return 0;
  if (n_dev < 1 || n_dev > DFT_MAX_DEV || n_ops < 0 || n_ops > DFT_MAX_OPS || num_groups < 0 ||
      num_groups > DFT_WINDOW || split_cap < 0 || !dft_valid_reps(reps))
    return (int)cudaErrorInvalidValue;
  FoldOps o;
  o.n = n_ops;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    o.kinds[a] = kinds[a];
    o.outs[a] = outs[a];
  }
  const int smem = n_ops * num_groups * reps * 8;
  cudaError_t err;
  const long long fill = fold_blocks(ragged_exchange_fold_kernel, smem, &err);
  if (err != cudaSuccess) return (int)err;
  // blocks per receiver: the card's share, and no more than its rows' tiles
  long long per = fill / n_dev;
  const long long most = ((long long)n_dev * split_cap + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  if (per > most) per = most;
  const long long rows = (long long)n_dev * split_cap;  // the most one receiver gets
  if (per < rows / DFT_BLOCK_MAX_ROWS + 1) per = rows / DFT_BLOCK_MAX_ROWS + 1;
  const dim3 grid((unsigned int)per, (unsigned int)n_dev);
  ragged_exchange_fold_kernel<<<grid, DFT_FOLD_TPB, smem, (cudaStream_t)stream>>>(ptrs, sizes, n_dev, split_cap,
                                                                                   num_groups, reps, o, done);
  return (int)cudaGetLastError();
}
