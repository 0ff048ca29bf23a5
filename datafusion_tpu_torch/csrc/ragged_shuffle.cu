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
// sender j). Pointer tables are int64 device arrays, array-major:
// ptr[a * n_dev + shard].
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
// * K6: one block of 256 threads per K6_ROWS routed rows of one (sender,
//   receiver) pair (65,536 rows: the fewer the blocks, the fewer global
//   atomics their flushes take). The receiver's table has at most
//   DFT_WINDOW slots, so each op's whole table is one shared-memory window (K4's, in
//   reduce_common.cuh): the block folds its rows into the windows with
//   shared atomics and flushes the touched slots into the receiver's
//   device tables with one global atomic each. Op traits are K2's: f64 /
//   i64 sums (IEEE NaN and +-inf), i64 counts, MIN/MAX on the
//   order-preserving image. Rows with a window id outside [0, num_groups)
//   are dropped; an op's mask pointer may be null (every routed row).

#include "reduce_common.cuh"

#include <stdint.h>

#define K5_THREADS 256
#define K6_THREADS 256
#define K6_ROWS 65536
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
struct FoldKinds {
  int n;
  int kinds[DFT_MAX_OPS];
};

__global__ void __launch_bounds__(K6_THREADS)
ragged_exchange_fold_kernel(const long long* __restrict__ gid_ptr, const long long* __restrict__ val_ptr,
                            const long long* __restrict__ mask_ptr, const long long* __restrict__ out_ptr,
                            const int* __restrict__ sizes, int n_dev, long long split_cap, int num_groups,
                            FoldKinds ops) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const void* s_val[DFT_MAX_OPS];
  __shared__ const uint8_t* s_mask[DFT_MAX_OPS];
  __shared__ void* s_out[DFT_MAX_OPS];
  const int pair = blockIdx.y;  // j * n_dev + i
  const int j = pair / n_dev, i = pair % n_dev;
  const long long cnt = sizes[pair];
  const long long r0 = (long long)blockIdx.x * K6_ROWS;
  if (r0 >= cnt) return;  // block-uniform, before any barrier
  const long long r1 = r0 + K6_ROWS < cnt ? r0 + K6_ROWS : cnt;
  for (int a = 0; a < ops.n; ++a) {
    DFT_DISPATCH_KIND(ops.kinds[a], win_init, smem + a * WIN_BYTES)
  }
  if (threadIdx.x < ops.n) {  // this pair's pointers, read once per block
    const long long at = (long long)threadIdx.x * n_dev;
    s_val[threadIdx.x] = (const void*)val_ptr[at + j];
    s_mask[threadIdx.x] = (const uint8_t*)mask_ptr[at + j];
    s_out[threadIdx.x] = (void*)out_ptr[at + i];
  }
  __syncthreads();
  const long long base = (long long)i * split_cap;  // receiver i's region in sender j's arrays
  const int* gid = (const int*)gid_ptr[j];
  for (long long r = base + r0 + threadIdx.x; r < base + r1; r += K6_THREADS) {
    const int w = gid[r];
    if (w < 0 || w >= num_groups) continue;
    for (int a = 0; a < ops.n; ++a) {
      DFT_DISPATCH_KIND(ops.kinds[a], win_add, smem + a * WIN_BYTES, s_out[a], s_val[a], s_mask[a], r, w, w)
    }
  }
  __syncthreads();
  for (int a = 0; a < ops.n; ++a) {
    DFT_DISPATCH_KIND(ops.kinds[a], win_flush, smem + a * WIN_BYTES, s_out[a], 0)
  }
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

// K6. gid_ptr: [n_dev] device pointers to the senders' int32 window ids;
// val_ptr / mask_ptr / out_ptr: [n_ops * n_dev] device pointer tables
// (values and masks by sender, may be 0; outputs by receiver, [num_groups]
// tables initialised to each op's identity). kinds: host array of op kinds
// (reduce_common.cuh). sizes as for K5.
extern "C" int dft_ragged_exchange_fold(const long long* gid_ptr, const long long* val_ptr, const long long* mask_ptr,
                                        const long long* out_ptr, const int* sizes, int n_dev, long long split_cap,
                                        int num_groups, int n_ops, const int* kinds, void* stream) {
  if (n_ops == 0 || split_cap == 0 || num_groups == 0) return 0;
  if (n_dev < 1 || n_dev > DFT_MAX_DEV || n_ops < 0 || n_ops > DFT_MAX_OPS || num_groups < 0 ||
      num_groups > DFT_WINDOW || split_cap < 0)
    return (int)cudaErrorInvalidValue;
  FoldKinds o;
  o.n = n_ops;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    o.kinds[a] = kinds[a];
  }
  const int smem = n_ops * WIN_BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ragged_exchange_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (split_cap + K6_ROWS - 1) / K6_ROWS;
  const dim3 grid((unsigned int)blocks, (unsigned int)(n_dev * n_dev));
  ragged_exchange_fold_kernel<<<grid, K6_THREADS, smem, (cudaStream_t)stream>>>(
      gid_ptr, val_ptr, mask_ptr, out_ptr, sizes, n_dev, split_cap, num_groups, o);
  return (int)cudaGetLastError();
}
