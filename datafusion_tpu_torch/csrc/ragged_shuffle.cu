// K5 — ragged exchange, and K6 — ragged exchange fused with a dense fold,
// for Hopper (sm_90a): the distributed engine's shuffle between the logical
// shards of a mesh, on one card or across the cards of one process.
//
// Replaces: datafusion_tpu/ops/pallas/ragged_shuffle.py
//   K5 `ragged_exchange` (:544), pallas_call at :566, body `_exchange_kernel`
//      (:64)
//   K6 `ragged_exchange_fold` (:456), pallas_call at :512, body
//      `_exchange_fold_kernel` (:242) and `_fold_sub` (:186)
// The TPU kernels start one remote DMA per chunk, array and peer over ICI,
// behind a semaphore barrier; K6 stages the arrived chunks through VMEM and
// folds them with one-hot MXU products. Here a receiver's block reads its
// senders' rows where they lie: in the same HBM for shards of one card, and
// in a peer card's HBM, over NVLink, for a sender on another card of the
// process (unified addressing: a peer's device pointer is read like a local
// one once peer access is on, `dft_enable_peer_access` below). So there is
// no landing buffer: K5 copies each live chunk once, straight into the
// receiver's buffer (the receiving card pulls), and K6 folds each routed
// row straight from its sender's send buffer, exchange and fold in one
// pass. The TPU barrier semaphore becomes stream order and CUDA events,
// set by the wrapper (ops/pallas/ragged_shuffle.py): each receiving card's
// launch waits for every sender card's regions, and each sender card's
// stream waits for every receiving card's launch before it may reuse a
// send buffer.
//
// Layout (both kernels): n_send senders and n_recv receivers; every array
// is a sender's [n_recv * split_cap] region layout, region i holding the
// rows for receiver i, valid prefix sizes[j, i] (sizes is the [n_send,
// n_recv] int32 count matrix, row j = sender j, on the launching card).
// One launch serves the receivers of one card: on a mesh of one card they
// are its n_dev shards; on a mesh of several cards, or of several
// processes, they are the launching card's shards and the senders every
// shard of the mesh. A sender's pointers then point into its own send
// buffers at the launch's first region (on its own card, or on a peer
// card), or, for a shard of another process, into the buffer that
// torch.distributed filled (parallel/collectives.py exchange_regions), so
// one launch places or folds the local, the peer and the remote rows alike.
// K5 takes its pointers in its launch parameters (ExchangeArgs, below), so
// its wrapper copies nothing to the device; K6 takes one packed table
// (below).
//
// What bounds both on this card: bytes. K5 reads and writes each live
// chunk once (a region's last chunk copies up to chunk - 1 rows of its
// padding); K6 reads each routed row's window id, values and masks once and
// writes each receiver's tables once. Neither computes more than a few
// operations per byte. Across cards, the rows a card reads from its peers
// cross NVLink (450 GB/s each way on the H100 SXM), a seventh of HBM's
// rate, so there the bound is the larger, over the cards, of their peer
// bytes over NVLink and their local bytes over HBM.
//
// * K5: one block of 256 threads per (chunk k, sender j, receiver i); a
//   block past ceil(sizes[j, i] / chunk) returns at once, so sizes is read
//   once per chunk and pair, not once per array. The block copies chunk k
//   of region i of sender j to region j of receiver i for every array of
//   the launch: the 16-byte words of all its aligned arrays form one range,
//   and each thread loads K5_UNROLL words of it before it stores them, so
//   a thread keeps that many loads in flight whatever the arrays' widths.
//   An array whose addresses are not 16-byte aligned is copied byte by
//   byte. Array a's receivers share one buffer, [n_recv][n_send *
//   split_cap]: receiver i's view starts at i * n_send * split_cap, so the
//   launch needs one receive base per array. Tails past sizes[j, i] are
//   not written: the receive validity is slot % split_cap < sizes[j, i],
//   so no validity rides the exchange. The parameter space holds
//   K5_MAX_SEND sender pointers; the wrapper splits a larger array list
//   over several launches.
// * K6: a grid of (B, n_recv receivers) blocks of DFT_FOLD_TPB threads;
//   B x n_recv blocks fill the SMs at the occupancy the tables' shared
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
//   the end; the last block decodes MIN/MAX and the float SUMs in place.
//   Op traits are K2 dense mode's: a float SUM in fixed point (six 32-bit
//   shared words a slot, after a first pass over the launch's routed rows
//   for its scale: reduce_common.cuh), i64 sums, i64 counts, MIN/MAX on the
//   order-preserving image. A mesh's float SUM takes one scale: where its
//   receivers take several launches (one per card or process), the C entry
//   runs the first pass alone (`phases` 1) on each, the wrapper writes the
//   largest scale word into every launch's, and the folds follow
//   (`phases` 2), so every card rounds each value on the same grid. Rows with a window id outside [0, num_groups)
//   are dropped; an op's mask pointer may be null (every routed row).

#include "reduce_common.cuh"

#include <stdint.h>

#define K5_THREADS 256
#define K5_UNROLL 4      // 16-byte loads a thread keeps in flight
#define K5_MAX_ARRS 16   // arrays per launch
#define K5_MAX_SEND 384  // sender pointers per launch: n_arrs * n_send
#define DFT_MAX_DEV 255  // n_send * n_recv pairs must fit gridDim.y

// K5's pointers, passed by value in the kernel's parameter space (3,272
// bytes, inside the classic 4 KB limit); mirrored in ragged_shuffle.py.
struct ExchangeArgs {
  const void* send[K5_MAX_SEND];  // array-major: array a of sender j at a * n_send + j
  void* recv[K5_MAX_ARRS];        // array a's receive buffer, [n_recv][n_send * split_cap]
  int esize[K5_MAX_ARRS];         // element widths: 1, 2, 4 or 8 bytes
  int n_arrs;
};

// --- K5 ragged exchange --------------------------------------------------------
__global__ void __launch_bounds__(K5_THREADS)
ragged_exchange_kernel(const ExchangeArgs X, const int* __restrict__ sizes, int n_send, int n_recv,
                       long long split_cap, int chunk) {
  __shared__ const uint4* s_src[K5_MAX_ARRS];
  __shared__ uint4* s_dst[K5_MAX_ARRS];
  __shared__ long long s_end[K5_MAX_ARRS];  // running sum of the aligned arrays' words
  __shared__ int s_n;
  const long long k = blockIdx.x;
  const int pair = blockIdx.y;  // j * n_recv + i
  const int j = pair / n_recv, i = pair % n_recv;
  if (k * chunk >= (long long)sizes[pair]) return;  // block-uniform: a dead chunk
  const long long src_row = (long long)i * split_cap + k * chunk;
  const long long dst_row = ((long long)i * n_send + j) * split_cap + k * chunk;
  if (threadIdx.x == 0) {
    long long end = 0;
    int m = 0;
    for (int a = 0; a < X.n_arrs; ++a) {
      const long long es = X.esize[a];
      const unsigned char* src = (const unsigned char*)X.send[a * n_send + j] + src_row * es;
      unsigned char* dst = (unsigned char*)X.recv[a] + dst_row * es;
      if ((((uintptr_t)src | (uintptr_t)dst) & 15) != 0) continue;  // the byte loop below
      end += chunk * es / 16;  // chunk >= 128 rows: whole words
      s_src[m] = (const uint4*)src;
      s_dst[m] = (uint4*)dst;
      s_end[m++] = end;
    }
    s_n = m;
  }
  __syncthreads();
  const int n_vec = s_n;
  const long long words = n_vec ? s_end[n_vec - 1] : 0;
  int m = 0;  // the array of this thread's current word; words only rise
  for (long long w0 = threadIdx.x; w0 < words; w0 += (long long)K5_THREADS * K5_UNROLL) {
    uint4 v[K5_UNROLL];
    uint4* d[K5_UNROLL];
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u) {
      const long long w = w0 + (long long)u * K5_THREADS;
      d[u] = nullptr;
      if (w < words) {
        while (w >= s_end[m]) ++m;
        const long long off = w - (m ? s_end[m - 1] : 0);
        v[u] = s_src[m][off];
        d[u] = s_dst[m] + off;
      }
    }
#pragma unroll
    for (int u = 0; u < K5_UNROLL; ++u)
      if (d[u]) *d[u] = v[u];
  }
  for (int a = 0; a < X.n_arrs; ++a) {  // unaligned arrays, byte by byte
    const long long es = X.esize[a];
    const unsigned char* src = (const unsigned char*)X.send[a * n_send + j] + src_row * es;
    unsigned char* dst = (unsigned char*)X.recv[a] + dst_row * es;
    if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) continue;
    for (long long b = threadIdx.x; b < chunk * es; b += K5_THREADS) dst[b] = src[b];
  }
}

// --- K6 ragged exchange + fold -------------------------------------------------
// sender j's window ids, and op a's values and mask, in the packed table
__device__ __forceinline__ const int* sender_gid(const long long* ptrs, int j) { return (const int*)ptrs[j]; }
__device__ __forceinline__ const void* sender_val(const long long* ptrs, int n_send, int a, int j) {
  return (const void*)ptrs[n_send + (long long)a * n_send + j];
}
__device__ __forceinline__ const uint8_t* sender_mask(const long long* ptrs, int n_send, int k, int a, int j) {
  return (const uint8_t*)ptrs[(long long)(1 + k + a) * n_send + j];
}

__global__ void __launch_bounds__(DFT_FOLD_TPB, 2)
ragged_exchange_fold_kernel(const long long* __restrict__ ptrs, const int* __restrict__ sizes, int n_send,
                            int n_recv, long long split_cap, int num_groups, int reps, FoldArgs ops, unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  const int i = blockIdx.y;  // the receiver
  const int k = ops.n;
  load_fold_shared(s, ops, false);
  fold_init(smem, ops.smem);
  const long long B = gridDim.x, b = blockIdx.x;
  long long toff = 0;  // tiles of the senders before j
  int steps = 0;
  for (int j = 0; j < n_send; ++j) {
    const long long cnt = sizes[(long long)j * n_recv + i];
    if (cnt == 0) continue;  // block-uniform
    __syncthreads();  // the previous sender's pointers are no longer read
    if (threadIdx.x < k) {  // sender j's values and masks, from the packed table
      s.val[threadIdx.x] = sender_val(ptrs, n_send, threadIdx.x, j);
      s.mask[threadIdx.x] = sender_mask(ptrs, n_send, k, threadIdx.x, j);
    }
    __syncthreads();
    const long long first = ((b - toff) % B + B) % B;  // this block's first tile of sender j
    fold_range(smem, k, ops.nfix, s, sender_gid(ptrs, j), (long long)i * split_cap, cnt, first, B, num_groups,
               reps, (long long)i * num_groups, steps);
    toff += (cnt + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  }
  __syncthreads();
  fold_finish(smem, k, s, (long long)i * num_groups, num_groups, reps, (long long)n_recv * num_groups, done);
}

// K6's first pass: each fixed-point float SUM's largest finite |value|
// among the launch's routed rows (every receiver's) with a window id in
// [0, num_groups) and its mask set, into its scale word; the grid and the
// walk over the senders' regions are the fold's, the ids read once.
__global__ void __launch_bounds__(DFT_FOLD_TPB)
ragged_scale_kernel(const long long* __restrict__ ptrs, const int* __restrict__ sizes, int n_send, int n_recv,
                    long long split_cap, int num_groups, FoldArgs ops) {
  __shared__ FoldShared s;
  const int i = blockIdx.y;
  const int k = ops.n;
  load_fold_shared(s, ops, false, false);
  const long long B = gridDim.x, b = blockIdx.x;
  unsigned long long best[DFT_MAX_FIX] = {};
  long long toff = 0;
  for (int j = 0; j < n_send; ++j) {
    const long long cnt = sizes[(long long)j * n_recv + i];
    if (cnt == 0) continue;  // block-uniform
    __syncthreads();  // the previous sender's pointers are no longer read
    if (threadIdx.x < k) {
      s.val[threadIdx.x] = sender_val(ptrs, n_send, threadIdx.x, j);
      s.mask[threadIdx.x] = sender_mask(ptrs, n_send, k, threadIdx.x, j);
    }
    __syncthreads();
    const long long tiles = (cnt + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
    for (long long t = ((b - toff) % B + B) % B; t < tiles; t += B) {
      long long r;
      int c, g[DFT_TILE], w[DFT_TILE];
      if (tile_slots(sender_gid(ptrs, j), (long long)i * split_cap, cnt, t, num_groups, r, c, g, w))
        tile_scales(s, ops.nfix, r, c, w, best);
    }
    toff += tiles;
  }
  __syncthreads();
  scale_flush(s, ops.nfix, best);
}

// --- C entries -------------------------------------------------------------------

// K5. x: the launch's pointers (ExchangeArgs; x->n_arrs * n_send <=
// K5_MAX_SEND); sizes: [n_send, n_recv] device int32 counts, each at most
// split_cap (the caller's contract). chunk is a power of two in
// [128, 1024] dividing split_cap.
extern "C" int dft_ragged_exchange(const ExchangeArgs* x, const int* sizes, int n_send, int n_recv,
                                   long long split_cap, int chunk, void* stream) {
  if (x->n_arrs == 0 || split_cap == 0) return 0;
  if (n_send < 1 || n_recv < 1 || (long long)n_send * n_recv > (long long)DFT_MAX_DEV * DFT_MAX_DEV ||
      x->n_arrs < 0 || x->n_arrs > K5_MAX_ARRS || x->n_arrs * n_send > K5_MAX_SEND || chunk < 128 || chunk > 1024 ||
      (chunk & (chunk - 1)) != 0 || split_cap < 0 || split_cap % chunk != 0 || split_cap / chunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int a = 0; a < x->n_arrs; ++a) {
    const int es = x->esize[a];
    if (es != 1 && es != 2 && es != 4 && es != 8) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned int)(split_cap / chunk), (unsigned int)(n_send * n_recv));
  ragged_exchange_kernel<<<grid, K5_THREADS, 0, (cudaStream_t)stream>>>(*x, sizes, n_send, n_recv, split_cap, chunk);
  return (int)cudaGetLastError();
}

extern "C" int dft_ragged_exchange_args_size() { return (int)sizeof(ExchangeArgs); }

// Let card `dev` read and write card `peer`'s memory (K5 and K6 read the
// senders' regions where they lie). Called once per ordered pair of cards;
// access that is on already (torch may have turned it on for its own peer
// copies) counts as success, and its error is cleared. A pair without a
// peer path fails with cudaErrorPeerAccessUnsupported: the rows are never
// staged through the host instead. The current device is kept.
extern "C" int dft_enable_peer_access(int dev, int peer) {
  if (dev == peer) return 0;
  int prev = 0, can = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it leaves for the next cudaGetLastError
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

// K6. n_ops ops (at most DFT_FOLD_MAX_OPS, whose tables fit shared
// memory). ptrs: one packed device table of (1 + 2 * n_ops) * n_send pointers:
// the senders' int32 window ids, then op a's values by sender (at
// (1 + a) * n_send), then op a's masks by sender (at (1 + n_ops + a) *
// n_send); values and masks may be 0. kinds: host array of op kinds
// (reduce_common.cuh, the fold tile's); outs: host array of op a's
// [n_recv, num_groups] device table (receiver i's row at i * num_groups; a
// float SUM's four such tables one after another);
// aux: host array of each float SUM's 8-byte scale word (null for other
// ops); `done` a device counter; all zeroed (reduce_common.cuh, the fold
// tile): op a's table ends as the op's output, as for K2 dense mode. Each
// slot is held `reps` times in shared memory. sizes as for K5. `phases`:
// bit 0 runs the first pass for the float SUMs' scale (where the launch
// has a float SUM), bit 1 the fold, both on the same grid; 3 runs both,
// one after the other. A mesh whose receivers take several launches (one
// per card or process) runs 1 on each, agrees on the scale, then 2
// (module doc).
extern "C" int dft_ragged_exchange_fold(const long long* ptrs, const int* sizes, int n_send, int n_recv,
                                        long long split_cap, int num_groups, int reps, int n_ops, const int* kinds,
                                        void* const* outs, void* const* aux, unsigned int* done, int phases,
                                        void* stream) {
  if (n_ops == 0 || split_cap == 0 || num_groups == 0) return 0;
  if (n_send < 1 || n_send > DFT_MAX_DEV || n_recv < 1 || n_recv > DFT_MAX_DEV || n_ops < 0 ||
      n_ops > DFT_FOLD_MAX_OPS || num_groups < 0 || num_groups > DFT_WINDOW || split_cap < 0 ||
      !dft_valid_reps(reps) || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  FoldArgs o;
  const void* none[DFT_FOLD_MAX_OPS] = {};
  if (!fold_args(&o, n_ops, kinds, none, (const uint8_t* const*)none, outs, aux, (long long)n_recv * num_groups,
                 true) ||
      (fold_has_fix(o) && (long long)n_send * split_cap > DFT_FIX_MAX_ROWS) ||  // a receiver's rows
      !fold_layout(&o, (long long)num_groups * reps))
    return (int)cudaErrorInvalidValue;
  const int smem = o.smem;
  cudaError_t err;
  const long long fill = fold_blocks(ragged_exchange_fold_kernel, smem, &err);
  if (err != cudaSuccess) return (int)err;
  // blocks per receiver: the card's share, and no more than its rows' tiles
  long long per = fill / n_recv;
  const long long most = ((long long)n_send * split_cap + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
  if (per > most) per = most;
  const long long rows = (long long)n_send * split_cap;  // the most one receiver gets
  if (per < rows / DFT_BLOCK_MAX_ROWS + 1) per = rows / DFT_BLOCK_MAX_ROWS + 1;
  const dim3 grid((unsigned int)per, (unsigned int)n_recv);
  if ((phases & 1) && fold_has_fix(o))
    ragged_scale_kernel<<<grid, DFT_FOLD_TPB, 0, (cudaStream_t)stream>>>(ptrs, sizes, n_send, n_recv, split_cap,
                                                                         num_groups, o);
  if (phases & 2)
    ragged_exchange_fold_kernel<<<grid, DFT_FOLD_TPB, smem, (cudaStream_t)stream>>>(ptrs, sizes, n_send, n_recv,
                                                                                     split_cap, num_groups, reps, o,
                                                                                     done);
  return (int)cudaGetLastError();
}
