// K3 — slab partition, and K4 — windowed reduce, for Hopper (sm_90a): the
// sort-free GROUP BY for key domains past K2's 2048-slot dense window
// ("bigdense").
//
// Replaces: datafusion_tpu/ops/pallas/partition.py
//   K3 `slab_partition` (:219) -> `_slab_partition` (:183), pallas_call at
//      :197, body `_slab_kernel` (:113)
//   K4 `windowed_reduce` (:368), pallas_call at :419, body
//      `_windowed_kernel` (:279)
// The TPU kernels permuted and reduced with one-hot MXU products, so every
// payload rode as f32 and had to be finite. Here K3 is a stable
// counting-sort scatter that moves each payload as raw bytes of its own
// width, and K4 reduces with atomics into shared-memory windows, with the
// op traits of K2 (reduce_common.cuh).
//
// What bounds both on this card: bytes. K3 reads the gid column twice
// (histogram, then scatter) and each payload once, and writes the slab,
// scap / pblock times the input rows. K4 reads the slab once. Neither does
// more than a few integer operations per byte.
//
// * K3: one block of 1024 threads per `pblock`-row input block (the last
//   one may be ragged). A shared-memory histogram of the rows' buckets
//   (bucket = (gid & (id_mod - 1)) / WINDOW) gives each bucket a segment
//   of the block's slab, starting on a SLAB_CHUNK boundary. The rows then
//   go in passes of 1024: `__match_any_sync` groups a warp's lanes by
//   bucket and the popcount below the lane is the lane's rank; one thread
//   per bucket scans the 32 warps' counts and carries a running count from
//   pass to pass. So the rank is stable (row order within a bucket), and
//   the slab is deterministic: equal, element for element, to the plain
//   version's. Gaps hold SENTINEL in the gid and zero bytes in payloads.
// * K4: one block of 256 threads per run of K4_RUN slab rows, one row per
//   thread per 256-row chunk. Each op keeps one 2048-slot window of its
//   table in dynamic shared memory (8 bytes a slot). A chunk's window base
//   is its least kept gid rounded down to WINDOW; the window is flushed to
//   the device table, one global atomic per touched slot, when the base
//   changes and at the end. A slab holds one bucket per chunk, in bucket
//   order per input block, so a block flushes a few windows. A row outside
//   its chunk's window (not produced by K3) goes to the device table by a
//   global atomic, so the result never depends on the layout. Rows with a
//   gid outside [0, num_groups) are dropped, SENTINEL gaps among them. All
//   ops are reduced in one launch.

#include "reduce_common.cuh"

#include <limits.h>

#define DFT_SLAB_CHUNK 256
#define DFT_SENTINEL (1 << 23)
#define DFT_MAX_BUCKETS 64
#define DFT_MAX_COLS 16
#define K3_THREADS 1024
#define K3_WARPS (K3_THREADS / 32)
#define K4_THREADS DFT_SLAB_CHUNK
#define K4_RUN 8192

// --- K3 slab partition -----------------------------------------------------
struct SlabCols {
  int n;
  int esize[DFT_MAX_COLS];
  const void* in[DFT_MAX_COLS];
  void* out[DFT_MAX_COLS];
};

__device__ __forceinline__ int bucket_of(int g, int id_mod, int n_buckets) {
  const int b = (g & (id_mod - 1)) / DFT_WINDOW;
  return b < n_buckets ? b : n_buckets - 1;  // ids past the buckets join the last one
}

__device__ __forceinline__ void copy_elem(void* out, long long d, const void* in, long long r, int esize) {
  switch (esize) {
    case 8: ((unsigned long long*)out)[d] = ((const unsigned long long*)in)[r]; break;
    case 4: ((unsigned int*)out)[d] = ((const unsigned int*)in)[r]; break;
    case 2: ((unsigned short*)out)[d] = ((const unsigned short*)in)[r]; break;
    default: ((unsigned char*)out)[d] = ((const unsigned char*)in)[r]; break;
  }
}

__device__ __forceinline__ void zero_elem(void* out, long long d, int esize) {
  switch (esize) {
    case 8: ((unsigned long long*)out)[d] = 0; break;
    case 4: ((unsigned int*)out)[d] = 0; break;
    case 2: ((unsigned short*)out)[d] = 0; break;
    default: ((unsigned char*)out)[d] = 0; break;
  }
}

__global__ void __launch_bounds__(K3_THREADS)
slab_partition_kernel(const int* __restrict__ gid, int* __restrict__ out_gid, long long n, int id_mod,
                      int n_buckets, int pblock, int scap, SlabCols cols) {
  __shared__ int s_count[DFT_MAX_BUCKETS];
  __shared__ int s_seg[DFT_MAX_BUCKETS + 1];
  __shared__ int s_run[DFT_MAX_BUCKETS];
  __shared__ int s_wcnt[K3_WARPS][DFT_MAX_BUCKETS];
  __shared__ int s_woff[K3_WARPS][DFT_MAX_BUCKETS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * pblock;
  const long long r1 = r0 + pblock < n ? r0 + pblock : n;
  const long long s0 = (long long)blockIdx.x * scap;

  for (int i = tid; i < K3_WARPS * DFT_MAX_BUCKETS; i += K3_THREADS) (&s_wcnt[0][0])[i] = 0;
  if (tid < n_buckets) {
    s_count[tid] = 0;
    s_run[tid] = 0;
  }
  __syncthreads();

  // 1. bucket histogram of the block's rows: one shared atomic per bucket
  //    and warp, so a skewed bucket does not serialise its lanes
  for (long long base = r0; base < r1; base += K3_THREADS) {
    const long long r = base + tid;
    const int b = r < r1 ? bucket_of(gid[r], id_mod, n_buckets) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && (peers & ((1u << lane) - 1u)) == 0) atomicAdd(&s_count[b], __popc(peers));
  }
  __syncthreads();

  // 2. segment starts: exclusive scan of the counts rounded up to SLAB_CHUNK
  if (tid == 0) {
    int acc = 0;
    for (int b = 0; b < n_buckets; ++b) {
      s_seg[b] = acc;
      acc += (s_count[b] + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK * DFT_SLAB_CHUNK;
    }
    s_seg[n_buckets] = acc;
  }
  __syncthreads();

  // gaps: each segment's alignment tail, then the slab's tail
  for (int b = 0; b <= n_buckets; ++b) {
    const int lo = b < n_buckets ? s_seg[b] + s_count[b] : s_seg[n_buckets];
    const int hi = b < n_buckets ? s_seg[b + 1] : scap;
    for (int p = lo + tid; p < hi; p += K3_THREADS) {
      out_gid[s0 + p] = DFT_SENTINEL;
      for (int c = 0; c < cols.n; ++c) zero_elem(cols.out[c], s0 + p, cols.esize[c]);
    }
  }

  // 3-4. stable rank within the bucket, one 1024-row pass at a time, and scatter
  for (long long base = r0; base < r1; base += K3_THREADS) {
    const long long r = base + tid;
    const bool valid = r < r1;
    const int g = valid ? gid[r] : 0;
    const int b = valid ? bucket_of(g, id_mod, n_buckets) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int wrank = __popc(peers & ((1u << lane) - 1u));
    if (valid && wrank == 0) s_wcnt[warp][b] = __popc(peers);
    __syncthreads();
    if (tid < n_buckets) {  // per bucket: offsets of the warps' runs, in warp order
      int acc = s_run[tid];
      for (int w = 0; w < K3_WARPS; ++w) {
        s_woff[w][tid] = acc;
        acc += s_wcnt[w][tid];
      }
      s_run[tid] = acc;
    }
    __syncthreads();
    if (valid) {
      const long long d = s0 + s_seg[b] + s_woff[warp][b] + wrank;
      if (wrank == 0) s_wcnt[warp][b] = 0;  // clean for the next pass
      out_gid[d] = g;
      for (int c = 0; c < cols.n; ++c) copy_elem(cols.out[c], d, cols.in[c], r, cols.esize[c]);
    }
    __syncwarp();
  }
}

// --- K4 windowed reduce ----------------------------------------------------
struct WinOps {
  int n;
  int kinds[DFT_MAX_OPS];
  const void* vals[DFT_MAX_OPS];
  const uint8_t* masks[DFT_MAX_OPS];
  void* outs[DFT_MAX_OPS];
};

__global__ void __launch_bounds__(K4_THREADS)
windowed_reduce_kernel(const int* __restrict__ gid, long long n, int num_groups, WinOps ops) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_min[K4_THREADS / 32];
  __shared__ int s_base;
  for (int a = 0; a < ops.n; ++a) {
    DFT_DISPATCH_KIND(ops.kinds[a], win_init, smem + a * WIN_BYTES, DFT_WINDOW)
  }
  const long long r0 = (long long)blockIdx.x * K4_RUN;
  const long long r1 = r0 + K4_RUN < n ? r0 + K4_RUN : n;
  int cur = -1;  // base of the windows now held; block-uniform
  for (long long c0 = r0; c0 < r1; c0 += K4_THREADS) {
    const long long r = c0 + threadIdx.x;
    const int g = r < r1 ? gid[r] : -1;
    const bool keep = g >= 0 && g < num_groups;
    int m = keep ? g : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      int mm = s_min[0];
      for (int w = 1; w < K4_THREADS / 32; ++w) mm = min(mm, s_min[w]);
      s_base = mm == INT_MAX ? -1 : mm / DFT_WINDOW * DFT_WINDOW;
    }
    __syncthreads();
    const int base = s_base;
    if (base < 0) continue;  // nothing kept in this chunk
    if (base != cur) {
      if (cur >= 0) {
        for (int a = 0; a < ops.n; ++a) {
          DFT_DISPATCH_KIND(ops.kinds[a], win_flush, smem + a * WIN_BYTES, ops.outs[a], cur, DFT_WINDOW)
        }
        __syncthreads();
      }
      cur = base;
    }
    if (keep) {
      for (int a = 0; a < ops.n; ++a) {
        DFT_DISPATCH_KIND(ops.kinds[a], win_add, smem + a * WIN_BYTES, ops.outs[a], ops.vals[a], ops.masks[a],
                          r, g, g - base)
      }
    }
  }
  __syncthreads();
  if (cur >= 0) {
    for (int a = 0; a < ops.n; ++a) {
      DFT_DISPATCH_KIND(ops.kinds[a], win_flush, smem + a * WIN_BYTES, ops.outs[a], cur, DFT_WINDOW)
    }
  }
}

// --- C entries ---------------------------------------------------------------

// K3. out_gid and outs[c] are [ceil(n / pblock) * scap] device buffers;
// esizes[c] is the byte width of payload c (1, 2, 4 or 8).
extern "C" int dft_slab_partition(const int* gid, int* out_gid, long long n, int id_mod, int n_buckets, int pblock,
                                  int scap, int n_cols, const int* esizes, const void* const* ins,
                                  void* const* outs, void* stream) {
  if (n <= 0) return 0;
  if (n_buckets < 1 || n_buckets > DFT_MAX_BUCKETS || n_cols < 0 || n_cols > DFT_MAX_COLS || pblock <= 0 ||
      id_mod <= 0 || (id_mod & (id_mod - 1)) != 0 || scap < pblock + n_buckets * DFT_SLAB_CHUNK)
    return (int)cudaErrorInvalidValue;
  SlabCols c;
  c.n = n_cols;
  for (int i = 0; i < n_cols; ++i) {
    const int e = esizes[i];
    if (e != 1 && e != 2 && e != 4 && e != 8) return (int)cudaErrorInvalidValue;
    c.esize[i] = e;
    c.in[i] = ins[i];
    c.out[i] = outs[i];
  }
  const long long blocks = (n + pblock - 1) / pblock;
  slab_partition_kernel<<<(unsigned int)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      gid, out_gid, n, id_mod, n_buckets, pblock, scap, c);
  return (int)cudaGetLastError();
}

// K4. Same op contract as dft_segreduce: kinds[a] selects the op kind,
// vals[a] / masks[a] / outs[a] are device pointers (vals/masks may be
// null), and the output tables arrive initialised to each op's identity.
extern "C" int dft_windowed_reduce(const int* gid, long long n, int num_groups, int n_ops, const int* kinds,
                                   const void* const* vals, const uint8_t* const* masks, void* const* outs,
                                   void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  if (n_ops < 0 || n_ops > DFT_MAX_OPS) return (int)cudaErrorInvalidValue;
  WinOps o;
  o.n = n_ops;
  for (int a = 0; a < n_ops; ++a) {
    if (!dft_valid_kind(kinds[a])) return (int)cudaErrorInvalidValue;
    o.kinds[a] = kinds[a];
    o.vals[a] = vals[a];
    o.masks[a] = masks[a];
    o.outs[a] = outs[a];
  }
  // always: the block's static arrays count against the same limit, so 48 KB
  // of windows alone already passes the default
  const int smem = n_ops * WIN_BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(windowed_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + K4_RUN - 1) / K4_RUN;
  windowed_reduce_kernel<<<(unsigned int)blocks, K4_THREADS, smem, (cudaStream_t)stream>>>(gid, n, num_groups, o);
  return (int)cudaGetLastError();
}
