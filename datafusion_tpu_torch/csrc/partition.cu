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
// width, and K4 reduces into shared-memory windows with the fold tile of
// K2 and K6 (reduce_common.cuh).
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
// * K4: a grid of (part, bucket) blocks of 512 threads. Block (p, b) holds
//   bucket b's DFT_WINDOW-slot window of every op in shared memory, in
//   the fold tile's zero-identity form (reduce_common.cuh: 32-bit COUNT,
//   i64 SUM, a float SUM's three int64 digits and its flags, MIN/MAX on
//   the unsigned order-preserving image), and folds
//   every chunk of bucket b in part p, a run of consecutive SLAB_CHUNK-row
//   chunks; then it flushes the window to the device table once, and the
//   last block decodes MIN/MAX and the float SUMs in place (a float SUM
//   is three windows in fixed point, after a first pass over the rows for
//   its scale: reduce_common.cuh). A chunk belongs to the bucket of
//   its first row's id (id / WINDOW, when that lies in [0, buckets x
//   WINDOW)), and to bucket 0 otherwise (a SENTINEL gap, a negative id).
//   A pass reads 512 chunk heads, one a thread, lists the bucket's chunks in
//   shared memory, and folds them with the fold tile, 64 threads a chunk
//   and 4 rows a thread (vector loads, one kind switch per tile and op,
//   equal neighbouring ids combined in registers). A row whose id lies
//   outside the block's window goes to the device table by a global atomic,
//   and a row with an id outside [0, num_groups) is dropped (SENTINEL gaps
//   among them), so any row order gives the same result; K3's layout is
//   what keeps every row in its window. Parts per bucket: as many as the
//   card holds blocks at the occupancy the windows allow (fold_blocks), so
//   a bucket that takes most of the rows is still folded by every SM, and
//   a window folds thousands of rows between its init and its one flush.
//   The ids are read once, plus one chunk head in 256 per bucket.

#include "reduce_common.cuh"

#define DFT_SLAB_CHUNK 256
#define DFT_SENTINEL (1 << 23)
#define DFT_MAX_BUCKETS 64
#define DFT_MAX_COLS 16
#define K3_THREADS 1024
#define K3_WARPS (K3_THREADS / 32)
#define K4_HEADS DFT_FOLD_TPB                       // chunk heads a K4 block reads per pass
#define K4_CHUNK_THREADS (DFT_SLAB_CHUNK / DFT_TILE)  // K4 threads that fold one chunk
#define K4_GROUPS (DFT_FOLD_TPB / K4_CHUNK_THREADS)   // chunks a K4 block folds at once

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
// a chunk's bucket, from its first row's id
__device__ __forceinline__ int chunk_bucket(int g, int n_buckets) {
  return g >= 0 && g < n_buckets * DFT_WINDOW ? g / DFT_WINDOW : 0;
}

// MINB blocks an SM, as many as the windows' shared memory lets fit
// (three: at most 40 registers, more warps' loads in flight; two or one
// for a launch whose float SUMs take three windows each)
template <int MINB>
__global__ void __launch_bounds__(DFT_FOLD_TPB, MINB)
windowed_reduce_kernel(const int* __restrict__ gid, long long n, int num_groups, long long part_chunks, FoldArgs ops,
                       unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  __shared__ unsigned short s_list[K4_HEADS];  // this pass's chunks of the bucket, relative to the pass
  __shared__ int s_n;
  const int b = blockIdx.y, n_buckets = gridDim.y;
  const int base = b * DFT_WINDOW;
  const int tbl_bytes = DFT_WINDOW * 8;
  load_fold_shared(s, ops);
  fold_init(smem, ops.ntbl * tbl_bytes);
  const long long chunks = (n + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK;
  const long long c0 = (long long)blockIdx.x * part_chunks;
  const long long c1 = c0 + part_chunks < chunks ? c0 + part_chunks : chunks;
  const int group = threadIdx.x / K4_CHUNK_THREADS;
  const long long lane_row = (long long)(threadIdx.x % K4_CHUNK_THREADS) * DFT_TILE;
  for (long long p = c0; p < c1; p += K4_HEADS) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    // 1. one chunk head a thread: the pass's chunks of bucket b, in any order
    const long long head = p + threadIdx.x;
    if (head < c1 && chunk_bucket(__ldg(gid + head * DFT_SLAB_CHUNK), n_buckets) == b)
      s_list[atomicAdd(&s_n, 1)] = (unsigned short)threadIdx.x;
    __syncthreads();
    // 2. K4_CHUNK_THREADS threads a chunk, DFT_TILE rows each
    const int cnt = s_n;
    for (int i = group; i < cnt; i += K4_GROUPS) {
      const long long r = (p + s_list[i]) * DFT_SLAB_CHUNK + lane_row;
      const int c = r >= n ? 0 : n - r < DFT_TILE ? (int)(n - r) : DFT_TILE;
      fold_window_tile(smem, tbl_bytes, ops.n, s, gid, r, c, base, num_groups);
    }
    __syncthreads();  // the list is read before the next pass writes it
  }
  __syncthreads();
  const int slots = num_groups - base < DFT_WINDOW ? num_groups - base : DFT_WINDOW;
  fold_flush(smem, tbl_bytes, ops.n, s, base, slots, 1, num_groups, done);
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

// K4. kinds, vals, masks and aux as for dft_segreduce_dense; outs[a] is
// op a's [num_groups] device table (a float SUM's four, one after
// another) and `done` a device counter, all
// zeroed (reduce_common.cuh, the fold tile): op a's table ends as the op's
// output, as for K2. With a float SUM, the first pass for its scale runs
// before the fold.
extern "C" int dft_windowed_reduce(const int* gid, long long n, int num_groups, int n_ops, const int* kinds,
                                   const void* const* vals, const uint8_t* const* masks, void* const* outs,
                                   void* const* aux, unsigned int* done, void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  FoldArgs o;
  if (num_groups > 65535 * DFT_WINDOW || !fold_args(&o, n_ops, kinds, vals, masks, outs, aux, num_groups, true) ||
      o.ntbl > DFT_MAX_OPS || (fold_has_fix(o) && n > DFT_FIX_MAX_ROWS))
    return (int)cudaErrorInvalidValue;
  const int n_buckets = (num_groups + DFT_WINDOW - 1) / DFT_WINDOW;
  const int smem = o.ntbl * DFT_WINDOW * 8;
  void (*kernel)(const int*, long long, int, long long, FoldArgs, unsigned int*) =
      o.ntbl <= 4 ? windowed_reduce_kernel<3> : o.ntbl <= 7 ? windowed_reduce_kernel<2> : windowed_reduce_kernel<1>;
  cudaError_t err;
  const long long fill = fold_blocks(kernel, smem, &err);
  if (err != cudaSuccess) return (int)err;
  // parts per bucket: as many as the card holds blocks at once, so that a
  // bucket that takes most rows (skew) is still folded by the whole card;
  // at least one chunk each, and fewer than 2^31 rows each (COUNT's shared
  // counters)
  const long long chunks = (n + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK;
  long long parts = fill;
  if (parts > chunks) parts = chunks;
  const long long least = chunks * DFT_SLAB_CHUNK / DFT_BLOCK_MAX_ROWS + 1;
  if (parts < least) parts = least;
  const long long part_chunks = (chunks + parts - 1) / parts;
  parts = (chunks + part_chunks - 1) / part_chunks;
  if (fold_has_fix(o)) {
    const long long tiles = (n + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
    long long sblocks = fold_blocks(fold_scale_kernel, 0, &err);
    if (err != cudaSuccess) return (int)err;
    if (sblocks > tiles) sblocks = tiles;
    fold_scale_kernel<<<(unsigned int)sblocks, DFT_FOLD_TPB, 0, (cudaStream_t)stream>>>(gid, n, num_groups, o);
  }
  const dim3 grid((unsigned int)parts, (unsigned int)n_buckets);
  kernel<<<grid, DFT_FOLD_TPB, smem, (cudaStream_t)stream>>>(gid, n, num_groups, part_chunks, o, done);
  return (int)cudaGetLastError();
}
