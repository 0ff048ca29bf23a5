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
// (histogram, then scatter) and each payload once (a float SUM's payload
// again from L1 for its scale word), and writes the slab, scap / pblock
// times the input rows. K4 reads the slab once. Neither does more than a
// few integer operations per byte.
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
//   Where the caller names float SUMs (`info`), K3 also leaves each one's
//   scale word, the largest finite |value| of its payload over its kept
//   rows (a warp's max by one reduction, a block's in shared memory, the
//   launch's by one global max a block), and each bucket's chunk count:
//   K4 then needs no first pass, and splits its blocks by the counts.
// * K4: blocks of 512 threads, each with one bucket b's DFT_WINDOW-slot
//   window of every op in shared memory, in the fold tile's zero-identity
//   form (reduce_common.cuh: 32-bit COUNT, i64 SUM, a float SUM's six
//   32-bit words and its flags, MIN/MAX on the unsigned order-preserving
//   image). A block folds every chunk of bucket b in its part of the slab,
//   a run of consecutive SLAB_CHUNK-row chunks, then flushes the window to
//   the device table once, and the last block decodes MIN/MAX and the
//   float SUMs in place. A chunk belongs to the bucket of its first row's
//   id (id / WINDOW, when that lies in [0, buckets x WINDOW)), and to
//   bucket 0 otherwise (a SENTINEL gap, a negative id). A pass reads 512
//   chunk heads, one a thread, lists the bucket's chunks in shared memory,
//   and folds them with the fold tile, 64 threads a chunk and 4 rows a
//   thread (vector loads, one kind switch per tile and op, equal
//   neighbouring ids combined in registers). A row whose id lies outside
//   the block's window goes to the device table by a global atomic, and a
//   row with an id outside [0, num_groups) is dropped (SENTINEL gaps among
//   them), so any row order gives the same result; K3's layout is what
//   keeps every row in its window.
//   - Over K3's slab as K3 left it (dft_windowed_reduce_slab, the main
//     path): the gid still packed (an id below id_mod, each op's mask one
//     of its bits), the float SUMs' scale words K3's, and one grid of
//     K4_WAVES times what the card holds at once, whose blocks go to the
//     buckets in proportion to K3's chunk counts: a bucket that takes most
//     rows is still folded by most of the card, and a window folds tens of
//     thousands of rows between its init and its one flush.
//   - Alone (dft_windowed_reduce): ids and mask streams as given, a first
//     pass for the float SUMs' scale, and every bucket over the whole
//     card's blocks.
//   The ids are read once, plus one chunk head in 256 per bucket's block.

#include "reduce_common.cuh"

#define DFT_SLAB_CHUNK 256
#define DFT_SENTINEL (1 << 23)
#define DFT_MAX_BUCKETS 64
#define DFT_MAX_COLS 16
#define K3_THREADS 1024
#define K3_WARPS (K3_THREADS / 32)
#define K4_WAVES 2  // K4's grid over K3's counts: waves of the card (one waits on its slowest block)
#define K3_MAX_SCALES DFT_MAX_OPS  // scale words a K3 launch leaves: one per float SUM of a K4 call
#define K4_HEADS DFT_FOLD_TPB                       // chunk heads a K4 block reads per pass
#define K4_CHUNK_THREADS (DFT_SLAB_CHUNK / DFT_TILE)  // K4 threads that fold one chunk
#define K4_GROUPS (DFT_FOLD_TPB / K4_CHUNK_THREADS)   // chunks a K4 block folds at once

// --- K3 slab partition -----------------------------------------------------
struct SlabCols {
  int n;
  int esize[DFT_MAX_COLS];
  const void* in[DFT_MAX_COLS];
  void* out[DFT_MAX_COLS];
  // what K3 leaves for K4 (null: nothing): scale word j of payload
  // scale_col[j] (4 bytes f32, 8 bytes f64) over the rows whose id lies
  // below num_groups and whose gid bit scale_bit[j] is set (-1: every
  // such row), then each bucket's chunk count
  unsigned long long* info;
  int num_groups, n_scales;
  int scale_col[K3_MAX_SCALES];
  int scale_bit[K3_MAX_SCALES];
};

__device__ __forceinline__ int bucket_of(int g, int id_mod, int n_buckets) {
  const int b = (g & (id_mod - 1)) / DFT_WINDOW;
  return b < n_buckets ? b : n_buckets - 1;  // ids past the buckets join the last one
}

__device__ __forceinline__ unsigned long long load_elem(const void* in, long long r, int esize) {
  switch (esize) {
    case 8: return ((const unsigned long long*)in)[r];
    case 4: return ((const unsigned int*)in)[r];
    case 2: return ((const unsigned short*)in)[r];
    default: return ((const unsigned char*)in)[r];
  }
}

__device__ __forceinline__ void copy_elem(void* out, long long d, const void* in, long long r, int esize) {
  switch (esize) {
    case 8: ((unsigned long long*)out)[d] = ((const unsigned long long*)in)[r]; break;
    case 4: ((unsigned int*)out)[d] = ((const unsigned int*)in)[r]; break;
    case 2: ((unsigned short*)out)[d] = ((const unsigned short*)in)[r]; break;
    default: ((unsigned char*)out)[d] = ((const unsigned char*)in)[r]; break;
  }
}

// a float payload's value as f64 from its bits (4 bytes: f32)
__device__ __forceinline__ double elem_value(unsigned long long v, int esize) {
  if (esize == 8) return __longlong_as_double((long long)v);
  float f;
  const unsigned int u = (unsigned int)v;
  memcpy(&f, &u, 4);
  return (double)f;
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
  __shared__ unsigned int s_best[K3_MAX_SCALES];  // the scale words' high words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * pblock;
  const long long r1 = r0 + pblock < n ? r0 + pblock : n;
  const long long s0 = (long long)blockIdx.x * scap;

  for (int i = tid; i < K3_WARPS * DFT_MAX_BUCKETS; i += K3_THREADS) (&s_wcnt[0][0])[i] = 0;
  if (tid < n_buckets) {
    s_count[tid] = 0;
    s_run[tid] = 0;
  }
  if (tid < K3_MAX_SCALES) s_best[tid] = 0;
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

  // each bucket's chunks in this block's slab, for K4's split
  if (cols.info != nullptr && tid < n_buckets && s_count[tid] > 0)
    dft_red_add(cols.info + cols.n_scales + tid, (s_count[tid] + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK);

  // gaps: each segment's alignment tail, then the slab's tail
  for (int b = 0; b <= n_buckets; ++b) {
    const int lo = b < n_buckets ? s_seg[b] + s_count[b] : s_seg[n_buckets];
    const int hi = b < n_buckets ? s_seg[b + 1] : scap;
    for (int p = lo + tid; p < hi; p += K3_THREADS) {
      out_gid[s0 + p] = DFT_SENTINEL;
      for (int c = 0; c < cols.n; ++c) zero_elem(cols.out[c], s0 + p, cols.esize[c]);
    }
  }

  // 3-4. stable rank within the bucket, one 1024-row pass at a time, and
  // scatter; each requested float SUM's largest finite |value| on the way,
  // by warp and then block, as the high word of its bits (the word's
  // exponent is all K4 reads)
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
    for (int j = 0; j < cols.n_scales; ++j) {  // the payload again, from L1
      const int c = cols.scale_col[j], bit = cols.scale_bit[j];
      unsigned int hi = 0;
      if (valid && (g & (id_mod - 1)) < cols.num_groups && (bit < 0 || ((g >> bit) & 1)))
        hi = (unsigned int)(finite_abs_bits(elem_value(load_elem(cols.in[c], r, cols.esize[c]), cols.esize[c])) >> 32);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0 && hi) atomicMax(&s_best[j], hi);
    }
    __syncwarp();
  }
  __syncthreads();
  if (tid < cols.n_scales && s_best[tid]) dft_red_max(cols.info + tid, (unsigned long long)s_best[tid] << 32);
}

// --- K4 windowed reduce ----------------------------------------------------
// A row's id: below id_mod where the gid is packed (id_mod > 0; a gap's
// SENTINEL stays itself), else the gid as given.
__device__ __forceinline__ int row_id(int g, int id_mod) {
  return id_mod > 0 && g >= 0 && g < DFT_SENTINEL ? g & (id_mod - 1) : g;
}

// a chunk's bucket, from its first row's id
__device__ __forceinline__ int chunk_bucket(int g, int n_buckets, int id_mod) {
  g = row_id(g, id_mod);
  return g >= 0 && g < n_buckets * DFT_WINDOW ? g / DFT_WINDOW : 0;
}

// Block i's work among F blocks: (bucket, part, parts), the bucket -1 for
// none. Without K3's chunk counts every bucket takes F / n_buckets parts
// (the grid is that times n_buckets); with them, each bucket that has
// chunks takes one part plus its share of the rest in proportion to its
// chunks, so a bucket that holds most rows is still folded by most blocks.
__device__ __forceinline__ void k4_work(int i, int F, int n_buckets, const unsigned long long* counts, int* out) {
  out[0] = -1;
  out[1] = 0;
  out[2] = 1;
  if (counts == nullptr) {
    const int parts = F / n_buckets;
    out[0] = i / parts;
    out[1] = i % parts;
    out[2] = parts;
    return;
  }
  unsigned long long total = 0;
  int live = 0;
  for (int b = 0; b < n_buckets; ++b) {
    total += counts[b];
    live += counts[b] > 0;
  }
  int first = 0;
  for (int b = 0; b < n_buckets; ++b) {
    if (counts[b] == 0) continue;
    const int parts = 1 + (int)((unsigned long long)(F - live) * counts[b] / total);
    if (i < first + parts) {
      out[0] = b;
      out[1] = i - first;
      out[2] = parts;
      return;
    }
    first += parts;
  }
}

// One thread's tile, rows r .. r + c - 1, into the block's tables of the
// window [base, base + DFT_WINDOW) (one replica): a row whose id lies in
// [0, num_groups) but outside the window goes to the device table by a
// global atomic (a float SUM's flags do always), and any other row is
// dropped.
__device__ __forceinline__ void fold_window_tile(unsigned char* smem, int n_ops, const FoldShared& s,
                                                 const int* __restrict__ gid, long long r, int c, int base,
                                                 int num_groups) {
  int g[DFT_TILE], w[DFT_TILE], far[DFT_TILE];
  load_tile(gid, r, c, g);
#pragma unroll
  for (int k = 0; k < DFT_TILE; ++k) {
    const int id = row_id(g[k], s.id_mod);
    const bool keep = k < c && id >= 0 && id < num_groups;
    const bool in = keep && id >= base && id - base < DFT_WINDOW;
    far[k] = keep && !in ? id : -1;
    w[k] = in ? id - base : -1;
  }
  fold_tile(smem, n_ops, s, base, 1, 0, r, c, g, w, far);
}

// MINB blocks an SM: two where the windows' shared memory lets two fit
// (at most 64 registers), else one
template <int MINB>
__global__ void __launch_bounds__(DFT_FOLD_TPB, MINB)
windowed_reduce_kernel(const int* __restrict__ gid, long long n, int num_groups, int n_buckets,
                       const unsigned long long* __restrict__ bucket_chunks, FoldArgs ops, unsigned int* done) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ FoldShared s;
  __shared__ unsigned short s_list[K4_HEADS];  // this pass's chunks of the bucket, relative to the pass
  __shared__ int s_n, s_work[3];
  load_fold_shared(s, ops);
  if (threadIdx.x == 0) k4_work(blockIdx.x, gridDim.x, n_buckets, bucket_chunks, s_work);
  fold_init(smem, ops.smem);
  __syncthreads();
  const int b = s_work[0];
  if (b >= 0) {  // block-uniform
    const int base = b * DFT_WINDOW;
    const long long chunks = (n + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK;
    const long long c0 = chunks * s_work[1] / s_work[2], c1 = chunks * (s_work[1] + 1) / s_work[2];
    const int group = threadIdx.x / K4_CHUNK_THREADS;
    const long long lane_row = (long long)(threadIdx.x % K4_CHUNK_THREADS) * DFT_TILE;
    int steps = 0;
    for (long long p = c0; p < c1; p += K4_HEADS) {
      if (threadIdx.x == 0) s_n = 0;
      __syncthreads();
      // 1. one chunk head a thread: the pass's chunks of bucket b, in any order
      const long long head = p + threadIdx.x;
      if (head < c1 && chunk_bucket(__ldg(gid + head * DFT_SLAB_CHUNK), n_buckets, s.id_mod) == b)
        s_list[atomicAdd(&s_n, 1)] = (unsigned short)threadIdx.x;
      __syncthreads();
      // 2. K4_CHUNK_THREADS threads a chunk, DFT_TILE rows each; a step of the
      //    block is DFT_TILE_ROWS rows
      const int cnt = s_n;
      for (int i0 = 0; i0 < cnt; i0 += K4_GROUPS) {
        const int i = i0 + group;
        if (i < cnt) {
          const long long r = (p + s_list[i]) * DFT_SLAB_CHUNK + lane_row;
          const int c = r >= n ? 0 : n - r < DFT_TILE ? (int)(n - r) : DFT_TILE;
          fold_window_tile(smem, ops.n, s, gid, r, c, base, num_groups);
        }
        fold_step(smem, s, ops.nfix, base, 1, steps);
      }
      __syncthreads();  // the list is read before the next pass writes it
    }
    __syncthreads();
    fold_flush(smem, ops.n, s, base, num_groups - base < DFT_WINDOW ? num_groups - base : DFT_WINDOW, 1);
  }
  if (fold_last(done)) fold_decode(ops.n, s, num_groups);
}

// --- C entries ---------------------------------------------------------------

// K3. out_gid and outs[c] are [ceil(n / pblock) * scap] device buffers;
// esizes[c] is the byte width of payload c (1, 2, 4 or 8). With `info`
// (a zeroed device array of n_scales + n_buckets words; null: none), K3
// also leaves there, for each j < n_scales, the high 32 bits (the rest 0)
// of the bits of the largest finite |value| of payload scale_cols[j] (a
// float: 4 bytes f32, 8 bytes f64) over the rows whose id (gid & (id_mod
// - 1)) lies below num_groups and whose gid bit scale_bits[j] is set (-1:
// every such row): K4's scale word for that float SUM, whose exponent is
// the first pass's; then each bucket's chunk count over the slab.
extern "C" int dft_slab_partition(const int* gid, int* out_gid, long long n, int id_mod, int n_buckets, int pblock,
                                  int scap, int n_cols, const int* esizes, const void* const* ins,
                                  void* const* outs, unsigned long long* info, int num_groups, int n_scales,
                                  const int* scale_cols, const int* scale_bits, void* stream) {
  if (n <= 0) return 0;
  if (n_buckets < 1 || n_buckets > DFT_MAX_BUCKETS || n_cols < 0 || n_cols > DFT_MAX_COLS || pblock <= 0 ||
      id_mod <= 0 || (id_mod & (id_mod - 1)) != 0 || scap < pblock + n_buckets * DFT_SLAB_CHUNK ||
      n_scales < 0 || n_scales > K3_MAX_SCALES || (n_scales > 0 && info == nullptr))
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
  c.info = info;
  c.num_groups = num_groups;
  c.n_scales = n_scales;
  for (int j = 0; j < n_scales; ++j) {
    const int col = scale_cols[j], bit = scale_bits[j];
    if (col < 0 || col >= n_cols || (esizes[col] != 4 && esizes[col] != 8) || bit < -1 || bit > 30)
      return (int)cudaErrorInvalidValue;
    c.scale_col[j] = col;
    c.scale_bit[j] = bit;
  }
  const long long blocks = (n + pblock - 1) / pblock;
  slab_partition_kernel<<<(unsigned int)blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      gid, out_gid, n, id_mod, n_buckets, pblock, scap, c);
  return (int)cudaGetLastError();
}

// K4 over `n` rows, either entry's work: ids packed below id_mod (0: as
// given), op a's mask as gid bit mask_bits[a] where mask_bits is given
// (masks[a] then null), and with bucket_chunks (K3's chunk counts) the
// split in proportion to them and the float SUMs' scale words K3 left in
// aux; without, every bucket over the card and the first pass for the
// scale words.
static int windowed_reduce(const int* gid, long long n, int num_groups, int id_mod, int n_ops, const int* kinds,
                           const void* const* vals, const uint8_t* const* masks, const int* mask_bits,
                           void* const* outs, void* const* aux, unsigned int* done,
                           const unsigned long long* bucket_chunks, void* stream) {
  if (n <= 0 || num_groups <= 0 || n_ops == 0) return 0;
  FoldArgs o;
  if (num_groups > 65535 * DFT_WINDOW || !fold_args(&o, n_ops, kinds, vals, masks, outs, aux, num_groups, true) ||
      o.ntbl > DFT_MAX_OPS || (fold_has_fix(o) && n > DFT_FIX_MAX_ROWS) || !fold_layout(&o, DFT_WINDOW) ||
      (id_mod != 0 && ((id_mod & (id_mod - 1)) != 0 || id_mod <= num_groups || id_mod > DFT_SENTINEL)))
    return (int)cudaErrorInvalidValue;
  o.id_mod = id_mod;
  for (int a = 0; mask_bits != nullptr && a < n_ops; ++a) {
    if (mask_bits[a] >= 0 && (masks[a] != nullptr || (1LL << mask_bits[a]) < id_mod || mask_bits[a] > 22))
      return (int)cudaErrorInvalidValue;
    o.mbit[a] = mask_bits[a];
  }
  const int n_buckets = (num_groups + DFT_WINDOW - 1) / DFT_WINDOW;
  void (*kernel)(const int*, long long, int, int, const unsigned long long*, FoldArgs, unsigned int*) =
      o.smem <= 110 * 1024 ? windowed_reduce_kernel<2> : windowed_reduce_kernel<1>;
  cudaError_t err;
  const long long fill = fold_blocks(kernel, o.smem, &err);
  if (err != cudaSuccess) return (int)err;
  const long long chunks = (n + DFT_SLAB_CHUNK - 1) / DFT_SLAB_CHUNK;
  long long blocks;
  if (bucket_chunks != nullptr && n <= DFT_BLOCK_MAX_ROWS) {
    // one grid that fills the card, its blocks over the buckets by K3's counts
    blocks = fill * K4_WAVES < chunks ? fill * K4_WAVES : chunks;
    if (blocks < n_buckets) blocks = n_buckets;
  } else {
    // parts per bucket: as many as the card holds blocks at once, so that a
    // bucket that takes most rows (skew) is still folded by the whole card;
    // at least one chunk each, and fewer than 2^31 rows each (COUNT's shared
    // counters)
    long long parts = fill;
    if (parts > chunks) parts = chunks;
    const long long least = chunks * DFT_SLAB_CHUNK / DFT_BLOCK_MAX_ROWS + 1;
    if (parts < least) parts = least;
    blocks = parts * n_buckets;
    if (bucket_chunks == nullptr && fold_has_fix(o)) {
      const long long tiles = (n + DFT_TILE_ROWS - 1) / DFT_TILE_ROWS;
      long long sblocks = fold_blocks(fold_scale_kernel, 0, &err);
      if (err != cudaSuccess) return (int)err;
      if (sblocks > tiles) sblocks = tiles;
      fold_scale_kernel<<<(unsigned int)sblocks, DFT_FOLD_TPB, 0, (cudaStream_t)stream>>>(gid, n, num_groups, o);
    }
    bucket_chunks = nullptr;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)blocks, DFT_FOLD_TPB, o.smem, (cudaStream_t)stream>>>(gid, n, num_groups, n_buckets,
                                                                              bucket_chunks, o, done);
  return (int)cudaGetLastError();
}

// K4. kinds, vals, masks and aux as for dft_segreduce_dense; outs[a] is
// op a's [num_groups] device table (a float SUM's four, one after
// another) and `done` a device counter, all zeroed (reduce_common.cuh, the
// fold tile): op a's table ends as the op's output, as for K2. With a
// float SUM, the first pass for its scale runs before the fold.
extern "C" int dft_windowed_reduce(const int* gid, long long n, int num_groups, int n_ops, const int* kinds,
                                   const void* const* vals, const uint8_t* const* masks, void* const* outs,
                                   void* const* aux, unsigned int* done, void* stream) {
  return windowed_reduce(gid, n, num_groups, 0, n_ops, kinds, vals, masks, nullptr, outs, aux, done, nullptr,
                         stream);
}

// K4 over K3's slab as K3 left it: the gid still packed below id_mod (a
// gap SENTINEL), op a's mask as its gid bit mask_bits[a] (-1: none), a
// float SUM's aux the scale word K3 left for its rows, and bucket_chunks
// K3's chunk counts (its `info` past the scale words): no first pass, and
// one grid that fills the card split over the buckets by their chunks.
extern "C" int dft_windowed_reduce_slab(const int* gid, long long n, int num_groups, int id_mod, int n_ops,
                                        const int* kinds, const void* const* vals, const int* mask_bits,
                                        void* const* outs, void* const* aux, unsigned int* done,
                                        const unsigned long long* bucket_chunks, void* stream) {
  const uint8_t* none[DFT_FOLD_MAX_OPS] = {};
  if (id_mod <= 0 || bucket_chunks == nullptr || n_ops < 0 || n_ops > DFT_FOLD_MAX_OPS)
    return (int)cudaErrorInvalidValue;
  return windowed_reduce(gid, n, num_groups, id_mod, n_ops, kinds, vals, none, mask_bits, outs, aux, done,
                         bucket_chunks, stream);
}
