// Streaming ELL SpMV and the fused Galerkin residual on the streaming plan:
//   y[r] = sum_l vals[r, l] * x[start_b + cols_local[r, l]]          (spmv_ell_stream)
//   y[r] = sum_l vals[r, l] * x[start_b + cols_local[r, l]] - f[r]   (galerkin_residual_ell_stream)
// for the rows r of row block b = r / block_n.  The plan (host-built, see
// repro_torch/kernels/spmv_ell.py: StreamPlan) rebases every column of a row
// block into the block's x-window [start_b, start_b + W), W a multiple of 128.
// Padded slots have a zero value and an in-window column, so they add nothing.
//
// Replaces the Pallas TPU kernels repro/kernels/spmv_ell.py: spmv_ell_stream
// (_stream_kernel with residual=False via _spmv_stream_padded) and
// galerkin_residual_ell_stream (_stream_kernel with residual=True via
// _residual_stream_padded).
//
// Bound on an H100: memory.  Per row, L values and L rebased int32 columns are
// read once (12 L bytes in float64) for 2 L flops, as for the broadcast-plan
// kernel in spmv_ell.cu.  x is copied about once per CTA run (the first
// window, then slides), overhead on top of the bound.
//
// Design.  The TPU kernel is one program that walks the row blocks in order
// and prefetches block b + nbuf's vals, cols and x-window while it sums block
// b.  Here a persistent CTA does that walk over a run of rows:
//   * Grid.  One CTA per SM, or as many as fit (the wrapper asks the occupancy
//     API), never more than there are tiles.  The rows are cut into tiles of
//     kTileRows rows that never straddle a plan block, and the host balances
//     the tiles over the CTAs (runs[c] .. runs[c + 1], within one tile of each
//     other), so there is no wave tail.  A run may start or end inside a plan
//     block; its rows still read that block's window.
//   * Sliding x-window.  The CTA keeps x in a ring of R elements of shared
//     memory (R >= W plus the plan's largest forward step of `starts`, up to
//     W; host-computed).  Position p sits in slot (p + shift) mod R, where
//     shift is x's misalignment in elements, so a slot and its source agree
//     modulo 16 bytes.  When the walk moves on from block b - 1 to b it copies
//     only x[load_lo[b], start_b + W): the slots it overwrites held positions
//     below start_{b-1}, which block b - 1 no longer reads, so the copy is
//     issued while block b - 1's last tiles are still being summed (only
//     block b - 2 must be done).  Where `starts` goes down or steps further
//     than R - W (load_lo[b] < 0), and at the start of every run, the CTA
//     waits until the previous block is done and loads the whole window.  A
//     gather indexes the ring with one compare-and-subtract.  Every column is
//     below N, so a copy stops at N: window positions past the end of x (the
//     TPU kernel's zero padding up to x_len) are never read.  Each block's
//     start and load_lo are read one block ahead.
//   * Bulk-copy stage ring.  Warp 0 is the producer: it fills an nbuf-stage
//     ring of vals, cols and f tiles, and the window, with cp.async.bulk (the
//     1-D TMA copy), one copy per lane (vals, cols, f on lanes 0-2; the two
//     pieces of a wrapping window on lanes 0-1).  A bulk copy needs 16-byte-
//     aligned ends, so a tile lands at its source's address modulo 16 and the
//     lane copies the unaligned head and tail (odd window starts, the ragged
//     last tile, misaligned operands) word by word.  Each fill is one
//     mbarrier arrival with its byte count (full[s], win_full by block
//     parity); the consumers hand a stage back on a named barrier (bar.arrive;
//     the producer bar.syncs before the refill), and report finished blocks on
//     blk_done (by block parity), which a window load waits for.
//   * Consumers.  16 warps; a group of G lanes per row, G the power of two
//     >= L (at most 32); a warp sums all its rows of a tile at once, for
//     overlap, each row in the order of spmv_ell.cu (each lane's product,
//     or past 32 slots its fused chain of slots l, l + 32, ..., then warp
//     shuffles), so B5 and B3 give the same bits at every width.
// Shared memory per CTA (stream_smem_bytes in spmv_ell.py; the launcher
// refuses any other size): R * sizeof(T) for the ring, nbuf stages of
// kTileRows * L * (sizeof(T) + 4) + kTileRows * sizeof(T) + 48 bytes, and
// 8 * (nbuf + 4) bytes of mbarriers.  Independent of N.  On the 3D main path
// (L = 15, float64, block_n 1024) that is 87 KB of ring and 24 KB a stage at
// unit_cube_tet(64), and 170 KB of ring at unit_cube_tet(96), where two
// stages fit.
#include <cstdint>

#include "tg_async.cuh"
#include "tg_common.cuh"

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // warp 0 is the producer
constexpr int kTileRows = 128;             // keep in step with TILE_ROWS in spmv_ell.py
constexpr int kMaxBuffers = 8;             // keep in step with MAX_BUFFERS in spmv_ell.py

// Named barrier `id` (1..kMaxBuffers: stage id - 1) between the consumers,
// which arrive when they are done with the stage, and the producer, which
// waits there before it refills the stage.  A hardware barrier: no shared
// memory word for 16 warps to update one by one.
__device__ __forceinline__ void stage_done(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void stage_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

template <typename T>
struct Layout {
  T* ring;
  unsigned char* stages;
  size_t vals_bytes, cols_bytes, stage_bytes;
  uint64_t* full;      // [nbuf]: a stage's tiles have landed
  uint64_t* win_full;  // [2]: the window of block i has landed (by i's parity)
  uint64_t* blk_done;  // [2]: the consumers are done with block i (by i's parity)

  __device__ Layout(unsigned char* smem, int ring_len, int width, int nbuf) {
    ring = reinterpret_cast<T*>(smem);
    stages = smem + static_cast<size_t>(ring_len) * sizeof(T);
    vals_bytes = static_cast<size_t>(kTileRows) * width * sizeof(T) + 16;
    cols_bytes = static_cast<size_t>(kTileRows) * width * sizeof(int) + 16;
    stage_bytes = vals_bytes + cols_bytes + kTileRows * sizeof(T) + 16;
    full = reinterpret_cast<uint64_t*>(stages + nbuf * stage_bytes);
    win_full = full + nbuf;
    blk_done = win_full + 2;
  }
  // a tile's array inside a stage lands at its source's address modulo 16
  template <typename E>
  __device__ E* at(unsigned char* stage, size_t offset, const E* src) const {
    return reinterpret_cast<E*>(stage + offset + (reinterpret_cast<uintptr_t>(src) & 15));
  }
};

// The walk over a CTA's run of tiles, advanced without divisions: the tile
// (plan block, tile within it, first row, rows) and its stage of the ring.
struct Walk {
  int tiles_per_block, block_n, nbuf;
  long long n_rows;
  int block, j, stage;
  unsigned round;  // times the stage ring has wrapped: the stage's barrier phase
  long long row0;
  int rows;

  __device__ Walk(int tile, int tpb, int bn, int nb, long long n)
      : tiles_per_block(tpb), block_n(bn), nbuf(nb), n_rows(n), stage(0), round(0) {
    block = tile / tpb;
    j = tile - block * tpb;
    settle();
  }
  __device__ void settle() {
    row0 = static_cast<long long>(block) * block_n + static_cast<long long>(j) * kTileRows;
    rows = static_cast<int>(min(static_cast<long long>(min(kTileRows, block_n - j * kTileRows)),
                                n_rows - row0));
  }
  __device__ void next() {
    if (++j == tiles_per_block) {
      j = 0;
      ++block;
    }
    if (++stage == nbuf) {
      stage = 0;
      ++round;
    }
    settle();
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const T* __restrict__ vals, const int* __restrict__ cols_local,
              const int* __restrict__ starts, const int* __restrict__ load_lo,
              const int* __restrict__ runs, const T* __restrict__ x, const T* __restrict__ f,
              T* __restrict__ y, long long n_rows, int width, int block_n, int window,
              int ring_len, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> lay(smem, ring_len, width, nbuf);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) mbar_init(&lay.full[s], 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&lay.win_full[i], 1);
      mbar_init(&lay.blk_done[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_per_block = (block_n + kTileRows - 1) / kTileRows;
  const int tile_lo = runs[blockIdx.x];
  const int n_tiles = runs[blockIdx.x + 1] - tile_lo;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T));
  const size_t cols_at = lay.vals_bytes;
  const size_t f_at = lay.vals_bytes + lay.cols_bytes;
  Walk t(tile_lo, tiles_per_block, block_n, nbuf, n_rows);
  // each block's start and load_lo are read one block ahead, so that no
  // global load waits at a block boundary
  const int last_block = static_cast<int>((n_rows - 1) / block_n);
  int next_start = starts[t.block];
  int next_lo = load_lo[t.block];

  if (warp == 0) {
    // ---- producer: the window of each block, then its tiles, in run order
    int local = -1;
    for (int i = 0; i < n_tiles; ++i, t.next()) {
      if (i == 0 || t.j == 0) {
        ++local;
        const long long start = next_start;
        const int from = next_lo;
        if (t.block < last_block) {
          next_start = starts[t.block + 1];
          next_lo = load_lo[t.block + 1];
        }
        const bool reload = local == 0 || from < 0;
        // the slots this load overwrites were last read by block local - 1
        // (whole window) or local - 2 (slide)
        const int after = reload ? local - 1 : local - 2;
        if (after >= 0) mbar_wait(&lay.blk_done[after & 1], (after >> 1) & 1);
        const long long lo = reload ? start : from;
        // window positions at or past N are never gathered (every column is
        // below N), so the copy stops at N
        const long long hx = min(start + window, n_rows);
        // x[lo, hx) in at most two pieces (the ring wraps), lanes 0 and 1
        Part part;
        if (lo < hx) {
          const int slot = static_cast<int>((lo + shift) % ring_len);
          const long long first = min(hx - lo, static_cast<long long>(ring_len - slot));
          if (lane == 0) {
            part.dst = reinterpret_cast<unsigned char*>(lay.ring + slot);
            part.src = reinterpret_cast<const unsigned char*>(x + lo);
            part.bytes = static_cast<unsigned>(first * sizeof(T));
          } else if (lane == 1 && first < hx - lo) {
            part.dst = reinterpret_cast<unsigned char*>(lay.ring);
            part.src = reinterpret_cast<const unsigned char*>(x + lo + first);
            part.bytes = static_cast<unsigned>((hx - lo - first) * sizeof(T));
          }
        }
        fill(part, &lay.win_full[local & 1], lane);
      }
      if (i >= nbuf) stage_wait(t.stage + 1);
      // vals, cols and f of the tile: lanes 0, 1 and 2
      unsigned char* stage = lay.stages + t.stage * lay.stage_bytes;
      Part part;
      if (lane == 0) {
        const T* src = vals + t.row0 * width;
        part.dst = reinterpret_cast<unsigned char*>(lay.at(stage, 0, src));
        part.src = reinterpret_cast<const unsigned char*>(src);
        part.bytes = static_cast<unsigned>(t.rows * width * sizeof(T));
      } else if (lane == 1) {
        const int* src = cols_local + t.row0 * width;
        part.dst = reinterpret_cast<unsigned char*>(lay.at(stage, cols_at, src));
        part.src = reinterpret_cast<const unsigned char*>(src);
        part.bytes = static_cast<unsigned>(t.rows * width * sizeof(int));
      } else if (lane == 2 && f != nullptr) {
        const T* src = f + t.row0;
        part.dst = reinterpret_cast<unsigned char*>(lay.at(stage, f_at, src));
        part.src = reinterpret_cast<const unsigned char*>(src);
        part.bytes = static_cast<unsigned>(t.rows * sizeof(T));
      }
      fill(part, &lay.full[t.stage], lane);
    }
    // meet the consumers at the stages of the last tiles, which no refill waited for
    for (int i = max(n_tiles - nbuf, 0); i < n_tiles; ++i) stage_wait(i % nbuf + 1);
    return;
  }

  // ---- consumers: a group of G lanes per row
  constexpr int kGroups = kConsumers / G;
  constexpr int kPasses = (kTileRows + kGroups - 1) / kGroups;
  const int c = threadIdx.x - 32;
  const int group = c / G;
  const int glane = c % G;
  const T* ring = lay.ring;
  int local = -1;
  int base = 0;  // ring slot of the current block's window start
  for (int i = 0; i < n_tiles; ++i, t.next()) {
    if (i == 0 || t.j == 0) {
      ++local;
      mbar_wait(&lay.win_full[local & 1], (local >> 1) & 1);
      base = static_cast<int>((static_cast<long long>(next_start) + shift) % ring_len);
      if (t.block < last_block) next_start = starts[t.block + 1];
    }
    mbar_wait(&lay.full[t.stage], t.round & 1);
    unsigned char* stage = lay.stages + t.stage * lay.stage_bytes;
    const T* vt = lay.at(stage, 0, vals + t.row0 * width);
    const int* ct = lay.at(stage, cols_at, cols_local + t.row0 * width);
    const T* ft = f != nullptr ? lay.at(stage, f_at, f + t.row0) : nullptr;
    // all of a warp's rows of the tile at once (kPasses independent sums, so
    // their loads and shuffles overlap); each sum takes its slots in B3's
    // order and every lane reaches the shuffles
    T acc[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) acc[u] = T(0);
    for (int l = glane; l < width; l += G) {
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int r = u * kGroups + group;
        if (r < t.rows) {
          int slot = base + ct[r * width + l];
          if (slot >= ring_len) slot -= ring_len;
          acc[u] += vt[r * width + l] * ring[slot];
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kPasses; ++u) acc[u] += __shfl_down_sync(0xffffffffu, acc[u], off, G);
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int r = u * kGroups + group;
      if (glane == 0 && r < t.rows) y[t.row0 + r] = ft != nullptr ? acc[u] - ft[r] : acc[u];
    }
    stage_done(t.stage + 1);
    if (i + 1 == n_tiles || t.j + 1 == tiles_per_block) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&lay.blk_done[local & 1]);
    }
  }
}

// Dynamic shared memory of one CTA (mirrors stream_smem_bytes in spmv_ell.py).
size_t smem_need(int ring_len, int width, int nbuf, size_t item) {
  const size_t stage = static_cast<size_t>(kTileRows) * width * (item + sizeof(int)) +
                       kTileRows * item + 48;
  return static_cast<size_t>(ring_len) * item + nbuf * stage + 8 * (nbuf + 4);
}

int group_of(long long width) {
  int g = 1;
  while (g < width && g < 32) g <<= 1;
  return g;
}

template <typename T, int G>
cudaError_t launch_group(const T* vals, const int* cols_local, const int* starts,
                         const int* load_lo, const int* runs, const T* x, const T* f, T* y,
                         long long n_rows, int width, int block_n, int window, int ring_len,
                         int nbuf, int n_ctas, size_t smem, cudaStream_t s) {
  auto kernel = stream_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_ctas), kThreads, smem, s>>>(
      vals, cols_local, starts, load_lo, runs, x, f, y, n_rows, width, block_n, window, ring_len,
      nbuf);
  return cudaGetLastError();
}

template <typename T, int G>
int occupancy(size_t smem) {
  auto kernel = stream_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

template <typename T>
int ctas_per_sm(long long width, long long smem) {
  if (width < 1 || smem < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t sm = static_cast<size_t>(smem);
  switch (group_of(width)) {
    case 1: return occupancy<T, 1>(sm);
    case 2: return occupancy<T, 2>(sm);
    case 4: return occupancy<T, 4>(sm);
    case 8: return occupancy<T, 8>(sm);
    case 16: return occupancy<T, 16>(sm);
    default: return occupancy<T, 32>(sm);
  }
}

template <typename T>
int launch(const void* vals, const void* cols_local, const void* starts, const void* load_lo,
           const void* runs, const void* x, const void* f, void* y, long long n_rows,
           long long width, long long block_n, long long window, long long ring_len,
           long long nbuf, long long n_ctas, long long smem, void* stream) {
  if (n_rows <= 0) return 0;
  // the ring's bytes are a multiple of 16, so slot and source agree modulo 16
  if (width < 1 || block_n < 1 || window < 1 || ring_len < window || ring_len % 4 != 0 ||
      nbuf < 1 || nbuf > kMaxBuffers || n_ctas < 1 ||
      smem != static_cast<long long>(smem_need(static_cast<int>(ring_len), static_cast<int>(width),
                                               static_cast<int>(nbuf), sizeof(T)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* v = static_cast<const T*>(vals);
  const int* c = static_cast<const int*>(cols_local);
  const int* st = static_cast<const int*>(starts);
  const int* ll = static_cast<const int*>(load_lo);
  const int* ru = static_cast<const int*>(runs);
  const T* xx = static_cast<const T*>(x);
  const T* ff = static_cast<const T*>(f);
  T* yy = static_cast<T*>(y);
  const int w = static_cast<int>(width);
  const int bn = static_cast<int>(block_n);
  const int win = static_cast<int>(window);
  const int rl = static_cast<int>(ring_len);
  const int nb = static_cast<int>(nbuf);
  const int nc = static_cast<int>(n_ctas);
  const size_t sm = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (group_of(width)) {
    case 1: err = launch_group<T, 1>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
    case 2: err = launch_group<T, 2>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
    case 4: err = launch_group<T, 4>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
    case 8: err = launch_group<T, 8>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
    case 16: err = launch_group<T, 16>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
    default: err = launch_group<T, 32>(v, c, st, ll, ru, xx, ff, yy, n_rows, w, bn, win, rl, nb, nc, sm, s); break;
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the wrapper raises
  return static_cast<int>(err);
}

}  // namespace

// CTAs of the streaming kernel that fit one SM at this width and footprint,
// or minus a CUDA error code.
TG_EXPORT int tg_stream_ctas_per_sm_f32(long long width, long long smem) {
  return ctas_per_sm<float>(width, smem);
}

TG_EXPORT int tg_stream_ctas_per_sm_f64(long long width, long long smem) {
  return ctas_per_sm<double>(width, smem);
}

TG_EXPORT int tg_spmv_ell_stream_f32(const void* vals, const void* cols_local, const void* starts,
                                     const void* load_lo, const void* runs, const void* x,
                                     void* y, long long n_rows, long long width,
                                     long long block_n, long long window, long long ring_len,
                                     long long nbuf, long long n_ctas, long long smem,
                                     void* stream) {
  return launch<float>(vals, cols_local, starts, load_lo, runs, x, nullptr, y, n_rows, width,
                       block_n, window, ring_len, nbuf, n_ctas, smem, stream);
}

TG_EXPORT int tg_spmv_ell_stream_f64(const void* vals, const void* cols_local, const void* starts,
                                     const void* load_lo, const void* runs, const void* x,
                                     void* y, long long n_rows, long long width,
                                     long long block_n, long long window, long long ring_len,
                                     long long nbuf, long long n_ctas, long long smem,
                                     void* stream) {
  return launch<double>(vals, cols_local, starts, load_lo, runs, x, nullptr, y, n_rows, width,
                        block_n, window, ring_len, nbuf, n_ctas, smem, stream);
}

TG_EXPORT int tg_residual_ell_stream_f32(const void* vals, const void* cols_local,
                                         const void* starts, const void* load_lo,
                                         const void* runs, const void* u, const void* f, void* y,
                                         long long n_rows, long long width, long long block_n,
                                         long long window, long long ring_len, long long nbuf,
                                         long long n_ctas, long long smem, void* stream) {
  return launch<float>(vals, cols_local, starts, load_lo, runs, u, f, y, n_rows, width, block_n,
                       window, ring_len, nbuf, n_ctas, smem, stream);
}

TG_EXPORT int tg_residual_ell_stream_f64(const void* vals, const void* cols_local,
                                         const void* starts, const void* load_lo,
                                         const void* runs, const void* u, const void* f, void* y,
                                         long long n_rows, long long width, long long block_n,
                                         long long window, long long ring_len, long long nbuf,
                                         long long n_ctas, long long smem, void* stream) {
  return launch<double>(vals, cols_local, starts, load_lo, runs, u, f, y, n_rows, width, block_n,
                        window, ring_len, nbuf, n_ctas, smem, stream);
}
