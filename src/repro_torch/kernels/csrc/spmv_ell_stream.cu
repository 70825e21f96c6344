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
// kernel in spmv_ell.cu.  Each block also reads its x-window (W elements); the
// windows of neighbouring blocks overlap, so most of those reads hit L2, and
// they are overhead, not part of the bound.
//
// Design.  The TPU kernel runs one program that walks the row blocks in order,
// DMA-ing vals, cols and the x-window of each block into VMEM nbuf deep.  A
// 4096 x 15 float64 vals tile alone (480 KB) is twice what one H100 block may
// hold (227 KB), and the blocks of a GPU run in parallel, so here:
//   * one CTA per row block.  It copies its x-window into shared memory once
//     (cp.async, bounds-checked against N: positions past the end of x read
//     as 0, as the zero padding of x up to x_len does on the TPU),
//     single-buffered: at N = 912,673 (unit_cube_tet(96)) one float64 window
//     is 157 KB and two no longer fit;
//   * the CTA's rows stream through shared memory in tiles of kTileRows rows
//     of vals and cols_local (each a contiguous run of kTileRows * L words,
//     copied 16 bytes at a time where aligned) and, for the residual, of f,
//     nbuf tiles deep: cp.async groups keep nbuf - 1 tiles in flight while
//     one is consumed; nbuf = 1 is no overlap.  (Reading f[row] from global
//     memory at the end of each row instead put one memory latency per pass
//     on the critical path: the residual took 1.7x the SpMV's time.)
//   * a group of G lanes per row, G the power of two >= L (at most 32), reads
//     the tile in shared memory and gathers x from the window; the group sums
//     with warp shuffles, in the same order as spmv_ell.cu, so B5 and B3 give
//     the same bits on the same operator.
// Shared memory per CTA: W * sizeof(T) + nbuf * kTileRows * (L * (sizeof(T) + 4)
// + sizeof(T)) bytes (stream_smem_bytes in spmv_ell.py, which the wrapper
// checks against the card's opt-in limit before launch; the SpMV leaves the f
// tiles unused).  The launcher raises the kernel's dynamic shared-memory
// limit to that size.
//
// Shape and defaults.  512 threads and 128-row tiles (with block_n = 1024,
// nbuf = 2, in spmv_ell.py): on the 3D main path (unit_cube_tet(64),
// N = 274,625, L = 15) that is 269 CTAs of 123 KB in float64 (W = 9,728),
// one resident per SM, so the grid covers the 132 SMs about twice; at
// unit_cube_tet(96) 892 CTAs of 204 KB (W = 20,096).  block_n = 4096, the TPU
// default, gives 68 CTAs at n = 64 and leaves half the SMs idle.  A sweep of
// 256/512/1024 threads by 64/128-row tiles on the card found 16 warps per CTA
// with 128-row tiles faster than two resident CTAs of 8 warps with 64-row
// tiles (the first design: 0.061 ms at n = 64 and 0.196 ms at n = 96, from
// chip_smoke.py): with one or two CTAs per SM, the warps and tiles in flight
// per CTA are what hide the memory latency.
#include <cstdint>

#include "tg_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileRows = 128;  // keep in step with TILE_ROWS in spmv_ell.py
constexpr int kMaxBuffers = 4;  // cp_async_wait below covers 0 .. kMaxBuffers - 1

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {  // 16-byte copies bypass L1: the tiles are read once
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(B)
                 : "memory");
  }
}

// The CTA copies a run of `count` elements into shared memory: in 16-byte
// pieces where both ends are 16-byte aligned and the run divides evenly
// (the block-uniform test keeps the warps together), else element by element.
template <typename E>
__device__ __forceinline__ void copy_run(E* dst, const E* src, int count) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  const uintptr_t ends = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if ((ends & 15) == 0 && count % kVec == 0) {
    for (int i = threadIdx.x * kVec; i < count; i += kThreads * kVec) {
      cp_async<16>(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) cp_async<sizeof(E)>(dst + i, src + i);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ vals, const int* __restrict__ cols_local,
              const int* __restrict__ starts, const T* __restrict__ x,
              const T* __restrict__ f, T* __restrict__ y, long long n_rows, int width,
              int block_n, int window, int tile_rows, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = tile_rows * width;
  T* xw = reinterpret_cast<T*>(smem);                  // the block's x-window
  T* vbuf = xw + window;                               // nbuf tiles of vals
  T* fbuf = vbuf + nbuf * tile_elems;                  // nbuf tiles of f (residual)
  int* cbuf = reinterpret_cast<int*>(fbuf + nbuf * tile_rows);  // nbuf tiles of cols

  const long long row0 = static_cast<long long>(blockIdx.x) * block_n;
  const int rows = static_cast<int>(min(static_cast<long long>(block_n), n_rows - row0));
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const long long start = starts[blockIdx.x];

  // the window joins the first cp.async group, so the first wait covers it
  const int avail = static_cast<int>(min(static_cast<long long>(window), n_rows - start));
  copy_run(xw, x + start, avail);
  for (int j = avail + threadIdx.x; j < window; j += kThreads) xw[j] = T(0);

  auto load_tile = [&](int t) {
    const int slot = t % nbuf;
    const long long r0 = row0 + static_cast<long long>(t) * tile_rows;
    const int t_rows = min(tile_rows, rows - t * tile_rows);
    copy_run(vbuf + slot * tile_elems, vals + r0 * width, t_rows * width);
    copy_run(cbuf + slot * tile_elems, cols_local + r0 * width, t_rows * width);
    if (f != nullptr) copy_run(fbuf + slot * tile_rows, f + r0, t_rows);
  };

  // prologue: tiles 0 .. nbuf - 2 in flight (one group each, empty past the end)
  for (int t = 0; t < nbuf - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int lane = threadIdx.x % G;
  for (int t = 0; t < n_tiles; ++t) {
    // refill the slot consumed at t - 1 (freed by the barrier that ended it)
    const int ahead = t + nbuf - 1;
    if (ahead < n_tiles) load_tile(ahead);
    cp_async_commit();
    cp_async_wait(nbuf - 1);  // tile t (and the window) has landed
    __syncthreads();

    const int slot = t % nbuf;
    const T* vt = vbuf + slot * tile_elems;
    const int* ct = cbuf + slot * tile_elems;
    const T* ft = fbuf + slot * tile_rows;
    const int t_rows = min(tile_rows, rows - t * tile_rows);
    // every lane of a warp reaches the shuffles: the trip count is block-uniform
    for (int r0 = 0; r0 < t_rows; r0 += kGroups) {
      const int r = r0 + group;
      T acc = T(0);
      if (r < t_rows) {
        const int base = r * width;
        for (int l = lane; l < width; l += G) acc += vt[base + l] * xw[ct[base + l]];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, G);
      if (lane == 0 && r < t_rows) {
        const long long row = row0 + static_cast<long long>(t) * tile_rows + r;
        y[row] = f != nullptr ? acc - ft[r] : acc;
      }
    }
    __syncthreads();  // the slot may be refilled at t + 1
  }
}

template <typename T, int G>
cudaError_t launch_group(const T* vals, const int* cols_local, const int* starts, const T* x,
                         const T* f, T* y, long long n_rows, int width, int block_n, int window,
                         int tile_rows, int nbuf, size_t smem, cudaStream_t s) {
  auto kernel = stream_kernel<T, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_blocks = (n_rows + block_n - 1) / block_n;
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem, s>>>(
      vals, cols_local, starts, x, f, y, n_rows, width, block_n, window, tile_rows, nbuf);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* cols_local, const void* starts, const void* x,
           const void* f, void* y, long long n_rows, long long width, long long block_n,
           long long window, long long nbuf, void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 1 || block_n < 1 || window < 1 || nbuf < 1 || nbuf > kMaxBuffers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* v = static_cast<const T*>(vals);
  const int* c = static_cast<const int*>(cols_local);
  const int* st = static_cast<const int*>(starts);
  const T* xx = static_cast<const T*>(x);
  const T* ff = static_cast<const T*>(f);
  T* yy = static_cast<T*>(y);
  const int w = static_cast<int>(width);
  const int bn = static_cast<int>(block_n);
  const int win = static_cast<int>(window);
  const int tile_rows = bn < kTileRows ? bn : kTileRows;
  const int nb = static_cast<int>(nbuf);
  const size_t smem =
      static_cast<size_t>(win) * sizeof(T) +
      static_cast<size_t>(nb) * tile_rows * (w * (sizeof(T) + sizeof(int)) + sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int g = 1;
  while (g < w && g < 32) g <<= 1;
  cudaError_t err;
  switch (g) {
    case 1: err = launch_group<T, 1>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
    case 2: err = launch_group<T, 2>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
    case 4: err = launch_group<T, 4>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
    case 8: err = launch_group<T, 8>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
    case 16: err = launch_group<T, 16>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
    default: err = launch_group<T, 32>(v, c, st, xx, ff, yy, n_rows, w, bn, win, tile_rows, nb, smem, s); break;
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the wrapper raises
  return static_cast<int>(err);
}

}  // namespace

TG_EXPORT int tg_spmv_ell_stream_f32(const void* vals, const void* cols_local, const void* starts,
                                     const void* x, void* y, long long n_rows, long long width,
                                     long long block_n, long long window, long long nbuf,
                                     void* stream) {
  return launch<float>(vals, cols_local, starts, x, nullptr, y, n_rows, width, block_n, window,
                       nbuf, stream);
}

TG_EXPORT int tg_spmv_ell_stream_f64(const void* vals, const void* cols_local, const void* starts,
                                     const void* x, void* y, long long n_rows, long long width,
                                     long long block_n, long long window, long long nbuf,
                                     void* stream) {
  return launch<double>(vals, cols_local, starts, x, nullptr, y, n_rows, width, block_n, window,
                        nbuf, stream);
}

TG_EXPORT int tg_residual_ell_stream_f32(const void* vals, const void* cols_local,
                                         const void* starts, const void* u, const void* f,
                                         void* y, long long n_rows, long long width,
                                         long long block_n, long long window, long long nbuf,
                                         void* stream) {
  return launch<float>(vals, cols_local, starts, u, f, y, n_rows, width, block_n, window, nbuf,
                       stream);
}

TG_EXPORT int tg_residual_ell_stream_f64(const void* vals, const void* cols_local,
                                         const void* starts, const void* u, const void* f,
                                         void* y, long long n_rows, long long width,
                                         long long block_n, long long window, long long nbuf,
                                         void* stream) {
  return launch<double>(vals, cols_local, starts, u, f, y, n_rows, width, block_n, window, nbuf,
                        stream);
}
