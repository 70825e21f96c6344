// ELLPACK SpMV and the fused Galerkin residual:
//   y[r] = sum_l vals[r, l] * x[cols[r, l]]          (spmv_ell)
//   y[r] = sum_l vals[r, l] * x[cols[r, l]] - f[r]   (galerkin_residual_ell)
// over row-major (N, L) vals / int32 cols.  Padded slots point back at their
// own row with a zero value, so they add nothing and need no test.
//
// Replaces the Pallas TPU kernels repro/kernels/spmv_ell.py: spmv_ell
// (_spmv_kernel via _spmv_ell_padded) and galerkin_residual_ell
// (_residual_kernel via _residual_ell_padded).
//
// Bound on an H100: memory.  Per row, L values and L column indices are
// streamed once (12 L bytes in float64) for 2 L flops; at the 3D Poisson
// main path (N = 274,625, L = 15) that is 54 MB, some 16 us at 3.35 TB/s.
// x (2.2 MB there) stays in L2 and is gathered through the read-only path.
// The bytes have to be in flight: at ~700 ns of latency, some 18 KB per SM.
//
// Design, for rows of at most 32 slots: one pass over warp tiles.
//   * A warp tile is 32 consecutive rows.  Its vals (32 L sizeof(T) bytes)
//     and cols (128 L bytes) are contiguous, and both sizes are multiples of
//     16 for every L, so every tile lies at its operand's address modulo 16.
//   * A warp stages its tile in its own shared memory, at that address
//     modulo 16: the aligned middle by copy, the unaligned ends (a
//     misaligned operand, the ragged last tile) word by word.  Then lane
//     i sums row i: it reads its L columns from shared memory, issues all L
//     gathers of x before the first product, and writes y[row0 + i], so a
//     warp stores 32 consecutive outputs.  The residual reads f[row0 + i]
//     before the tile lands and subtracts it in the same pass.
//   * One cp.async.bulk per array (the 1-D TMA copy) stages a tile; it
//     completes on a per-warp mbarrier.  One tile is in flight per warp: the
//     other warps of the SM overlap a warp's gathers.  On an H100 this was
//     faster than 16-byte cp.async copies by the lanes, and than two tiles in
//     flight, which halve the warps that fit an SM (PERF.md).
//   * vals and cols are copied under an L2 evict-first policy: 54 MB read
//     once stream through the 50 MB L2 without pushing out x, which every
//     warp gathers from.
//   * No CTA-wide synchronisation and no producer warp: warp w of the grid
//     walks tiles w, w + W, w + 2W, ... (W warps in all), and the grid is as
//     many 4-warp CTAs as the card holds at once (several per SM), so CTAs
//     overlap one another too.
//   * Sum order: lane i forms each product alone (no fused multiply-add)
//     and adds them in the tree of a group of G lanes per row, G the power
//     of two >= L (slot l + G/2 onto slot l, then G/4, ...), which the
//     streaming kernel (spmv_ell_stream.cu) keeps as well: B3 and B5 give
//     the same bits.
// Rows wider than 32 slots take a warp per row instead: lane l sums slots
// l, l + 32, ... in turn, then the lanes' shuffle tree.
// Shared memory per CTA (tile_smem): 4 warps x (32 L (sizeof(T) + 4) + 32)
// bytes, plus an 8-byte mbarrier per warp; 23,200 bytes at the main path
// (L = 15, float64), so nine CTAs (36 warps) share an SM.
#include <algorithm>
#include <atomic>
#include <cstdint>

#include "tg_async.cuh"
#include "tg_common.cuh"

namespace {

constexpr int kWarps = 4;              // warps per CTA of the tile kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 32;          // rows of a warp tile: lane i sums row i
constexpr int kMaxTileWidth = 32;      // wider rows take the warp-per-row kernel
constexpr int kWideBlock = 256;
constexpr int kMaxDevices = 64;        // devices whose tile-kernel grid is cached

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The lane tree of G products, in registers: slot j + Off onto slot j for
// Off = G/2, G/4, ..., 1 (every index a constant, so nothing spills to the
// stack).
template <int Off, typename T, int G>
__device__ __forceinline__ void tree_sum(T (&p)[G]) {
  if constexpr (Off > 0) {
#pragma unroll
    for (int j = 0; j < Off; ++j) p[j] += p[j + Off];
    tree_sum<Off / 2>(p);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ x,
            const T* __restrict__ f, T* __restrict__ y, long long n_rows, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t vals_room = static_cast<size_t>(kTileRows) * width * sizeof(T) + 16;
  const size_t stage_bytes = vals_room + static_cast<size_t>(kTileRows) * width * sizeof(int) + 16;
  unsigned char* stage = smem + static_cast<size_t>(warp) * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWarps * stage_bytes) + warp;
  if (lane == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // where a tile's vals and cols land in the stage: at their address modulo 16
  const size_t vals_at = reinterpret_cast<uintptr_t>(vals) & 15;
  const size_t cols_at = vals_room + (reinterpret_cast<uintptr_t>(cols) & 15);
  const long long n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  // vals and cols are read once: their lines leave L2 first, x stays
  const uint64_t policy = l2_evict_first();

  unsigned phase = 0;
  for (long long tile = first; tile < n_tiles; tile += step, phase ^= 1) {
    const long long row0 = tile * kTileRows;
    const unsigned n = static_cast<unsigned>(min(n_rows - row0, static_cast<long long>(kTileRows))) *
                       width;
    Part part;  // lane 0 copies the tile's vals, lane 1 its cols
    if (lane == 0) {
      part.dst = stage + vals_at;
      part.src = reinterpret_cast<const unsigned char*>(vals + row0 * width);
      part.bytes = n * sizeof(T);
    } else if (lane == 1) {
      part.dst = stage + cols_at;
      part.src = reinterpret_cast<const unsigned char*>(cols + row0 * width);
      part.bytes = n * sizeof(int);
    }
    fill(part, full, lane, policy);

    const long long row = row0 + lane;
    const bool live = row < n_rows;
    const T fr = f != nullptr && live ? __ldg(f + row) : T(0);
    mbar_wait(full, phase);
    __syncwarp();  // the word-by-word ends of the tile have landed too
    const T* vt = reinterpret_cast<const T*>(stage + vals_at) + lane * width;
    const int* ct = reinterpret_cast<const int*>(stage + cols_at) + lane * width;
    if (live) {
      T p[G];
#pragma unroll
      for (int l = 0; l < G; ++l) p[l] = l < width ? __ldg(x + ct[l]) : T(0);
#pragma unroll
      for (int l = 0; l < G; ++l) p[l] = l < width ? mul_rn(vt[l], p[l]) : T(0);
      tree_sum<G / 2>(p);
      y[row] = f != nullptr ? p[0] - fr : p[0];
    }
    // the stage is refilled next: order these reads before the copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
  }
}

// Rows wider than kMaxTileWidth: a warp per row, lane l summing slots
// l, l + 32, ..., then the shuffle tree.
template <typename T>
__global__ void __launch_bounds__(kWideBlock)
wide_kernel(const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ x,
            const T* __restrict__ f, T* __restrict__ y, long long n_rows, int width) {
  const long long row = (static_cast<long long>(blockIdx.x) * kWideBlock + threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x % 32);
  T acc = T(0);
  if (row < n_rows) {
    const long long base = row * width;
    for (int l = lane; l < width; l += 32) acc += vals[base + l] * __ldg(x + cols[base + l]);
  }
  // every lane of the warp reaches the shuffles (rows past the end add 0)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0 && row < n_rows) y[row] = f != nullptr ? acc - f[row] : acc;
}

int group_of(long long width) {
  int g = 1;
  while (g < width && g < 32) g <<= 1;
  return g;
}

size_t tile_smem(long long width, size_t item) {
  return static_cast<size_t>(kWarps) *
         (static_cast<size_t>(kTileRows) * width * (item + sizeof(int)) + 32 + 8);
}

template <typename T>
const void* tile_entry(long long width) {
  switch (group_of(width)) {
    case 1: return reinterpret_cast<const void*>(&tile_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(&tile_kernel<T, 2>);
    case 4: return reinterpret_cast<const void*>(&tile_kernel<T, 4>);
    case 8: return reinterpret_cast<const void*>(&tile_kernel<T, 8>);
    case 16: return reinterpret_cast<const void*>(&tile_kernel<T, 16>);
    default: return reinterpret_cast<const void*>(&tile_kernel<T, 32>);
  }
}

// CTAs of the tile kernel at `width` that device `dev` holds at once: SMs x
// the occupancy API's CTAs per SM.  The lookup also lets the instance use
// the device's opt-in shared memory.
template <typename T>
cudaError_t look_up_capacity(int dev, long long width, int* out) {
  const void* kernel = tile_entry<T>(width);
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        tile_smem(width, sizeof(T)));
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) *out = sms * per_sm;
  return err;
}

// The capacity of each (device, width), looked up at its first launch and
// read without a lock after it (0: not looked up yet; a race looks up twice
// and stores the same value).
template <typename T>
std::atomic<int>& known_capacity(int dev, long long width) {
  static std::atomic<int> known[kMaxDevices][kMaxTileWidth + 1];
  return known[dev][width];
}

// The grid of a launch on the current device: the tile kernel's CTAs (at
// most one warp per tile), or the wide kernel's blocks; minus a CUDA error
// code on failure.
template <typename T>
long long grid_of(long long n_rows, long long width) {
  if (width > kMaxTileWidth) return static_cast<long long>(tg_blocks(n_rows * 32, kWideBlock));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  int cap = dev < kMaxDevices ? known_capacity<T>(dev, width).load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    err = look_up_capacity<T>(dev, width, &cap);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    if (dev < kMaxDevices) known_capacity<T>(dev, width).store(cap, std::memory_order_relaxed);
  }
  const long long warps = (n_rows + kTileRows - 1) / kTileRows;
  return std::min<long long>(cap, (warps + kWarps - 1) / kWarps);
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, const void* f, void* y,
           long long n_rows, long long width, void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = grid_of<T>(n_rows, width);
  if (grid < 0) {
    cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(-grid);
  }
  const auto* vv = static_cast<const T*>(vals);
  const auto* cc = static_cast<const int*>(cols);
  const auto* xx = static_cast<const T*>(x);
  const auto* ff = static_cast<const T*>(f);
  auto* yy = static_cast<T*>(y);
  int w = static_cast<int>(width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  if (width > kMaxTileWidth) {
    wide_kernel<T><<<g, kWideBlock, 0, s>>>(vv, cc, xx, ff, yy, n_rows, w);
    return static_cast<int>(cudaGetLastError());
  }
  // the instance is picked at run time: launch it by its entry
  void* args[] = {&vv, &cc, &xx, &ff, &yy, &n_rows, &w};
  const cudaError_t err = cudaLaunchKernel(tile_entry<T>(width), dim3(g), dim3(kThreads), args,
                                           tile_smem(width, sizeof(T)), s);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// The grid and the dynamic shared memory per CTA of a launch at (n_rows,
// width) on the current device, for the design figures; the grid is minus
// a CUDA error code on failure.
TG_EXPORT int tg_ell_grid_f32(long long n_rows, long long width) {
  return static_cast<int>(grid_of<float>(n_rows, width));
}

TG_EXPORT int tg_ell_grid_f64(long long n_rows, long long width) {
  return static_cast<int>(grid_of<double>(n_rows, width));
}

TG_EXPORT int tg_ell_smem_f32(long long width) {
  return width > kMaxTileWidth ? 0 : static_cast<int>(tile_smem(width, 4));
}

TG_EXPORT int tg_ell_smem_f64(long long width) {
  return width > kMaxTileWidth ? 0 : static_cast<int>(tile_smem(width, 8));
}

TG_EXPORT int tg_spmv_ell_f32(const void* vals, const void* cols, const void* x, void* y,
                              long long n_rows, long long width, void* stream) {
  return launch<float>(vals, cols, x, nullptr, y, n_rows, width, stream);
}

TG_EXPORT int tg_spmv_ell_f64(const void* vals, const void* cols, const void* x, void* y,
                              long long n_rows, long long width, void* stream) {
  return launch<double>(vals, cols, x, nullptr, y, n_rows, width, stream);
}

TG_EXPORT int tg_residual_ell_f32(const void* vals, const void* cols, const void* u,
                                  const void* f, void* y, long long n_rows, long long width,
                                  void* stream) {
  return launch<float>(vals, cols, u, f, y, n_rows, width, stream);
}

TG_EXPORT int tg_residual_ell_f64(const void* vals, const void* cols, const void* u,
                                  const void* f, void* y, long long n_rows, long long width,
                                  void* stream) {
  return launch<double>(vals, cols, u, f, y, n_rows, width, stream);
}
