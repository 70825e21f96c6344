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
// Shared memory per CTA (smem_of): 4 warps x (32 L (sizeof(T) + 4) + 32)
// bytes, plus an 8-byte mbarrier per warp; 23,200 bytes at the main path
// (L = 15, float64), so nine CTAs (36 warps) share an SM.
//
// Rows past 32 slots whose 32-row stage (32 L (sizeof(T) + 4) bytes) is
// below 32 KiB: the same one-pass design in wide_tile_kernel; in float64
// L = 33-85, in float32 L = 33-127 (the vector P1 tetrahedron stencil, 45;
// the vector Q1 hexahedron stencil, 81).  A 32-row tile's vals and cols
// are still contiguous multiples of 16 bytes, so the staging is the same.
//   * What bounds it: memory, as above.  What holds it back: a stage grows
//     with L, so fewer warps fit an SM as L grows, and a warp's gathers
//     wait for its whole tile.
//   * One warp per CTA: one-warp CTAs pack the SM's shared memory the
//     tightest.  Shared memory per CTA: the stage, 32 bytes of room and
//     an 8-byte mbarrier; float64: 12,712 bytes at L = 33, 17,320 at 45
//     (12 CTAs per SM), 32,680 at 85 (6); float32: 8,488, 11,560 and
//     32,552 at 127 (6).  __launch_bounds__ holds the registers to 12 CTAs
//     per SM (at most 168 a thread; ptxas -v in chip_smoke.py).
//   * Lane i keeps 32 partials in registers: partial j is the product of
//     slot j, then slots j + 32, j + 64, ... fused onto it in turn (one
//     rounding each); each 32 slots' gathers of x are issued before their
//     products, so 32 gathers per lane are in flight.  Then the tree of 32
//     (partial j + 16 onto j, then 8, ...).  That is the order of a warp
//     per row (lane j's fused chain, then the shuffle tree) and of the
//     streaming kernel past 32 slots: at every width B3 and B5 give the
//     same bits.
//   * Rows of an even width lie an even number of words apart in the
//     stage, so lanes reading the same slot of their rows would meet in
//     few shared-memory banks (16 lanes in one at a multiple of 16 slots).
//     The lanes read such rows' slots in a rotated order instead
//     (wide_row_sum), which puts each lane's read in a bank of its own.
//   * Where it stops.  Past a 32 KiB stage fewer than 6 warps fit an SM.
//     On an H100, B3 on a warp per row was faster from there on, and the
//     wide tiles faster or level below it (chip_smoke.py --only ell_sweep,
//     grid operators of 40^3 and 48^3 nodes: float64 L = 85 | 86, float32
//     L = 127 | 128; PERF.md).  No operator of the repo is that wide.
// Those rows take a warp per row (wide_kernel): lane l reads slots l,
// l + 32, ... straight from memory, 8 warps to a 256-thread block, and the
// lanes' shuffle tree sums them.
#include <algorithm>
#include <atomic>
#include <cstdint>

#include "tg_async.cuh"
#include "tg_common.cuh"

namespace {

constexpr int kWarps = 4;              // warps per CTA of the tile kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kWideWarps = 1;          // warps per CTA of the wide-tile kernel
constexpr int kWideCtas = 12;          // its CTAs per SM that the registers must allow
constexpr int kTileRows = 32;          // rows of a warp tile: lane i sums row i
constexpr int kMaxTileWidth = 32;      // the tile kernel's widest rows
constexpr int kMaxWideStage = 32767;   // bytes of the wide tiles' largest stage: below 32 KiB
constexpr int kWideBlock = 256;
constexpr int kMaxDevices = 64;        // devices whose grid capacities are cached

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

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

// Lane i's sum of a row wider than 32 slots from its stage: 32 partials,
// partial j the product of slot j with slots j + 32, j + 64, ... fused
// onto it in turn, each 32 slots' gathers issued before their products;
// then the tree of 32.  Rotate: the row's width is even, so the 32 lanes'
// rows start an even number of words apart, and lanes reading the same
// slot would meet in few shared-memory banks (all 32 in one at a multiple
// of 32 slots).  Lane i therefore takes each 32 slots in the order i,
// i + 1, ..., i + 31 (mod 32): word i (L + 1) + s of step s, L + 1 odd,
// lies in a bank of its own.  Register p[s] then keeps the chain of slot
// (s + i) mod 32, the same operations in the same order, and the rotation
// back (by 1, 2, 4, 8 and 16 where i has that bit, so that every register
// index is a constant) puts the partials in slot order for the tree.
template <typename T, bool Rotate>
__device__ __forceinline__ T wide_row_sum(const T* vt, const int* ct, const T* __restrict__ x,
                                          int width) {
  const int r = Rotate ? static_cast<int>(threadIdx.x % 32) : 0;
  T p[kTileRows];
#pragma unroll
  for (int s = 0; s < kTileRows; ++s) p[s] = __ldg(x + ct[(s + r) & 31]);
#pragma unroll
  for (int s = 0; s < kTileRows; ++s) p[s] = mul_rn(vt[(s + r) & 31], p[s]);
  for (int l0 = kTileRows; l0 < width; l0 += kTileRows) {
    T q[kTileRows];
#pragma unroll
    for (int s = 0; s < kTileRows; ++s) {
      const int l = l0 + ((s + r) & 31);
      q[s] = l < width ? __ldg(x + ct[l]) : T(0);
    }
#pragma unroll
    for (int s = 0; s < kTileRows; ++s) {
      const int l = l0 + ((s + r) & 31);
      if (l < width) p[s] = fma_rn(vt[l], q[s], p[s]);
    }
  }
  if constexpr (Rotate) {
#pragma unroll
    for (int b = 1; b < kTileRows; b <<= 1) {
      T t[kTileRows];
#pragma unroll
      for (int j = 0; j < kTileRows; ++j) t[j] = p[(j - b) & 31];
      const bool take = (r & b) != 0;
#pragma unroll
      for (int j = 0; j < kTileRows; ++j) p[j] = take ? t[j] : p[j];
    }
  }
  tree_sum<kTileRows / 2>(p);
  return p[0];
}

// Lane i's sum of row i from its stage: the row's `width` values vt and
// columns ct.  G <= 32 (the power of two >= width): all gathers, then the
// products, then the tree of G.  G > 32 (width > 32): wide_row_sum, which
// rotates the slots of an even width.
template <typename T, int G>
__device__ __forceinline__ T row_sum(const T* vt, const int* ct, const T* __restrict__ x,
                                     int width) {
  if constexpr (G <= kTileRows) {
    T p[G];
#pragma unroll
    for (int l = 0; l < G; ++l) p[l] = l < width ? __ldg(x + ct[l]) : T(0);
#pragma unroll
    for (int l = 0; l < G; ++l) p[l] = l < width ? mul_rn(vt[l], p[l]) : T(0);
    tree_sum<G / 2>(p);
    return p[0];
  } else {
    return width & 1 ? wide_row_sum<T, false>(vt, ct, x, width)
                     : wide_row_sum<T, true>(vt, ct, x, width);
  }
}

// The body of both tile kernels: warp w of a CTA of Warps warps walks its
// 32-row tiles, stages each and sums its rows with row_sum<T, G>.
template <typename T, int G, int Warps>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ vals,
                                           const int* __restrict__ cols,
                                           const T* __restrict__ x, const T* __restrict__ f,
                                           T* __restrict__ y, long long n_rows, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t vals_room = static_cast<size_t>(kTileRows) * width * sizeof(T) + 16;
  const size_t stage_bytes = vals_room + static_cast<size_t>(kTileRows) * width * sizeof(int) + 16;
  unsigned char* stage = smem + static_cast<size_t>(warp) * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Warps * stage_bytes) + warp;
  if (lane == 0) {
    mbar_init(full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // where a tile's vals and cols land in the stage: at their address modulo 16
  const size_t vals_at = reinterpret_cast<uintptr_t>(vals) & 15;
  const size_t cols_at = vals_room + (reinterpret_cast<uintptr_t>(cols) & 15);
  const long long n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const long long step = static_cast<long long>(gridDim.x) * Warps;
  const long long first = static_cast<long long>(blockIdx.x) * Warps + warp;
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
      const T sum = row_sum<T, G>(vt, ct, x, width);
      y[row] = f != nullptr ? sum - fr : sum;
    }
    // the stage is refilled next: order these reads before the copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
  }
}

// Rows of at most 32 slots, G the power of two >= width.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ x,
            const T* __restrict__ f, T* __restrict__ y, long long n_rows, int width) {
  walk_tiles<T, G, kWarps>(vals, cols, x, f, y, n_rows, width);
}

// Rows of 33 slots or more whose stage is at most kMaxWideStage bytes.
template <typename T>
__global__ void __launch_bounds__(32 * kWideWarps, kWideCtas)
wide_tile_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                 const T* __restrict__ x, const T* __restrict__ f, T* __restrict__ y,
                 long long n_rows, int width) {
  walk_tiles<T, 2 * kTileRows, kWideWarps>(vals, cols, x, f, y, n_rows, width);
}

// The other rows past 32 slots (see the header): a warp per row, lane l
// summing slots l, l + 32, ..., then the shuffle tree.
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

// The three kernels (see the header).  The library takes the one that
// variant_of picks; tg_spmv_ell_as_* takes the one it is given, so that
// chip_smoke.py --only ell_sweep can time them side by side.
enum class Variant { kTiles = 0, kWideTiles = 1, kWarpPerRow = 2 };

constexpr long long stage_bytes_of(long long width, size_t item) {
  return static_cast<long long>(kTileRows) * width * static_cast<long long>(item + sizeof(int));
}

Variant variant_of(long long width, size_t item) {
  if (width <= kMaxTileWidth) return Variant::kTiles;
  return stage_bytes_of(width, item) <= kMaxWideStage ? Variant::kWideTiles
                                                      : Variant::kWarpPerRow;
}

// Whether kernel `v` can take rows of `width` slots: the tile kernel sums
// at most 32, the wide-tile kernel at least 33.
bool takes(Variant v, long long width) {
  switch (v) {
    case Variant::kTiles: return width <= kMaxTileWidth;
    case Variant::kWideTiles: return width > kMaxTileWidth;
    case Variant::kWarpPerRow: return true;
  }
  return false;
}

// The widest rows variant_of gives a tile kernel (float32, the smaller
// item): the grid cache below holds a slot for each width up to it.
constexpr int kMaxTiledWidth = kMaxWideStage / (kTileRows * (4 + 4));
static_assert(stage_bytes_of(kMaxTiledWidth, 4) <= kMaxWideStage &&
                  stage_bytes_of(kMaxTiledWidth + 1, 4) > kMaxWideStage,
              "kMaxTiledWidth is the widest float32 row of the wide tiles");

int warps_of(Variant v) { return v == Variant::kTiles ? kWarps : kWideWarps; }

int group_of(long long width) {
  int g = 1;
  while (g < width && g < 32) g <<= 1;
  return g;
}

// Dynamic shared memory per CTA of a tile kernel: each warp's stage (a
// 32-row tile's vals and cols, each with 16 bytes of room to land at its
// source's address modulo 16) and its 8-byte mbarrier; 0 for a warp per row.
size_t smem_of(long long width, size_t item, Variant v) {
  if (v == Variant::kWarpPerRow) return 0;
  return static_cast<size_t>(warps_of(v)) * (stage_bytes_of(width, item) + 32 + 8);
}

template <typename T>
const void* entry_of(long long width, Variant v) {
  switch (v) {
    case Variant::kWideTiles: return reinterpret_cast<const void*>(&wide_tile_kernel<T>);
    case Variant::kWarpPerRow: return reinterpret_cast<const void*>(&wide_kernel<T>);
    case Variant::kTiles: break;
  }
  switch (group_of(width)) {
    case 1: return reinterpret_cast<const void*>(&tile_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(&tile_kernel<T, 2>);
    case 4: return reinterpret_cast<const void*>(&tile_kernel<T, 4>);
    case 8: return reinterpret_cast<const void*>(&tile_kernel<T, 8>);
    case 16: return reinterpret_cast<const void*>(&tile_kernel<T, 16>);
    default: return reinterpret_cast<const void*>(&tile_kernel<T, 32>);
  }
}

// CTAs of tile kernel `v` taking `width` that device `dev` holds at once:
// SMs x the occupancy API's CTAs per SM.  The lookup also lets the instance
// use the device's opt-in shared memory.
template <typename T>
cudaError_t look_up_capacity(int dev, long long width, Variant v, int* out) {
  const void* kernel = entry_of<T>(width, v);
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps_of(v),
                                                        smem_of(width, sizeof(T), v));
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) *out = sms * per_sm;
  return err;
}

// The grid of a launch of kernel `v` on the current device: a tile
// kernel's CTAs (at most one warp per tile), or the warp-per-row kernel's
// blocks; minus a CUDA error code on failure.  The capacity of each
// (device, width) that variant_of gives the tile kernels is looked up at
// its first launch and read without a lock after it (a race looks up
// twice and stores the same value); a width only a forced launch gives a
// tile kernel is looked up every time.
template <typename T>
long long grid_of(long long n_rows, long long width, Variant v) {
  if (v == Variant::kWarpPerRow) {
    return static_cast<long long>(tg_blocks(n_rows * 32, kWideBlock));
  }
  static std::atomic<int> known[kMaxDevices][kMaxTiledWidth + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const bool cached =
      dev < kMaxDevices && width <= kMaxTiledWidth && v == variant_of(width, sizeof(T));
  int cap = cached ? known[dev][width].load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    err = look_up_capacity<T>(dev, width, v, &cap);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    if (cached) known[dev][width].store(cap, std::memory_order_relaxed);
  }
  const long long warps = (n_rows + kTileRows - 1) / kTileRows;
  const int per_cta = warps_of(v);
  return std::min<long long>(cap, (warps + per_cta - 1) / per_cta);
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, const void* f, void* y,
           long long n_rows, long long width, Variant v, void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 1 || width > INT32_MAX || !takes(v, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = grid_of<T>(n_rows, width, v);
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
  const unsigned threads = v == Variant::kWarpPerRow ? kWideBlock : 32 * warps_of(v);
  // the instance is picked at run time: launch it by its entry
  void* args[] = {&vv, &cc, &xx, &ff, &yy, &n_rows, &w};
  const cudaError_t err =
      cudaLaunchKernel(entry_of<T>(width, v), dim3(static_cast<unsigned>(grid)), dim3(threads),
                       args, smem_of(width, sizeof(T), v), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// The kernel (0 tiles, 1 wide tiles, 2 a warp per row), the grid and the
// dynamic shared memory per CTA of a launch at (n_rows, width) on the
// current device, for the design figures; the grid is minus a CUDA error
// code on failure.
TG_EXPORT int tg_ell_variant_f32(long long width) {
  return static_cast<int>(variant_of(width, 4));
}

TG_EXPORT int tg_ell_variant_f64(long long width) {
  return static_cast<int>(variant_of(width, 8));
}

TG_EXPORT int tg_ell_grid_f32(long long n_rows, long long width) {
  return static_cast<int>(grid_of<float>(n_rows, width, variant_of(width, 4)));
}

TG_EXPORT int tg_ell_grid_f64(long long n_rows, long long width) {
  return static_cast<int>(grid_of<double>(n_rows, width, variant_of(width, 8)));
}

TG_EXPORT int tg_ell_smem_f32(long long width) {
  return static_cast<int>(smem_of(width, 4, variant_of(width, 4)));
}

TG_EXPORT int tg_ell_smem_f64(long long width) {
  return static_cast<int>(smem_of(width, 8, variant_of(width, 8)));
}

TG_EXPORT int tg_spmv_ell_f32(const void* vals, const void* cols, const void* x, void* y,
                              long long n_rows, long long width, void* stream) {
  return launch<float>(vals, cols, x, nullptr, y, n_rows, width, variant_of(width, 4), stream);
}

TG_EXPORT int tg_spmv_ell_f64(const void* vals, const void* cols, const void* x, void* y,
                              long long n_rows, long long width, void* stream) {
  return launch<double>(vals, cols, x, nullptr, y, n_rows, width, variant_of(width, 8), stream);
}

TG_EXPORT int tg_residual_ell_f32(const void* vals, const void* cols, const void* u,
                                  const void* f, void* y, long long n_rows, long long width,
                                  void* stream) {
  return launch<float>(vals, cols, u, f, y, n_rows, width, variant_of(width, 4), stream);
}

TG_EXPORT int tg_residual_ell_f64(const void* vals, const void* cols, const void* u,
                                  const void* f, void* y, long long n_rows, long long width,
                                  void* stream) {
  return launch<double>(vals, cols, u, f, y, n_rows, width, variant_of(width, 8), stream);
}

// spmv_ell on the kernel `variant` (as tg_ell_variant_*), whatever
// variant_of would pick: for timing the kernels against one another.
TG_EXPORT int tg_spmv_ell_as_f32(const void* vals, const void* cols, const void* x, void* y,
                                 long long n_rows, long long width, long long variant,
                                 void* stream) {
  if (variant < 0 || variant > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(vals, cols, x, nullptr, y, n_rows, width, static_cast<Variant>(variant),
                      stream);
}

TG_EXPORT int tg_spmv_ell_as_f64(const void* vals, const void* cols, const void* x, void* y,
                                 long long n_rows, long long width, long long variant,
                                 void* stream) {
  if (variant < 0 || variant > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(vals, cols, x, nullptr, y, n_rows, width, static_cast<Variant>(variant),
                      stream);
}
