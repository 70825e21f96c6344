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
//
// Design: a group of G lanes per row, G the power of two >= L (at most 32),
// so that the lanes of a warp read consecutive vals / cols words: coalesced
// streaming of the two big operands.  x (2.2 MB at the main path) stays in
// L2 and is gathered through the read-only path.  The group sums with warp
// shuffles; the residual is one subtraction in the same pass.
#include "tg_common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T, int G>
__global__ void __launch_bounds__(kBlock)
ell_kernel(const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ x,
           const T* __restrict__ f, T* __restrict__ y, long long n_rows, int width) {
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long row = t / G;
  const int lane = static_cast<int>(threadIdx.x % G);
  T acc = T(0);
  if (row < n_rows) {
    const long long base = row * width;
    for (int l = lane; l < width; l += G) acc += vals[base + l] * __ldg(x + cols[base + l]);
  }
  // every lane of the warp reaches the shuffles (rows past the end add 0)
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  if (lane == 0 && row < n_rows) y[row] = f != nullptr ? acc - f[row] : acc;
}

template <typename T, int G>
void launch_group(const T* vals, const int* cols, const T* x, const T* f, T* y, long long n_rows,
                  int width, cudaStream_t s) {
  ell_kernel<T, G><<<tg_blocks(n_rows * G, kBlock), kBlock, 0, s>>>(vals, cols, x, f, y, n_rows,
                                                                    width);
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, const void* f, void* y,
           long long n_rows, long long width, void* stream) {
  if (n_rows <= 0) return 0;
  const T* v = static_cast<const T*>(vals);
  const int* c = static_cast<const int*>(cols);
  const T* xx = static_cast<const T*>(x);
  const T* ff = static_cast<const T*>(f);
  T* yy = static_cast<T*>(y);
  const int w = static_cast<int>(width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int g = 1;
  while (g < w && g < 32) g <<= 1;
  switch (g) {
    case 1: launch_group<T, 1>(v, c, xx, ff, yy, n_rows, w, s); break;
    case 2: launch_group<T, 2>(v, c, xx, ff, yy, n_rows, w, s); break;
    case 4: launch_group<T, 4>(v, c, xx, ff, yy, n_rows, w, s); break;
    case 8: launch_group<T, 8>(v, c, xx, ff, yy, n_rows, w, s); break;
    case 16: launch_group<T, 16>(v, c, xx, ff, yy, n_rows, w, s); break;
    default: launch_group<T, 32>(v, c, xx, ff, yy, n_rows, w, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
