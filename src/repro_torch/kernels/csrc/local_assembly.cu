// Stage-I Batch-Map for P1 simplices: K_e = |e| * rho_e * G G^T, with the
// constant physical gradients G from the closed-form adjugate inverse of the
// 2x2 / 3x3 Jacobian.
//
// Replaces the Pallas TPU kernel repro/kernels/local_assembly.py:
// local_stiffness_p1 (_tri_kernel, _tet_kernel); same arithmetic, term by term.
//
// Bound on an H100: memory.  A tetrahedron reads 12 + 1 values and writes 16
// (232 bytes in float64) for about 150 flops, some 0.65 flop/byte, far under
// the card's float64 balance point of about 10 flop/byte.
//
// Design: one thread per element, reading the array-of-structs (E, k, d)
// coordinates as they are (the TPU kernel's transpose to (k*d, E) lanes is
// not needed here).  A thread's own coordinates and its output tile are
// contiguous runs of 96 / 128 bytes, so a warp touching them directly would
// issue strided accesses; each block therefore stages its elements' inputs
// and outputs through shared memory and moves them with coalesced loads and
// stores.  The ragged tail is masked, not padded with identity simplices.
#include "tg_common.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T>
__device__ __forceinline__ void p1_tri(const T* c, T rho, T* out) {
  const T x0 = c[0], y0 = c[1], x1 = c[2], y1 = c[3], x2 = c[4], y2 = c[5];
  const T e1x = x1 - x0, e1y = y1 - y0;
  const T e2x = x2 - x0, e2y = y2 - y0;
  const T det = e1x * e2y - e2x * e1y;
  const T inv_det = T(1) / det;
  // G_a = J^{-T} g_a with J = [[e1x, e2x], [e1y, e2y]]
  const T g1x = e2y * inv_det, g1y = -e2x * inv_det;
  const T g2x = -e1y * inv_det, g2y = e1x * inv_det;
  const T gx[3] = {-(g1x + g2x), g1x, g2x};
  const T gy[3] = {-(g1y + g2y), g1y, g2y};
  const T scale = T(0.5) * fabs(det) * rho;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) out[a * 3 + b] = scale * (gx[a] * gx[b] + gy[a] * gy[b]);
  }
}

template <typename T>
__device__ __forceinline__ void p1_tet(const T* c, T rho, T* out) {
  // J columns are the edge vectors p_a - p_0, a = 1..3: j<row><col>
  const T j00 = c[3] - c[0], j10 = c[4] - c[1], j20 = c[5] - c[2];
  const T j01 = c[6] - c[0], j11 = c[7] - c[1], j21 = c[8] - c[2];
  const T j02 = c[9] - c[0], j12 = c[10] - c[1], j22 = c[11] - c[2];
  const T det = j00 * (j11 * j22 - j12 * j21) - j01 * (j10 * j22 - j12 * j20) +
                j02 * (j10 * j21 - j11 * j20);
  const T inv_det = T(1) / det;
  // G_a (a = 1..3) is row a-1 of J^{-1} = adj(J) / det
  T g[4][3];
  g[1][0] = (j11 * j22 - j12 * j21) * inv_det;
  g[1][1] = (j02 * j21 - j01 * j22) * inv_det;
  g[1][2] = (j01 * j12 - j02 * j11) * inv_det;
  g[2][0] = (j12 * j20 - j10 * j22) * inv_det;
  g[2][1] = (j00 * j22 - j02 * j20) * inv_det;
  g[2][2] = (j02 * j10 - j00 * j12) * inv_det;
  g[3][0] = (j10 * j21 - j11 * j20) * inv_det;
  g[3][1] = (j01 * j20 - j00 * j21) * inv_det;
  g[3][2] = (j00 * j11 - j01 * j10) * inv_det;
#pragma unroll
  for (int i = 0; i < 3; ++i) g[0][i] = -(g[1][i] + g[2][i] + g[3][i]);
  const T scale = T(1.0 / 6.0) * fabs(det) * rho;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[a * 4 + b] = scale * (g[a][0] * g[b][0] + g[a][1] * g[b][1] + g[a][2] * g[b][2]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
p1_stiffness_kernel(const T* __restrict__ coords, const T* __restrict__ rho,
                    T* __restrict__ out, long long n_elem) {
  constexpr int K = D + 1, KD = K * D, KK = K * K;
  __shared__ T s_in[kBlock * KD];
  __shared__ T s_out[kBlock * KK];
  const long long e0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long left = n_elem - e0;
  const int n = left < kBlock ? static_cast<int>(left) : kBlock;

  const T* src = coords + e0 * KD;
  for (int i = threadIdx.x; i < n * KD; i += kBlock) s_in[i] = src[i];
  __syncthreads();
  if (threadIdx.x < n) {
    const T r = rho[e0 + threadIdx.x];
    if constexpr (D == 2) {
      p1_tri<T>(s_in + threadIdx.x * KD, r, s_out + threadIdx.x * KK);
    } else {
      p1_tet<T>(s_in + threadIdx.x * KD, r, s_out + threadIdx.x * KK);
    }
  }
  __syncthreads();
  T* dst = out + e0 * KK;
  for (int i = threadIdx.x; i < n * KK; i += kBlock) dst[i] = s_out[i];
}

template <typename T>
int launch(const void* coords, const void* rho, void* out, long long n_elem, long long dim,
           void* stream) {
  if (n_elem <= 0) return 0;
  const unsigned blocks = tg_blocks(n_elem, kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* c = static_cast<const T*>(coords);
  const T* r = static_cast<const T*>(rho);
  T* o = static_cast<T*>(out);
  if (dim == 2) {
    p1_stiffness_kernel<T, 2><<<blocks, kBlock, 0, s>>>(c, r, o, n_elem);
  } else if (dim == 3) {
    p1_stiffness_kernel<T, 3><<<blocks, kBlock, 0, s>>>(c, r, o, n_elem);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TG_EXPORT int tg_local_stiffness_p1_f32(const void* coords, const void* rho, void* out,
                                        long long n_elem, long long dim, void* stream) {
  return launch<float>(coords, rho, out, n_elem, dim, stream);
}

TG_EXPORT int tg_local_stiffness_p1_f64(const void* coords, const void* rho, void* out,
                                        long long n_elem, long long dim, void* stream) {
  return launch<double>(coords, rho, out, n_elem, dim, stream);
}
