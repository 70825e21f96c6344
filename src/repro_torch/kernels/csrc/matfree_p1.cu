// The matrix-free P1 diffusion action with its gather, for the matrix-free
// operator's context store: per element e,
//
//   y_e = c_e * G (G^T x_e),   c_e = factor * scale * sum_q w_q |detJ_eq| rho_eq,
//
// with G = grad[e, 0] (k x d) and x_e = x[cell_dofs[e, :]].  On a P1
// simplex the geometry is affine: the context holds the same gradients at
// every quadrature point, so the quadrature sum folds into c_e and the
// kernel reads one gradient block of the Q that the context stores.
//
// Replaces no Pallas kernel: the JAX package (repro/core/operator.py,
// _diffusion_act) and the port's einsum path contract the context with
// einsum, which torch lowered on the card to batched cuBLAS gemv calls and
// elementwise kernels over (E, Q, d) intermediates.
//
// Bound on an H100: memory.  A tetrahedron reads its 4x3 gradients (96 B
// in float64), Q measures (32 B at Q = 4), its coefficient (8 B for a
// per-cell field), 4 int64 indices (32 B), and writes y_e (32 B): about
// 200 B of device memory for about 65 flops; x (7.3 MB at 912,673 DoFs)
// is gathered from L2.
//
// Design: a block walks tiles of kTile elements, grid-stride, one thread
// an element.  The block copies a tile's index rows and gradient blocks
// (runs of k*d values at the context's element stride, a-major or i-major)
// into shared memory, neighbouring threads on neighbouring addresses, so
// that every sector fetched is used whole; the copies are unrolled, so a
// thread's loads are all in flight before its first store to shared
// memory.  Each thread forms c_e from its element's measures and
// coefficients, read through their strides (a per-cell coefficient
// expanded over Q has q-stride 0).  The block then gathers x_e from the
// staged indices, one index a thread, each thread contracts in registers
// and puts y_e back into shared memory, and the block stores the tile's
// (kTile, k) rows as one contiguous run.  Rows in shared memory have an
// odd length, so the per-thread reads hit distinct banks.  What hides the
// memory's latency is the number of tiles in flight: the launch bounds
// hold a thread to 64 registers, so eight blocks share an SM, and the grid
// is as many blocks as the SMs hold.  On an H100 at 5,308,416 tetrahedra
// this took 0.387 ms an apply, against 0.436 ms at the 91 registers the
// compiler chose unbounded, 0.486 ms for a cp.async double buffer of the
// next tile (96 registers, five blocks an SM) and 0.462 ms for one tile a
// block over a grid of every tile.
#include "tg_common.cuh"

namespace {

constexpr int kTile = 128;       // elements a tile, threads a block
constexpr int kBlocksPerSm = 8;  // the launch bounds' floor of resident blocks

struct Strides {
  long long grad_e;          // between two elements' gradient blocks
  long long grad_a, grad_i;  // inside a block: (d, 1) or (1, k), k*d values in a run
  long long detj_e, detj_q;
  long long rho_e, rho_q;
};

// f(i) for i = threadIdx.x + r * kTile below `limit`, r < R, unrolled
template <int R, typename F>
__device__ __forceinline__ void strided(int limit, F&& f) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * kTile;
    if (i < limit) f(i);
  }
}

template <typename T, int K, int D>
__global__ void __launch_bounds__(kTile, kBlocksPerSm)
p1_diffusion_kernel(const T* __restrict__ x, const long long* __restrict__ cell_dofs,
                    const T* __restrict__ grad, const T* __restrict__ detj,
                    const T* __restrict__ w, const T* __restrict__ rho,
                    const T* __restrict__ scale, T factor, T* __restrict__ out,
                    long long n_elem, int n_q, Strides s) {
  constexpr int KD = K * D;
  constexpr int GP = KD | 1;  // odd row lengths in shared memory
  constexpr int XP = K | 1;
  __shared__ T s_g[kTile * GP];
  __shared__ T s_x[kTile * XP];  // x_e, then y_e
  __shared__ long long s_idx[kTile * K];
  const T sv = scale != nullptr ? __ldg(scale) : T(1);
  const long long n_tiles = (n_elem + kTile - 1) / kTile;
  const int sa = static_cast<int>(s.grad_a), si = static_cast<int>(s.grad_i);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long e0 = tile * kTile;
    const long long left = n_elem - e0;
    const int n = left < kTile ? static_cast<int>(left) : kTile;

    const long long* idx = cell_dofs + e0 * K;
    strided<K>(n * K, [&](int i) { s_idx[i] = __ldcs(idx + i); });
    strided<KD>(n * KD, [&](int i) {
      const int el = i / KD, j = i - el * KD;
      s_g[el * GP + j] = __ldcs(grad + (e0 + el) * s.grad_e + j);
    });
    // c_e in the quadrature's own order: (w_q |detJ_q|) rho_q summed from q = 0
    // (a missing coefficient reads 1, which leaves each product as it is)
    T c = T(0);
    if (threadIdx.x < n) {
      const long long e = e0 + threadIdx.x;
      for (int q = 0; q < n_q; ++q) {
        const T r = rho != nullptr ? __ldcs(rho + e * s.rho_e + q * s.rho_q) : T(1);
        c += (__ldg(w + q) * __ldcs(detj + e * s.detj_e + q * s.detj_q)) * r;
      }
      c = c * factor;
      if (scale != nullptr) c = c * sv;
    }
    __syncthreads();  // the tile's indices and gradients are in shared memory

    strided<K>(n * K, [&](int i) { s_x[(i / K) * XP + i % K] = __ldg(x + s_idx[i]); });
    __syncthreads();  // x_e gathered

    if (threadIdx.x < n) {
      const T* g = s_g + threadIdx.x * GP;
      T* xy = s_x + threadIdx.x * XP;
      T t[D];
#pragma unroll
      for (int i = 0; i < D; ++i) t[i] = T(0);
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const T xa = xy[a];
#pragma unroll
        for (int i = 0; i < D; ++i) t[i] += g[a * sa + i * si] * xa;
      }
#pragma unroll
      for (int a = 0; a < K; ++a) {
        T y = T(0);
#pragma unroll
        for (int i = 0; i < D; ++i) y += g[a * sa + i * si] * t[i];
        xy[a] = c * y;
      }
    }
    __syncthreads();  // y_e in shared memory

    T* dst = out + e0 * K;
    strided<K>(n * K, [&](int i) { __stcs(dst + i, s_x[(i / K) * XP + i % K]); });
    __syncthreads();  // the next tile overwrites shared memory
  }
}

template <typename T, int K, int D>
cudaError_t launch_shape(const T* x, const long long* cell_dofs, const T* grad, const T* detj,
                         const T* w, const T* rho, const T* scale, T factor, T* out,
                         long long n_elem, int n_q, Strides s, cudaStream_t stream) {
  // blocks resident on one SM, asked once for each instantiation
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, p1_diffusion_kernel<T, K, D>, kTile,
                                                      0) != cudaSuccess) {
      n = 1;
    }
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_elem + kTile - 1) / kTile;
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > tiles) blocks = tiles;
  p1_diffusion_kernel<T, K, D><<<static_cast<unsigned>(blocks), kTile, 0, stream>>>(
      x, cell_dofs, grad, detj, w, rho, scale, factor, out, n_elem, n_q, s);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* cell_dofs, const void* grad, const void* detj,
           const void* w, const void* rho, const void* scale, void* out, long long n_elem,
           long long dim, long long n_q, long long grad_e, long long grad_a, long long grad_i,
           long long detj_e, long long detj_q, long long rho_e, long long rho_q, double factor,
           void* stream) {
  if (n_elem <= 0) return 0;
  if (n_q <= 0 || n_q > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Strides s{grad_e, grad_a, grad_i, detj_e, detj_q, rho_e, rho_q};
  const T* xx = static_cast<const T*>(x);
  const long long* cd = static_cast<const long long*>(cell_dofs);
  const T* g = static_cast<const T*>(grad);
  const T* dj = static_cast<const T*>(detj);
  const T* ww = static_cast<const T*>(w);
  const T* r = static_cast<const T*>(rho);
  const T* sc = static_cast<const T*>(scale);
  T* o = static_cast<T*>(out);
  const int q = static_cast<int>(n_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    return static_cast<int>(launch_shape<T, 4, 3>(xx, cd, g, dj, ww, r, sc, static_cast<T>(factor),
                                                  o, n_elem, q, s, st));
  }
  if (dim == 2) {
    return static_cast<int>(launch_shape<T, 3, 2>(xx, cd, g, dj, ww, r, sc, static_cast<T>(factor),
                                                  o, n_elem, q, s, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

TG_EXPORT int tg_matfree_p1_diffusion_f32(const void* x, const void* cell_dofs, const void* grad,
                                          const void* detj, const void* w, const void* rho,
                                          const void* scale, void* out, long long n_elem,
                                          long long dim, long long n_q, long long grad_e,
                                          long long grad_a, long long grad_i, long long detj_e,
                                          long long detj_q, long long rho_e, long long rho_q,
                                          double factor, void* stream) {
  return launch<float>(x, cell_dofs, grad, detj, w, rho, scale, out, n_elem, dim, n_q, grad_e,
                       grad_a, grad_i, detj_e, detj_q, rho_e, rho_q, factor, stream);
}

TG_EXPORT int tg_matfree_p1_diffusion_f64(const void* x, const void* cell_dofs, const void* grad,
                                          const void* detj, const void* w, const void* rho,
                                          const void* scale, void* out, long long n_elem,
                                          long long dim, long long n_q, long long grad_e,
                                          long long grad_a, long long grad_i, long long detj_e,
                                          long long detj_q, long long rho_e, long long rho_q,
                                          double factor, void* stream) {
  return launch<double>(x, cell_dofs, grad, detj, w, rho, scale, out, n_elem, dim, n_q, grad_e,
                        grad_a, grad_i, detj_e, detj_q, rho_e, rho_q, factor, stream);
}
