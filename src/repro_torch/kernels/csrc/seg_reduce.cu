// Stage-II Sparse-Reduce as a padded gather-sum with no atomics:
//   out[n] = sum_l src[idx[n, l]]   over slots with idx[n, l] < n_src,
// where the (rows, L) int32 table lists, per global entry, the positions of
// its local contributions in vec(K_local) in increasing order, padded with
// the sentinel n_src.  The sum order is fixed by the table, so the result is
// deterministic (an index_add_ with atomics is not).
//
// Replaces the Pallas TPU kernel repro/kernels/seg_reduce.py: seg_reduce.
//
// Bound on an H100: memory.  Each output reads L table slots and gathers up
// to L scattered source values for one add each; at the 3D Poisson main path
// (nnz = 4.0 M, L = 24) the table alone is 386 MB.
//
// Design: one thread per output row, reading its row of the table and
// skipping sentinel slots.  The source is read in place: the TPU wrapper's
// concatenation of a zero sentinel (a copy of all E*k^2 values) is not
// needed, because the sentinel test replaces the read.  The gathers go
// through the read-only path.
#include "tg_common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
seg_reduce_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                  T* __restrict__ out, long long n_rows, int width, int n_src) {
  const long long row = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n_rows) return;
  const int* slots = idx + row * width;
  T acc = T(0);
  for (int l = 0; l < width; ++l) {
    const int j = __ldg(slots + l);
    if (j < n_src) acc += __ldg(src + j);
  }
  out[row] = acc;
}

template <typename T>
int launch(const void* src, const void* idx, void* out, long long n_rows, long long width,
           long long n_src, void* stream) {
  if (n_rows <= 0) return 0;
  seg_reduce_kernel<T><<<tg_blocks(n_rows, kBlock), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx), static_cast<T*>(out), n_rows,
      static_cast<int>(width), static_cast<int>(n_src));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TG_EXPORT int tg_seg_reduce_f32(const void* src, const void* idx, void* out, long long n_rows,
                                long long width, long long n_src, void* stream) {
  return launch<float>(src, idx, out, n_rows, width, n_src, stream);
}

TG_EXPORT int tg_seg_reduce_f64(const void* src, const void* idx, void* out, long long n_rows,
                                long long width, long long n_src, void* stream) {
  return launch<double>(src, idx, out, n_rows, width, n_src, stream);
}
