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
//
// Batch: src (B, n_src) gives out (B, rows) on the one shared table in one
// launch.  Block i serves instance b = i % B of row block i / B, so the B
// blocks that read the same table rows run next to each other and the later
// ones find them in L2; the instance offsets b * n_src and b * rows are
// 64-bit (B * n_src may pass 2^31; one instance's slots may not, the table
// being int32).  A single instance takes the instantiation without the
// batch index: with it, the one-instance Reduce at the 3D main-path shape
// ran 0.42 ms against 0.26 ms without (H100 80GB HBM3, 700 W).
#include "tg_common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kBlock)
seg_reduce_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                  T* __restrict__ out, long long n_rows, int width, int n_src, int batch) {
  long long b = 0, block = blockIdx.x;
  if constexpr (kBatched) {
    b = blockIdx.x % batch;
    block = blockIdx.x / batch;
  }
  const long long row = block * kBlock + threadIdx.x;
  if (row >= n_rows) return;
  const int* slots = idx + row * width;
  const T* inst = src + b * n_src;
  T acc = T(0);
  for (int l = 0; l < width; ++l) {
    const int j = __ldg(slots + l);
    if (j < n_src) acc += __ldg(inst + j);
  }
  out[b * n_rows + row] = acc;
}

template <typename T>
int launch(const void* src, const void* idx, void* out, long long n_rows, long long width,
           long long n_src, long long batch, void* stream) {
  if (n_rows <= 0 || batch <= 0) return 0;
  const long long grid = static_cast<long long>(tg_blocks(n_rows, kBlock)) * batch;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = batch == 1 ? seg_reduce_kernel<T, false> : seg_reduce_kernel<T, true>;
  kernel<<<static_cast<unsigned>(grid), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(idx), static_cast<T*>(out), n_rows,
      static_cast<int>(width), static_cast<int>(n_src), static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TG_EXPORT int tg_seg_reduce_f32(const void* src, const void* idx, void* out, long long n_rows,
                                long long width, long long n_src, long long batch,
                                void* stream) {
  return launch<float>(src, idx, out, n_rows, width, n_src, batch, stream);
}

TG_EXPORT int tg_seg_reduce_f64(const void* src, const void* idx, void* out, long long n_rows,
                                long long width, long long n_src, long long batch,
                                void* stream) {
  return launch<double>(src, idx, out, n_rows, width, n_src, batch, stream);
}
