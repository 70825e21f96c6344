// Stage-II Sparse-Reduce as a segment-table gather-sum with no atomics:
//   out[b, n] = sum_{k = ptr[n]}^{ptr[n+1]-1} src[b, slots[k]]
// where `slots` (n_src int32) lists the positions of every local
// contribution in vec(K_local), grouped by global entry n and in increasing
// order within a group, and `ptr` (rows + 1 int32) holds each group's start.
// Each sum is taken in slot order from 0, so the result is deterministic
// (an index_add_ with atomics is not) and bit-equal to one thread adding the
// row's values one after another.
//
// Replaces the Pallas TPU kernel repro/kernels/seg_reduce.py: seg_reduce,
// which gathers from a padded (rows, L) table whose pad slots point at a
// zero sentinel.
//
// Bound on an H100: memory.  The Reduce's work is to read the source once
// (8 B a slot), write the output once (8 B a row), and read one int32 slot
// index per contribution and one int32 offset per row: at the 3D Poisson
// main path (rows 4,018,753, n_src 25,165,824) 350 MB, 0.105 ms at
// 3.35 TB/s; with B instances the source and output count B times and the
// table once.  Each slot is one add, far below the card's rate.
//
// Design.  The host cuts the rows into runs (`runs`, n_runs + 1 row
// offsets) of at most kThreads rows and kStage slots each, and one CTA
// takes a run:
//  1. it stages the run's slot indices [ptr[r0], ptr[r1]) in shared memory
//     with coalesced loads, kPer independent loads per thread;
//  2. for each instance b it gathers the source values of all its slots into
//     shared memory, every thread issuing its kPer gathers before it uses
//     any of them;
//  3. then thread t sums row r0 + t from shared memory in slot order and
//     writes it (neighbouring threads, neighbouring outputs).
// What this does about the padded kernel's three costs: the table holds no
// sentinels (the padded table at the main path was 74 % pad, 386 MB against
// 117 MB now); the gathers of a whole run are in flight at once instead of
// one dependent index-then-value step at a time per thread; and with a batch
// the run's indices are staged once and reused for every instance, so the
// table crosses DRAM once per batch instead of once per instance.  The
// instance offsets b * n_src and b * rows are 64-bit (B * n_src may pass
// 2^31; one instance's slots may not, the table being int32).
//
// A run whose slots pass the stage (one row with more than kStage
// contributions, which the host's cut gives a run of its own) is summed
// straight from global memory, a thread per row, in the same order.
#include "tg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                     // stage slots per thread
constexpr int kStage = kThreads * kPer;     // slots a run may stage

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_reduce_kernel(const T* __restrict__ src, const int* __restrict__ slots,
                  const int* __restrict__ ptr, const int* __restrict__ runs,
                  T* __restrict__ out, long long n_rows, long long n_src, int batch) {
  __shared__ T vals[kStage];
  __shared__ int idx[kStage];
  const int tid = threadIdx.x;
  const int r0 = __ldg(runs + blockIdx.x);
  const int n_run = __ldg(runs + blockIdx.x + 1) - r0;
  const int base = __ldg(ptr + r0);
  const int count = __ldg(ptr + r0 + n_run) - base;

  if (count > kStage) {
    for (int b = 0; b < batch; ++b) {
      const T* inst = src + b * n_src;
      for (int r = tid; r < n_run; r += kThreads) {
        const int end = __ldg(ptr + r0 + r + 1);
        T acc = T(0);
        for (int k = __ldg(ptr + r0 + r); k < end; ++k) acc += __ldg(inst + __ldg(slots + k));
        out[b * n_rows + r0 + r] = acc;
      }
    }
    return;
  }

  int j[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = i * kThreads + tid;
    j[i] = s < count ? __ldg(slots + base + s) : 0;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = i * kThreads + tid;
    if (s < count) idx[s] = j[i];
  }
  __syncthreads();

  for (int b = 0; b < batch; ++b) {
    const T* inst = src + b * n_src;
    T v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = i * kThreads + tid;
      v[i] = s < count ? __ldg(inst + idx[s]) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = i * kThreads + tid;
      if (s < count) vals[s] = v[i];
    }
    __syncthreads();
    for (int r = tid; r < n_run; r += kThreads) {
      const int end = __ldg(ptr + r0 + r + 1) - base;
      T acc = T(0);
      for (int k = __ldg(ptr + r0 + r) - base; k < end; ++k) acc += vals[k];
      out[b * n_rows + r0 + r] = acc;
    }
    if (b + 1 < batch) __syncthreads();
  }
}

template <typename T>
int launch(const void* src, const void* slots, const void* ptr, const void* runs, void* out,
           long long n_runs, long long n_rows, long long n_src, long long batch,
           void* stream) {
  if (n_runs <= 0 || batch <= 0) return 0;
  if (n_runs > 0x7fffffffLL || batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  seg_reduce_kernel<T><<<static_cast<unsigned>(n_runs), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const int*>(slots), static_cast<const int*>(ptr),
      static_cast<const int*>(runs), static_cast<T*>(out), n_rows, n_src,
      static_cast<int>(batch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

TG_EXPORT int tg_seg_reduce_f32(const void* src, const void* slots, const void* ptr,
                                const void* runs, void* out, long long n_runs,
                                long long n_rows, long long n_src, long long batch,
                                void* stream) {
  return launch<float>(src, slots, ptr, runs, out, n_runs, n_rows, n_src, batch, stream);
}

TG_EXPORT int tg_seg_reduce_f64(const void* src, const void* slots, const void* ptr,
                                const void* runs, void* out, long long n_runs,
                                long long n_rows, long long n_src, long long batch,
                                void* stream) {
  return launch<double>(src, slots, ptr, runs, out, n_runs, n_rows, n_src, batch, stream);
}

// The kernel's stage, for the host's cut into runs: the most slots a run
// may hold and still be staged in shared memory, and the rows its CTA sums
// at one row per thread.
TG_EXPORT int tg_seg_reduce_stage_slots() { return kStage; }
TG_EXPORT int tg_seg_reduce_stage_rows() { return kThreads; }
