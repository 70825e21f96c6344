// Shared-memory barriers and 1-D bulk copies (the TMA's cp.async.bulk) for
// the kernels of spmv_ell.cu and spmv_ell_stream.cu: a tile lands in shared
// memory at its source's address modulo 16, the aligned middle by one bulk
// copy that completes on an mbarrier, the unaligned ends word by word.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same copy with an L2 cache policy (from l2_evict_first).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// An L2 cache policy for data read once: its lines are evicted first, so a
// stream larger than L2 does not push out what is read again (a gathered x).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// One lane's part of a stage fill: copy `bytes` bytes from src to dst, where
// dst and src agree modulo 16 (both are 4-byte aligned).
struct Part {
  unsigned char* dst = nullptr;
  const unsigned char* src = nullptr;
  unsigned bytes = 0;
};

// Each lane of the filling warp holds one part (or none).  A bulk copy needs
// 16-byte-aligned ends, so the lane copies its part's unaligned head and tail
// (at most 12 bytes each) word by word, fences those plain writes against
// later bulk writes to the same bytes, and bulk-copies the aligned middle.
// The barrier gets one arrival (count 1), from lane 0 with the warp's total
// bulk bytes, after the warp syncs so that lane 0's release covers every
// lane's plain writes; the bulk copies are issued after it, with the L2
// cache policy `hint` if one is given.
template <typename... Hint>
__device__ __forceinline__ void fill(const Part& part, uint64_t* bar, int lane, Hint... hint) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(part.src);
  const uintptr_t e = a + part.bytes;
  uintptr_t lo = (a + 15) & ~uintptr_t(15);
  uintptr_t hi = e & ~uintptr_t(15);
  if (hi <= lo) lo = hi = e;  // too short: all plain
  const unsigned head = static_cast<unsigned>(lo - a);
  const unsigned tail = static_cast<unsigned>(hi - a);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(part.src);
  uint32_t* dst = reinterpret_cast<uint32_t*>(part.dst);
  for (unsigned w = 0; w < head / 4; ++w) dst[w] = src[w];
  for (unsigned w = tail / 4; w < part.bytes / 4; ++w) dst[w] = src[w];
  if (head != 0 || tail != part.bytes) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const unsigned bulk = static_cast<unsigned>(hi - lo);
  const unsigned total = __reduce_add_sync(0xffffffffu, bulk);
  if (lane == 0) mbar_arrive_expect_tx(bar, total);
  __syncwarp();
  if (bulk) bulk_copy(part.dst + head, part.src + head, bulk, bar, hint...);
}
