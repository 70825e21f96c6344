// Shared by every kernel library of repro_torch: the C export macro and the
// error-string lookup the Python wrappers use to report a failed launch.
#pragma once

#include <cuda_runtime.h>

#define TG_EXPORT extern "C" __attribute__((visibility("default")))

TG_EXPORT const char* tg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks needed for `work` items at `per_block` items a block.
static inline unsigned tg_blocks(long long work, long long per_block) {
  return static_cast<unsigned>((work + per_block - 1) / per_block);
}
