// cp_async.cuh — the asynchronous global-to-shared copies (sm_80 and later)
// that csrc/tile_stream.cuh stages target tiles with.
#pragma once
#include <cuda_runtime.h>

namespace plo {

// Copies `src_bytes` (0..16) bytes from `gmem` to `smem` and zero-fills the
// rest of the 16; both addresses 16-byte aligned. Bypasses L1 (.cg).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

// Closes the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace plo
