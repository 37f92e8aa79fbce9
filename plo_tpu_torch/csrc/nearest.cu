// nearest — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::nearest
// (_nearest_kernel): for each query, the minimum over valid targets of the
// coordinate-difference squared distance, and its index — ties go to the
// lowest index, -1 when no target is valid (the k=1 anchor search of
// plane-ICP, laser_odometry.cpp:343-360). valid = idx >= 0 & d2 <= radius^2.
//
// What bounds it on an H100: arithmetic. About 10 FP32 operations per
// query-target pair (3 sub, 3 mul, 2 add, compare, select); at plane-ICP's
// 2,000 queries x ~57,600 valid targets that is ~1.2 GFLOP (~0.017 ms at
// 67 TFLOP/s), against ~1.7 MB of inputs.
//
// Design:
//  * One thread per query, 128 queries per block. The target streams through
//    shared memory in 256-point tiles; every thread reads the same tile point
//    at once, which shared memory serves as a broadcast.
//  * 2,000 queries are only 16 blocks, so the target's tiles are dealt out
//    round-robin to kSplits slices along gridDim.y (16 x 32 blocks): every
//    slice gets its share of the valid prefix, wherever it ends. Each block
//    writes its partial (best, idx) to a [kSplits, Q] scratch; a second
//    kernel merges the slices in slice order, taking a partial when its
//    (d2, idx) is lexicographically smaller — so a tie goes to the lowest
//    index, as in both JAX forms. No atomics, no host sync: the result does
//    not depend on block scheduling.
//  * A tile with no valid target is skipped after its load
//    (__syncthreads_or): the filtered cloud's valid points lie in a prefix of
//    its 131,072 slots, so the padding costs one read of the mask.
//  * Invalid targets become +inf coordinates, which never win the strict <.
//    d2 is computed with the _rn intrinsics in the plain version's order,
//    (dx*dx + dy*dy) + dz*dz, so that nvcc cannot contract it into FMAs: the
//    kernel's d2 is bit-equal to the plain PyTorch version's, and so are its
//    argmin and its radius test.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kSplits = 32;

__global__ void nearest_partial(const float* __restrict__ query, int q,
                                const float* __restrict__ target,
                                const unsigned char* __restrict__ target_valid,
                                int t, float* __restrict__ part_d2,
                                int* __restrict__ part_idx) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live_q = qi < q;
  const float qx = live_q ? query[3 * qi + 0] : 0.f;
  const float qy = live_q ? query[3 * qi + 1] : 0.f;
  const float qz = live_q ? query[3 * qi + 2] : 0.f;

  float best = INFINITY;
  int best_idx = -1;
  const int n_tiles = (t + kTile - 1) / kTile;
  for (int tile = blockIdx.y; tile < n_tiles; tile += kSplits) {
    const int base = tile * kTile;
    __syncthreads();
    int any = 0;
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int ti = base + j;
      const bool ok = ti < t && target_valid[ti];
      tx[j] = ok ? target[3 * ti + 0] : INFINITY;
      ty[j] = ok ? target[3 * ti + 1] : INFINITY;
      tz[j] = ok ? target[3 * ti + 2] : INFINITY;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float dx = __fsub_rn(qx, tx[j]);
      const float dy = __fsub_rn(qy, ty[j]);
      const float dz = __fsub_rn(qz, tz[j]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      // +inf padding gives d2 = inf (or nan), which fails the strict <.
      if (d2 < best) {
        best = d2;
        best_idx = base + j;
      }
    }
  }
  if (live_q) {
    part_d2[blockIdx.y * q + qi] = best;
    part_idx[blockIdx.y * q + qi] = best_idx;
  }
}

__global__ void nearest_merge(const float* __restrict__ part_d2,
                              const int* __restrict__ part_idx, int q, float r2,
                              float* __restrict__ d2, int* __restrict__ idx,
                              unsigned char* __restrict__ valid) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  float best = INFINITY;
  int best_idx = -1;
  for (int s = 0; s < kSplits; ++s) {
    const float v = part_d2[s * q + qi];
    const int i = part_idx[s * q + qi];
    // A slice that found nothing holds (inf, -1) and never wins.
    if (i >= 0 && (v < best || (v == best && i < best_idx))) {
      best = v;
      best_idx = i;
    }
  }
  d2[qi] = best;
  idx[qi] = best_idx;
  valid[qi] = best_idx >= 0 && best <= r2;
}

}  // namespace

extern "C" int plo_nearest_splits() { return kSplits; }

// query [q, 3] f32; target [t, 3] f32; target_valid [t] bool; r2: the
// radius squared in f32 (inf for no radius); part_d2/part_idx: [splits, q]
// scratch; d2 [q] f32, idx [q] i32, valid [q] bool. Returns
// cudaGetLastError() after the launches.
extern "C" int plo_nearest(const void* query, int q, const void* target,
                           const void* target_valid, int t, float r2,
                           void* part_d2, void* part_idx, void* d2, void* idx,
                           void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((q + kThreads - 1) / kThreads, kSplits);
  nearest_partial<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(query), q, static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t,
      static_cast<float*>(part_d2), static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_merge<<<(q + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_d2), static_cast<const int*>(part_idx), q,
      r2, static_cast<float*>(d2), static_cast<int*>(idx),
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}
