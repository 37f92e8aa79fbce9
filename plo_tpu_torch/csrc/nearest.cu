// nearest — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::nearest
// (_nearest_kernel): for each query, the minimum over valid targets of the
// coordinate-difference squared distance, and its index — ties go to the
// lowest index, -1 when no target is valid (the k=1 anchor search of
// plane-ICP, laser_odometry.cpp:343-360). valid = idx >= 0 & d2 <= radius^2.
//
// What bounds it on an H100: instruction issue. Every pair needs its d2,
// unfused so that it rounds as the plain version does (3 sub, 3 mul, 2 add),
// and its part of the minimum; at plane-ICP's 2,000 queries x ~57,600 valid
// targets that is ~1.1 G lane-instructions, ~0.03 ms of issue on 132 SMs.
// The inputs are ~1.7 MB, ~0.5 us at 3.35 TB/s.
//
// Design:
//  * Two queries a thread (256 a block), so one 16-byte shared load of a
//    target point serves two pairs. 2,000 queries are eight such blocks; the
//    target's tiles are dealt round-robin to S slices along gridDim.y, S
//    chosen so that the grid is about four blocks an SM (8 x 66 at 2,000
//    queries). Against four queries a thread (4 x 128) a block streams twice
//    the tiles (~6.8 live ones, not 3 or 4), which spreads its fixed costs
//    and evens out the slices: the slowest slice holds 7 tiles, 3 % above
//    the mean, where it held 4, 14 % above.
//  * The target streams through shared memory as float4 points, +inf where
//    invalid, from tiles staged with cp.async one tile ahead
//    (csrc/tile_stream.cuh). Tiles with no valid point (the padding past the
//    filtered cloud's valid prefix) are skipped after one read of their mask.
//  * Per pair, only a minimum: over each run of 32 targets a thread keeps the
//    run's minimum d2 per query (fminf, one instruction a pair). Where the
//    run's minimum beats the query's best (strict <, so the earliest run
//    holding the best value wins), the thread notes the run; the index is
//    recovered once per window of kWindow tiles, while they are still in
//    shared memory, by a rescan of the noted run that takes the lowest
//    position whose d2 == the best. A warp rescans for a query only where
//    one of its lanes noted a run, and at the main path's shapes a block's
//    slice is one window, so a query pays one rescan of 32 pairs a block.
//    d2 is recomputed by the same operations, so it compares bit for bit.
//  * One launch: the slices' minima merge by an atomicMin on a packed
//    (d2 bits, idx) key, and the last block of each query block writes d2,
//    idx and valid (tile_stream.cuh's merge; one memset before the launch).
//  * d2 uses the _rn intrinsics in the plain version's order,
//    (dx*dx + dy*dy) + dz*dz with d = q - t, so that nvcc cannot contract it
//    into FMAs: the kernel's d2 is bit-equal to the plain PyTorch version's,
//    and so are its argmin and its radius test (radius^2 squared in f32 by
//    the caller).
#include <cuda_runtime.h>
#include <math.h>

#include "tile_stream.cuh"

namespace {

constexpr int kQ = 2;                          // queries a thread
constexpr int kBlockQ = kQ * plo::kThreads;    // queries a block
constexpr int kBlocksPerSM = 4;
constexpr int kMaxSplits = 128;
constexpr int kWindow = 8;                     // tiles kept for the rescan

__device__ __forceinline__ float pair_d2(const float4& p, float qx, float qy, float qz) {
  return plo::d2_rn(__fsub_rn(qx, p.x), __fsub_rn(qy, p.y), __fsub_rn(qz, p.z));
}

__global__ void __launch_bounds__(plo::kThreads)
nearest_kernel(const float* __restrict__ query, int q, const float* __restrict__ target,
               const unsigned char* __restrict__ target_valid, int t, float r2,
               unsigned long long* __restrict__ keys, unsigned* __restrict__ tickets,
               float* __restrict__ d2, int* __restrict__ idx,
               unsigned char* __restrict__ valid) {
  __shared__ plo::TileBuffers<kWindow> sm;

  // best: the query's minimum d2 so far; best_idx: its index, once recovered;
  // run_slot / run_base: the noted run (its first point's place in sm.pts
  // and its target index), -1 when none is pending.
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int best_idx[kQ], run_slot[kQ], run_base[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = blockIdx.x * kBlockQ + u * plo::kThreads + threadIdx.x;
    const bool live_q = qi < q;
    qx[u] = live_q ? query[3 * qi + 0] : 0.f;
    qy[u] = live_q ? query[3 * qi + 1] : 0.f;
    qz[u] = live_q ? query[3 * qi + 2] : 0.f;
    best[u] = INFINITY;
    best_idx[u] = -1;
    run_slot[u] = -1;
    run_base[u] = 0;
  }

  auto body = [&](const float4* pts, int base) {
    const int slot0 = static_cast<int>(pts - sm.pts);
#pragma unroll 1
    for (int g = 0; g < plo::kTile; g += 32) {
      float run_min[kQ];
#pragma unroll
      for (int u = 0; u < kQ; ++u) run_min[u] = INFINITY;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 p = pts[g + k];
#pragma unroll
        for (int u = 0; u < kQ; ++u) run_min[u] = fminf(run_min[u], pair_d2(p, qx[u], qy[u], qz[u]));
      }
      // +inf padding never beats: a run of it has run_min = inf.
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        if (run_min[u] < best[u]) {
          best[u] = run_min[u];
          run_slot[u] = slot0 + g;
          run_base[u] = base + g;
        }
      }
    }
  };
  // The lowest position of the noted run whose d2 equals the best. Runs
  // start 512 bytes apart, so lanes reading the same position of different
  // runs would hit the same banks: lane l reads position (l + k) % 32 at
  // step k, and the matches are collected as bits.
  const int lane = threadIdx.x & 31;
  auto rescan = [&]() {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (!__any_sync(0xffffffffu, run_slot[u] >= 0)) continue;
      const float4* run = sm.pts + max(run_slot[u], 0);
      unsigned eq = 0u;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int at = (lane + k) & 31;
        if (pair_d2(run[at], qx[u], qy[u], qz[u]) == best[u]) eq |= 1u << at;
      }
      if (run_slot[u] >= 0) best_idx[u] = run_base[u] + __ffs(eq) - 1;
      run_slot[u] = -1;
    }
  };
  plo::stream_tiles(sm, target, target_valid, t, body, rescan);

#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = blockIdx.x * kBlockQ + u * plo::kThreads + threadIdx.x;
    if (qi < q && best_idx[u] >= 0) plo::fold_key(keys, qi, best[u], best_idx[u]);
  }
  if (!plo::last_slice(tickets)) return;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = blockIdx.x * kBlockQ + u * plo::kThreads + threadIdx.x;
    if (qi < q) {
      const plo::Merged m = plo::merged(keys, qi);
      d2[qi] = m.found ? m.v : INFINITY;
      idx[qi] = m.found ? m.idx : -1;
      valid[qi] = m.found && m.v <= r2;
    }
  }
}

}  // namespace

// The scratch plo_nearest takes for q queries, in 8-byte words.
extern "C" int plo_nearest_scratch(int q) { return plo::merge_scratch_words<kBlockQ>(q); }

// query [q, 3] f32; target [t, 3] f32 and target_valid [t] bool, both
// 16-byte aligned; r2: the radius squared in f32 (inf for no radius);
// scratch: plo_nearest_scratch(q) 8-byte words, set here before the launch;
// d2 [q] f32, idx [q] i32, valid [q] bool.
// Returns the first error of the memset and the launch.
extern "C" int plo_nearest(const void* query, int q, const void* target,
                           const void* target_valid, int t, float r2, void* scratch,
                           void* d2, void* idx, void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((q + kBlockQ - 1) / kBlockQ, plo::splits_for<kBlockQ, kBlocksPerSM, kMaxSplits>(q));
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, 8 * static_cast<size_t>(plo_nearest_scratch(q)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  nearest_kernel<<<grid, plo::kThreads, 0, s>>>(
      static_cast<const float*>(query), q, static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t, r2, keys,
      reinterpret_cast<unsigned*>(keys + q), static_cast<float*>(d2), static_cast<int*>(idx),
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}
