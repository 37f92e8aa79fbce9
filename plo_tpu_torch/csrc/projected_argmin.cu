// projected_argmin — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::projected_argmin
// (_projected_kernel): for each query q with normal n, the argmin over valid
// targets t of p2 = |(t - q) x n|^2 among those with d2 = |t - q|^2 < eg2
// and p2 < pg2 — the projected-distance anchor search (plane-ICP's quirk
// gates |d| < r^2, proj < r_proj, laser_odometry.cpp:316-334). Ties go to the
// lowest index, -1 when no target passes. Returns proj = sqrt(p2),
// idx, valid = idx >= 0.
//
// What bounds it on an H100: instruction issue and, at 2,000 queries, the
// parallelism to spread it. Every pair needs d2 and its compare, unfused
// (~10 lane-instructions); at plane-ICP's 2,000 queries x 57,600 valid
// targets that is ~1.2 G, ~0.04 ms of issue on 132 SMs. The cross product
// and p2 are needed only past the d2 gate (0.5 % of the pairs at the 2.25 m
// gate), but a warp pays them whenever one of its lanes' pairs passes.
// The inputs are ~1.7 MB, ~0.5 us at 3.35 TB/s.
//
// Design:
//  * Four queries a thread (512 a block), so one 16-byte shared load of a
//    target point serves four pairs. 2,000 queries are four such blocks; the
//    target's tiles are dealt round-robin to S slices along gridDim.y, S
//    chosen so that the grid is about four blocks an SM (4 x 128 at 2,000
//    queries), 16 warps an SM to hide the latency of the shared loads.
//  * The target streams through shared memory as float4 points, +inf where
//    invalid, from tiles staged with cp.async one tile ahead
//    (csrc/tile_stream.cuh). Tiles with no valid point (the padding past the
//    filtered cloud's valid prefix) are skipped after one read of their mask.
//  * The d2 gate first: for each run of 32 targets a thread records which
//    of its pairs pass as bits, then computes the cross product and p2 for
//    the set bits only.
//  * One launch: the slices' minima merge by an atomicMin on a packed
//    (p2 bits, idx) key, and the last block of each query block writes proj,
//    idx and valid (tile_stream.cuh's merge; one memset before the launch).
//  * The gates eg2 and pg2 come in as f32 values the caller squared in f32
//    (the XLA path's rounding: f32(0.8)^2 = 0.64000005, not 0.64). d2, the
//    cross product and p2 use the _rn intrinsics in the plain version's
//    order — c = (dy*nz - dz*ny, dz*nx - dx*nz, dx*ny - dy*nx),
//    p2 = (cx*cx + cy*cy) + cz*cz — so that nvcc cannot contract them into
//    FMAs: gates, argmin and proj are bit-equal to the plain version's.
#include <cuda_runtime.h>
#include <math.h>

#include "tile_stream.cuh"

namespace {

constexpr int kQ = 4;                          // queries a thread
constexpr int kBlockQ = kQ * plo::kThreads;    // queries a block
constexpr int kBlocksPerSM = 4;
constexpr int kMaxSplits = 128;

__global__ void __launch_bounds__(plo::kThreads)
projected_kernel(const float* __restrict__ query, const float* __restrict__ normal, int q,
                 const float* __restrict__ target,
                 const unsigned char* __restrict__ target_valid, int t, float eg2,
                 float pg2, unsigned long long* __restrict__ keys,
                 unsigned* __restrict__ tickets, float* __restrict__ proj,
                 int* __restrict__ idx, unsigned char* __restrict__ valid) {
  __shared__ plo::TileBuffers<> sm;

  float qx[kQ], qy[kQ], qz[kQ], nx[kQ], ny[kQ], nz[kQ], best[kQ];
  int best_idx[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = blockIdx.x * kBlockQ + u * plo::kThreads + threadIdx.x;
    const bool live_q = qi < q;
    qx[u] = live_q ? query[3 * qi + 0] : 0.f;
    qy[u] = live_q ? query[3 * qi + 1] : 0.f;
    qz[u] = live_q ? query[3 * qi + 2] : 0.f;
    nx[u] = live_q ? normal[3 * qi + 0] : 0.f;
    ny[u] = live_q ? normal[3 * qi + 1] : 0.f;
    nz[u] = live_q ? normal[3 * qi + 2] : 0.f;
    best[u] = INFINITY;
    best_idx[u] = -1;
  }

  // Per 32 targets: first the d2 gate of every pair, as bits; then the
  // cross product and p2 for the set bits only, in ascending target order
  // (so the strict < keeps the lowest index among equal p2).
  auto body = [&](const float4* pts, int base) {
#pragma unroll 1
    for (int g = 0; g < plo::kTile; g += 32) {
      unsigned near[kQ];
      plo::gate_bits<kQ>(pts, g, qx, qy, qz, eg2, near);
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        while (near[u] != 0u) {
          const int k = __ffs(near[u]) - 1;
          near[u] &= near[u] - 1u;
          const float4 p = pts[g + k];
          const float dx = __fsub_rn(p.x, qx[u]);
          const float dy = __fsub_rn(p.y, qy[u]);
          const float dz = __fsub_rn(p.z, qz[u]);
          const float cx = __fsub_rn(__fmul_rn(dy, nz[u]), __fmul_rn(dz, ny[u]));
          const float cy = __fsub_rn(__fmul_rn(dz, nx[u]), __fmul_rn(dx, nz[u]));
          const float cz = __fsub_rn(__fmul_rn(dx, ny[u]), __fmul_rn(dy, nx[u]));
          const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                     __fmul_rn(cz, cz));
          if (p2 < pg2 && p2 < best[u]) {
            best[u] = p2;
            best_idx[u] = base + g + k;
          }
        }
      }
    }
  };
  plo::stream_tiles(sm, target, target_valid, t, body);

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
      proj[qi] = m.found ? __fsqrt_rn(m.v) : INFINITY;
      idx[qi] = m.found ? m.idx : -1;
      valid[qi] = m.found;
    }
  }
}

}  // namespace

// The scratch plo_projected_argmin takes for q queries, in 8-byte words.
extern "C" int plo_projected_scratch(int q) { return plo::merge_scratch_words<kBlockQ>(q); }

// query, normal [q, 3] f32; target [t, 3] f32 and target_valid [t] bool,
// both 16-byte aligned; eg2, pg2: the squared gates in f32; scratch:
// plo_projected_scratch(q) 8-byte words, set here before the launch;
// proj [q] f32, idx [q] i32, valid [q] bool.
// Returns the first error of the memset and the launch.
extern "C" int plo_projected_argmin(const void* query, const void* normal, int q,
                                    const void* target, const void* target_valid,
                                    int t, float eg2, float pg2, void* scratch, void* proj,
                                    void* idx, void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((q + kBlockQ - 1) / kBlockQ, plo::splits_for<kBlockQ, kBlocksPerSM, kMaxSplits>(q));
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, 8 * static_cast<size_t>(plo_projected_scratch(q)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  projected_kernel<<<grid, plo::kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(normal), q,
      static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t, eg2, pg2, keys,
      reinterpret_cast<unsigned*>(keys + q), static_cast<float*>(proj), static_cast<int*>(idx),
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}
