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
// What bounds it on an H100: arithmetic. About 27 FP32 operations per
// query-target pair (3 sub; the cross product's 6 mul and 3 sub; 3 mul and
// 2 add for each of p2 and d2; 3 compares, select); at 2,000 queries x
// ~57,600 valid targets ~3.1 GFLOP (~0.046 ms at 67 TFLOP/s), against
// ~1.7 MB of inputs.
//
// Design (as csrc/nearest.cu):
//  * One thread per query, 128 queries per block; the target streams through
//    shared memory in 256-point tiles, dealt round-robin to kSplits slices
//    along gridDim.y. A second kernel merges the [kSplits, Q] partials in
//    slice order by (p2, idx), so a tie goes to the lowest index; no atomics.
//  * All-invalid tiles are skipped after their load (__syncthreads_or).
//  * The cross product and p2 are computed only where the d2 gate passes:
//    a pair that fails it can never be taken, so the branch changes no
//    result, and at plane-ICP's 2.25 m euclidean gate most pairs of a warp
//    fail it together.
//  * The gates eg2 and pg2 come in as f32 values the caller squared in f32
//    (the XLA path's rounding: f32(0.8)^2 = 0.64000005, not 0.64). d2, the
//    cross product and p2 use the _rn intrinsics in the plain version's
//    order — c = (dy*nz - dz*ny, dz*nx - dx*nz, dx*ny - dy*nx),
//    p2 = (cx*cx + cy*cy) + cz*cz — so that nvcc cannot contract them into
//    FMAs: gates, argmin and proj are bit-equal to the plain version's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr int kSplits = 32;

__global__ void projected_partial(const float* __restrict__ query,
                                  const float* __restrict__ normal, int q,
                                  const float* __restrict__ target,
                                  const unsigned char* __restrict__ target_valid,
                                  int t, float eg2, float pg2,
                                  float* __restrict__ part_p2,
                                  int* __restrict__ part_idx) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ float tz[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live_q = qi < q;
  const float qx = live_q ? query[3 * qi + 0] : 0.f;
  const float qy = live_q ? query[3 * qi + 1] : 0.f;
  const float qz = live_q ? query[3 * qi + 2] : 0.f;
  const float nx = live_q ? normal[3 * qi + 0] : 0.f;
  const float ny = live_q ? normal[3 * qi + 1] : 0.f;
  const float nz = live_q ? normal[3 * qi + 2] : 0.f;

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
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float dx = __fsub_rn(tx[j], qx);
      const float dy = __fsub_rn(ty[j], qy);
      const float dz = __fsub_rn(tz[j], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      // +inf padding gives d2 = inf (or nan), which fails the gate.
      if (d2 < eg2) {
        const float cx = __fsub_rn(__fmul_rn(dy, nz), __fmul_rn(dz, ny));
        const float cy = __fsub_rn(__fmul_rn(dz, nx), __fmul_rn(dx, nz));
        const float cz = __fsub_rn(__fmul_rn(dx, ny), __fmul_rn(dy, nx));
        const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                   __fmul_rn(cz, cz));
        if (p2 < pg2 && p2 < best) {
          best = p2;
          best_idx = base + j;
        }
      }
    }
  }
  if (live_q) {
    part_p2[blockIdx.y * q + qi] = best;
    part_idx[blockIdx.y * q + qi] = best_idx;
  }
}

__global__ void projected_merge(const float* __restrict__ part_p2,
                                const int* __restrict__ part_idx, int q,
                                float* __restrict__ proj, int* __restrict__ idx,
                                unsigned char* __restrict__ valid) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  float best = INFINITY;
  int best_idx = -1;
  for (int s = 0; s < kSplits; ++s) {
    const float v = part_p2[s * q + qi];
    const int i = part_idx[s * q + qi];
    if (i >= 0 && (v < best || (v == best && i < best_idx))) {
      best = v;
      best_idx = i;
    }
  }
  // A taken p2 passed p2 < pg2, so it is finite exactly when idx >= 0.
  proj[qi] = best_idx >= 0 ? __fsqrt_rn(best) : INFINITY;
  idx[qi] = best_idx;
  valid[qi] = best_idx >= 0;
}

}  // namespace

extern "C" int plo_projected_splits() { return kSplits; }

// query, normal [q, 3] f32; target [t, 3] f32; target_valid [t] bool;
// eg2, pg2: the squared gates in f32; part_p2/part_idx: [splits, q] scratch;
// proj [q] f32, idx [q] i32, valid [q] bool. Returns cudaGetLastError()
// after the launches.
extern "C" int plo_projected_argmin(const void* query, const void* normal, int q,
                                    const void* target, const void* target_valid,
                                    int t, float eg2, float pg2, void* part_p2,
                                    void* part_idx, void* proj, void* idx,
                                    void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((q + kThreads - 1) / kThreads, kSplits);
  projected_partial<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(normal), q,
      static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t, eg2, pg2,
      static_cast<float*>(part_p2), static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  projected_merge<<<(q + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_p2), static_cast<const int*>(part_idx), q,
      static_cast<float*>(proj), static_cast<int*>(idx),
      static_cast<unsigned char*>(valid));
  return static_cast<int>(cudaGetLastError());
}
