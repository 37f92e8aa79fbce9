// cylinder_stats — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::cylinder_stats
// (_cylinder_kernel): for each query q with normal n, count the valid targets
// t with d2 = |t-q|^2 < r_proj^2 and d2 |n|^2 - (d.n)^2 < r^2, and sum sqrt(d2)
// over them (majorAxisSampling inner loop, scan_registration.cpp:676-701).
//
// What bounds it on an H100: instruction issue. Every query-target pair
// needs d2 (3 sub, 3 mul, 2 add) and its compare, unfused: the _rn
// intrinsics keep each operation's rounding equal to the plain PyTorch
// version's, so counts agree exactly. At the main path's 12,800 queries x
// 57,600 live targets those ~10 lane-instructions a pair are ~7.4 G, which
// 132 SMs issue at 128 lanes a clock in ~0.22 ms (1.98 GHz). The 67 TFLOP/s
// peak counts an FMA as two operations; unfused, the same 9 operations a
// pair cannot go faster than the issue rate. The inputs are ~1.9 MB,
// nothing at 3.35 TB/s.
//
// Design:
//  * The d2 gate first. For each run of 32 targets a thread records which
//    of its pairs pass d2 < r_proj^2 as bits; d.n, the second gate and the
//    sqrt then run only for the set bits, about 0.2 % of the main path's
//    pairs. A pair that fails the d2 gate adds exactly nothing, so counts
//    are unchanged and the sum only skips +0.0 terms.
//  * Four queries a thread (512 a block), so one 16-byte shared load of a
//    target point serves four pairs.
//  * The target streams through shared memory as float4 points, +inf where
//    invalid, from tiles staged with cp.async one tile ahead
//    (csrc/tile_stream.cuh); tiles with no valid point are skipped after
//    one read of their mask.
//  * t_live (the ring counting sort keeps every valid target below it) is
//    read on the device: no host sync.
//  * The tiles of [0, t_live) are dealt round-robin to S slices along
//    gridDim.y, S chosen so that the grid is about eight blocks an SM (25 x
//    42 at 12,800 queries; 64 registers a thread let eight stay resident). Each
//    block writes its partial (count, sum) to a [S, Q] scratch and a second
//    kernel adds the slices in slice order: the result does not depend on
//    block scheduling, and there are no float atomics.
#include <cuda_runtime.h>
#include <math.h>

#include "tile_stream.cuh"

namespace {

constexpr int kQ = 4;                          // queries a thread
constexpr int kBlockQ = kQ * plo::kThreads;    // queries a block
constexpr int kBlocksPerSM = 8;
constexpr int kMaxSplits = 64;

__global__ void __launch_bounds__(plo::kThreads)
cylinder_partial(const float* __restrict__ query, const float* __restrict__ normal, int q,
                 const float* __restrict__ target,
                 const unsigned char* __restrict__ target_valid, int t,
                 const int* __restrict__ t_live, float rp2, float r2,
                 int* __restrict__ part_cnt, float* __restrict__ part_sum) {
  __shared__ plo::TileBuffers<> sm;

  float qx[kQ], qy[kQ], qz[kQ], nx[kQ], ny[kQ], nz[kQ], n2[kQ], sum[kQ];
  int cnt[kQ];
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
    n2[u] = __fadd_rn(__fadd_rn(__fmul_rn(nx[u], nx[u]), __fmul_rn(ny[u], ny[u])),
                      __fmul_rn(nz[u], nz[u]));
    cnt[u] = 0;
    sum[u] = 0.f;
  }

  int live = t;
  if (t_live != nullptr) live = min(max(*t_live, 0), t);

  // Per 32 targets: first the d2 gate of every pair, as bits (the cheap
  // test nearly all pairs fail); then the rest of the work for the set bits.
  auto body = [&](const float4* pts, int) {
#pragma unroll 1
    for (int g = 0; g < plo::kTile; g += 32) {
      unsigned near[kQ];
      plo::gate_bits<kQ>(pts, g, qx, qy, qz, rp2, near);
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        while (near[u] != 0u) {
          const float4 p = pts[g + __ffs(near[u]) - 1];
          near[u] &= near[u] - 1u;
          const float dx = __fsub_rn(qx[u], p.x);
          const float dy = __fsub_rn(qy[u], p.y);
          const float dz = __fsub_rn(qz[u], p.z);
          const float d2 = plo::d2_rn(dx, dy, dz);
          const float dn = __fadd_rn(__fadd_rn(__fmul_rn(dx, nx[u]), __fmul_rn(dy, ny[u])),
                                     __fmul_rn(dz, nz[u]));
          const float p2 = __fsub_rn(__fmul_rn(d2, n2[u]), __fmul_rn(dn, dn));
          if (p2 < r2) {
            cnt[u] += 1;
            sum[u] = __fadd_rn(sum[u], __fsqrt_rn(d2));
          }
        }
      }
    }
  };
  plo::stream_tiles(sm, target, target_valid, live, body);

#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int qi = blockIdx.x * kBlockQ + u * plo::kThreads + threadIdx.x;
    if (qi < q) {
      part_cnt[blockIdx.y * q + qi] = cnt[u];
      part_sum[blockIdx.y * q + qi] = sum[u];
    }
  }
}

__global__ void cylinder_reduce(const int* __restrict__ part_cnt,
                                const float* __restrict__ part_sum, int q, int splits,
                                int* __restrict__ cnt, float* __restrict__ sum) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  int c = 0;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) {
    c += part_cnt[k * q + qi];
    s = __fadd_rn(s, part_sum[k * q + qi]);
  }
  cnt[qi] = c;
  sum[qi] = s;
}

}  // namespace

// The slice count S for q queries on the current device: the wrapper sizes
// the [S, q] scratch with it.
extern "C" int plo_cylinder_splits(int q) {
  return plo::splits_for<kBlockQ, kBlocksPerSM, kMaxSplits>(q);
}

// query, normal [q, 3] f32; target [t, 3] f32 and target_valid [t] bool,
// both 16-byte aligned; t_live: device int32 scalar or NULL (= t);
// part_cnt/part_sum: [plo_cylinder_splits(q), q] scratch; cnt [q] i32,
// sum [q] f32. Returns cudaGetLastError() after the launches.
extern "C" int plo_cylinder_stats(const void* query, const void* normal, int q,
                                  const void* target, const void* target_valid,
                                  int t, const void* t_live, float rp2, float r2,
                                  void* part_cnt, void* part_sum, void* cnt,
                                  void* sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = plo::splits_for<kBlockQ, kBlocksPerSM, kMaxSplits>(q);
  const dim3 grid((q + kBlockQ - 1) / kBlockQ, splits);
  cylinder_partial<<<grid, plo::kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(normal), q,
      static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t,
      static_cast<const int*>(t_live), rp2, r2, static_cast<int*>(part_cnt),
      static_cast<float*>(part_sum));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cylinder_reduce<<<(q + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(part_cnt), static_cast<const float*>(part_sum), q, splits,
      static_cast<int*>(cnt), static_cast<float*>(sum));
  return static_cast<int>(cudaGetLastError());
}
