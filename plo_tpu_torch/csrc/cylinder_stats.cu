// cylinder_stats — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::cylinder_stats
// (_cylinder_kernel): for each query q with normal n, count the valid targets
// t with d2 = |t-q|^2 < r_proj^2 and d2 |n|^2 - (d.n)^2 < r^2, and sum sqrt(d2)
// over them (majorAxisSampling inner loop, scan_registration.cpp:676-701).
//
// What bounds it on an H100: arithmetic. About 22 FP32 operations per
// query-target pair; at the main path's 12,800 queries x ~57,600 live targets
// that is ~16 GFLOP of non-tensor f32 work (~0.25 ms at 67 TFLOP/s), against
// ~1.6 MB of inputs.
//
// Design:
//  * One thread per query, 128 queries per block. The target streams through
//    shared memory in tiles; every thread reads the same tile point at once,
//    which shared memory serves as a broadcast.
//  * The target range [0, t_live) is cut into SPLITS equal slices along
//    gridDim.y, so 12,800 queries still fill the card (100 x 8 blocks).
//    Each block writes its partial (count, sum) to a [SPLITS, Q] scratch, and
//    a second kernel adds the slices in a fixed order: the result does not
//    depend on block scheduling (no atomics).
//  * t_live is read from device memory, so the caller never syncs to learn
//    it. The ring counting sort puts every valid target below t_live.
//  * Invalid targets become +inf coordinates, which fail the first gate
//    (the Pallas kernel's padding). The gate arithmetic uses the _rn
//    intrinsics so that nvcc cannot contract it into FMAs: d2, d.n and the
//    d2|n|^2 - (d.n)^2 identity round exactly as the plain PyTorch version
//    does, so counts agree exactly and do not flip at the r gate.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kSplits = 8;

__global__ void cylinder_partial(const float* __restrict__ query,
                                 const float* __restrict__ normal, int q,
                                 const float* __restrict__ target,
                                 const unsigned char* __restrict__ target_valid,
                                 int t, const int* __restrict__ t_live,
                                 float rp2, float r2,
                                 int* __restrict__ part_cnt,
                                 float* __restrict__ part_sum) {
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
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)),
                             __fmul_rn(nz, nz));

  int live = t;
  if (t_live != nullptr) live = min(max(*t_live, 0), t);
  const int slice = (live + kSplits - 1) / kSplits;
  const int begin = blockIdx.y * slice;
  const int end = min(begin + slice, live);

  int cnt = 0;
  float sum = 0.f;
  for (int base = begin; base < end; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int ti = base + j;
      const bool ok = ti < end && target_valid[ti];
      tx[j] = ok ? target[3 * ti + 0] : INFINITY;
      ty[j] = ok ? target[3 * ti + 1] : INFINITY;
      tz[j] = ok ? target[3 * ti + 2] : INFINITY;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float dx = __fsub_rn(qx, tx[j]);
      const float dy = __fsub_rn(qy, ty[j]);
      const float dz = __fsub_rn(qz, tz[j]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float dn = __fadd_rn(__fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)),
                                 __fmul_rn(dz, nz));
      const float p2 = __fsub_rn(__fmul_rn(d2, n2), __fmul_rn(dn, dn));
      // d2 = inf (padding) fails the first gate, so its inf/nan p2 never counts.
      if (d2 < rp2 && p2 < r2) {
        cnt += 1;
        sum += __fsqrt_rn(d2);
      }
    }
  }
  if (live_q) {
    part_cnt[blockIdx.y * q + qi] = cnt;
    part_sum[blockIdx.y * q + qi] = sum;
  }
}

__global__ void cylinder_reduce(const int* __restrict__ part_cnt,
                                const float* __restrict__ part_sum, int q,
                                int* __restrict__ cnt, float* __restrict__ sum) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  int c = 0;
  float s = 0.f;
  for (int k = 0; k < kSplits; ++k) {
    c += part_cnt[k * q + qi];
    s += part_sum[k * q + qi];
  }
  cnt[qi] = c;
  sum[qi] = s;
}

}  // namespace

extern "C" int plo_cylinder_splits() { return kSplits; }

// query, normal [q, 3] f32; target [t, 3] f32; target_valid [t] bool;
// t_live: device int32 scalar or NULL (= t); part_cnt/part_sum: [splits, q]
// scratch; cnt [q] i32, sum [q] f32. Returns cudaGetLastError() after the
// launches.
extern "C" int plo_cylinder_stats(const void* query, const void* normal, int q,
                                  const void* target, const void* target_valid,
                                  int t, const void* t_live, float rp2, float r2,
                                  void* part_cnt, void* part_sum, void* cnt,
                                  void* sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((q + kThreads - 1) / kThreads, kSplits);
  cylinder_partial<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(normal), q,
      static_cast<const float*>(target),
      static_cast<const unsigned char*>(target_valid), t,
      static_cast<const int*>(t_live), rp2, r2, static_cast<int*>(part_cnt),
      static_cast<float*>(part_sum));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cylinder_reduce<<<(q + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(part_cnt), static_cast<const float*>(part_sum), q,
      static_cast<int*>(cnt), static_cast<float*>(sum));
  return static_cast<int>(cudaGetLastError());
}
