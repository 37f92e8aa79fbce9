// fps_ranks — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel plo_tpu/ops/pallas_nn.py::fps_ranks
// (_fps_kernel): a farthest-first traversal of every bin of a [B, C] slot
// table in one launch. The seed is the lowest occupied slot (rank 0); each
// step i picks, per bin, the slot with the largest squared distance to the
// picked set (lowest index on ties) and gives it rank i; slots never picked
// keep max_rank. Semantics are those of the while_loop in
// plo_tpu/ops/sampling.py::fps_rank_within_bins.
//
// What bounds it on an H100: latency, not bytes or operations. At the main
// path's B=64, C=1024 and up to 200 steps the work is ~1.3 MB and ~130 M
// f32 operations (microseconds at the card's rates), but every step is a
// block-wide argmax that depends on the one before.
//
// Design: one block per bin, so all bins run at once on separate SMs and a
// step needs no grid-wide sync. The bin's coordinates and running min-d2
// live in shared memory; each thread owns the slots tid, tid+blockDim, ...
// and alone reads and writes their min-d2, so only the argmax needs
// barriers (warp shuffles, then one warp over the per-warp winners). All
// steps run inside the launch and the step count is read from device
// memory, so the caller never syncs. The d2 arithmetic uses the _rn
// intrinsics (no FMA contraction) so that ties and picks match the plain
// PyTorch version exactly.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide (max value, lowest index among ties). Every thread gets the
// result. sv/si: shared scratch of 32 entries.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  for (int off = 16; off > 0; off >>= 1)
    take_better(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                __shfl_xor_sync(0xffffffffu, i, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      take_better(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                  __shfl_xor_sync(0xffffffffu, i, off));
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();  // sv/si are rewritten by the next call
}

__device__ __forceinline__ float d2_rn(float x, float y, float z, float sx,
                                       float sy, float sz) {
  const float dx = __fsub_rn(x, sx);
  const float dy = __fsub_rn(y, sy);
  const float dz = __fsub_rn(z, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void fps_kernel(const float* __restrict__ table_xyz,
                           const float* __restrict__ table_occ, int c,
                           const int* __restrict__ steps, int max_rank,
                           int* __restrict__ ranks) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + c;
  float* zs = ys + c;
  float* md = zs + c;  // running min d2; -inf = not a candidate
  __shared__ float sv[32];
  __shared__ int si[32];

  const int bin = blockIdx.x;
  const float* xyz = table_xyz + static_cast<size_t>(bin) * c * 3;
  const float* occ = table_occ + static_cast<size_t>(bin) * c;
  int* rk = ranks + static_cast<size_t>(bin) * c;

  // Load the bin; seed = lowest occupied slot (argmax of occupancy).
  float v = -INFINITY;
  int idx = INT_MAX;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    xs[j] = xyz[3 * j + 0];
    ys[j] = xyz[3 * j + 1];
    zs[j] = xyz[3 * j + 2];
    take_better(v, idx, occ[j] > 0.5f ? 1.f : 0.f, j);
  }
  block_argmax(v, idx, sv, si);  // also publishes xs/ys/zs
  const bool any_occ = v > 0.f;
  const int first = any_occ ? idx : 0;
  const float fx = xs[first], fy = ys[first], fz = zs[first];
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const bool is_first = j == first;
    md[j] = (occ[j] > 0.5f && !is_first) ? d2_rn(xs[j], ys[j], zs[j], fx, fy, fz)
                                         : -INFINITY;
    rk[j] = (is_first && any_occ) ? 0 : max_rank;
  }

  const int n = *steps;
  for (int i = 1; i < n; ++i) {
    v = -INFINITY;
    idx = INT_MAX;
    for (int j = threadIdx.x; j < c; j += blockDim.x) take_better(v, idx, md[j], j);
    block_argmax(v, idx, sv, si);
    // No candidate left: every later step would change nothing either.
    if (!(v > -INFINITY)) break;
    const float sx = xs[idx], sy = ys[idx], sz = zs[idx];
    if (threadIdx.x == 0) rk[idx] = i;
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      const float m = md[j];
      // Non-candidates stay -inf: min(-inf, d2) = -inf.
      if (m > -INFINITY)
        md[j] = (j == idx) ? -INFINITY : fminf(m, d2_rn(xs[j], ys[j], zs[j], sx, sy, sz));
    }
  }
}

}  // namespace

// table_xyz [b, c, 3] f32; table_occ [b, c] f32 (occupied where > 0.5);
// steps: device int32 scalar (ranks 0..steps-1 are assigned); ranks [b, c]
// i32 out. Returns cudaGetLastError() after the launch.
extern "C" int plo_fps_ranks(const void* table_xyz, const void* table_occ, int b,
                             int c, const void* steps, int max_rank, void* ranks,
                             void* stream) {
  const size_t smem = 4 * static_cast<size_t>(c) * sizeof(float);
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table_xyz), static_cast<const float*>(table_occ),
      c, static_cast<const int*>(steps), max_rank, static_cast<int*>(ranks));
  return static_cast<int>(cudaGetLastError());
}
