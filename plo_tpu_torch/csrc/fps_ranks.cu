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
// path's B=64, C=1024 and up to 200 steps the work is ~1.3 MB and ~160 M
// f32 operations (microseconds at the card's rates), but every step is a
// block-wide argmax that depends on the one before; the time is the steps'
// chain of dependent instructions and barriers.
//
// Design: one block of 512 threads per bin, so all bins run at once on
// separate SMs and a step needs no grid-wide sync. What a step costs on its
// critical path:
//  * Slots in registers. Thread t owns slots t, t + 512, ... (kSlots of them,
//    a template parameter: 2 at C = 1024, at most 6) and keeps their x, y, z
//    and running min-d2 in registers. A read-only copy of the bin's rows in
//    shared memory serves the broadcast of the picked point.
//  * 512 threads: at C = 1024 they measured faster than 256 and 128
//    (PERF.md): a thread's share of the pass is shorter (2 slots), and the
//    wider reduction over 16 warps costs less than that saves.
//  * One fused pass a step: each owned min-d2 is updated against the point
//    picked last step, and in the same loop the thread folds its candidate
//    for this step (largest min-d2, lowest slot on ties).
//  * The argmax by redux.sync. A candidate's min-d2 is >= 0 and a
//    non-candidate's is -inf, so the float's bits, read as a signed int,
//    order like its value and every non-candidate lies below every
//    candidate. A warp takes the max key with __reduce_max_sync, then the
//    lowest slot among the lanes at that key with __reduce_min_sync. Lane 0
//    of each warp writes the pair to a shared array double-buffered by step
//    parity; after one __syncthreads every warp reduces the per-warp pairs
//    itself, so a step has one barrier.
// All steps run inside the launch, the step count is read from device
// memory (the caller never syncs), and a step that finds no candidate ends
// the loop: no later step could change a rank. The d2 arithmetic uses the
// _rn intrinsics in the plain version's order (no FMA contraction), so ties
// and picks match the plain PyTorch version exactly.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;

// (x - sx)^2 + (y - sy)^2 + (z - sz)^2 as ((dx*dx + dy*dy) + dz*dz), each
// operation rounded as PyTorch rounds it.
__device__ __forceinline__ float d2_rn(float x, float y, float z, float sx,
                                       float sy, float sz) {
  const float dx = __fsub_rn(x, sx);
  const float dy = __fsub_rn(y, sy);
  const float dz = __fsub_rn(z, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Block-wide (largest key, lowest slot among its ties); every thread gets
// it. buf: one entry per warp, not read or written by the previous or the
// next call (the caller alternates two).
__device__ __forceinline__ int2 block_pick(int key, int slot, int2* buf) {
  constexpr unsigned kAll = 0xffffffffu;
  const int wkey = __reduce_max_sync(kAll, key);
  const unsigned wslot = __reduce_min_sync(kAll, key == wkey ? static_cast<unsigned>(slot) : UINT_MAX);
  const int lane = threadIdx.x & 31;
  if (lane == 0) buf[threadIdx.x >> 5] = make_int2(wkey, static_cast<int>(wslot));
  __syncthreads();
  const int2 e = lane < kThreads / 32 ? buf[lane] : make_int2(INT_MIN, INT_MAX);
  const int bkey = __reduce_max_sync(kAll, e.x);
  const unsigned bslot = __reduce_min_sync(kAll, e.x == bkey ? static_cast<unsigned>(e.y) : UINT_MAX);
  return make_int2(bkey, static_cast<int>(bslot));
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ table_xyz, const float* __restrict__ table_occ, int c,
           const int* __restrict__ steps, int max_rank, int* __restrict__ ranks) {
  extern __shared__ float rows[];  // the bin's [c, 3] rows
  __shared__ int2 buf[2][kThreads / 32];

  const int bin = blockIdx.x;
  const float* xyz = table_xyz + static_cast<size_t>(bin) * c * 3;
  const float* occ = table_occ + static_cast<size_t>(bin) * c;
  int* rk = ranks + static_cast<size_t>(bin) * c;
  const int n = *steps;
  for (int k = threadIdx.x; k < 3 * c; k += kThreads) rows[k] = xyz[k];
  __syncthreads();

  // Own slots; min-d2 +inf where occupied (the first pass makes it the d2 to
  // the seed), -inf where not: never a candidate, since fminf(-inf, d) = -inf.
  // Seed: this thread's lowest occupied slot, key 0 against INT_MIN.
  float x[kSlots], y[kSlots], z[kSlots], md[kSlots];
  int key = INT_MIN, best = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = threadIdx.x + s * kThreads;
    const bool in = j < c;
    const bool o = in && occ[j] > 0.5f;
    x[s] = in ? rows[3 * j] : 0.f;
    y[s] = in ? rows[3 * j + 1] : 0.f;
    z[s] = in ? rows[3 * j + 2] : 0.f;
    md[s] = o ? INFINITY : -INFINITY;
    if (in) rk[j] = max_rank;
    if (o && key < 0) {
      key = 0;
      best = s;
    }
  }
  int2 pick = block_pick(key, threadIdx.x + best * kThreads, buf[0]);
  if (pick.x < 0) return;  // no occupied slot: every rank stays max_rank
  if (threadIdx.x == 0) rk[pick.y] = 0;

  for (int i = 1; i < n; ++i) {
    const float px = rows[3 * pick.y], py = rows[3 * pick.y + 1], pz = rows[3 * pick.y + 2];
    const int rel = pick.y - static_cast<int>(threadIdx.x);  // s * kThreads if the pick is mine
    key = INT_MIN;
    best = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float m = rel == s * kThreads ? -INFINITY : fminf(md[s], d2_rn(x[s], y[s], z[s], px, py, pz));
      md[s] = m;
      const int k = __float_as_int(m);
      if (k > key) {
        key = k;
        best = s;
      }
    }
    pick = block_pick(key, threadIdx.x + best * kThreads, buf[i & 1]);
    // No candidate left: every later step would change nothing either.
    if (pick.x < 0) break;
    if (threadIdx.x == 0) rk[pick.y] = i;
  }
}

template <int kSlots>
cudaError_t launch(const float* xyz, const float* occ, int b, int c, const int* steps,
                   int max_rank, int* ranks, cudaStream_t stream) {
  fps_kernel<kSlots><<<b, kThreads, 3 * static_cast<size_t>(c) * sizeof(float), stream>>>(
      xyz, occ, c, steps, max_rank, ranks);
  return cudaGetLastError();
}

}  // namespace

// table_xyz [b, c, 3] f32; table_occ [b, c] f32 (occupied where > 0.5);
// steps: device int32 scalar (ranks 0..steps-1 are assigned); ranks [b, c]
// i32 out; c at most 6 x 512. Returns cudaGetLastError() after the launch.
extern "C" int plo_fps_ranks(const void* table_xyz, const void* table_occ, int b, int c,
                             const void* steps, int max_rank, void* ranks, void* stream) {
  const float* xyz = static_cast<const float*>(table_xyz);
  const float* occ = static_cast<const float*>(table_occ);
  const int* st = static_cast<const int*>(steps);
  int* rk = static_cast<int*>(ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The fewest slots a thread that cover c.
  if (c <= kThreads) return static_cast<int>(launch<1>(xyz, occ, b, c, st, max_rank, rk, s));
  if (c <= 2 * kThreads) return static_cast<int>(launch<2>(xyz, occ, b, c, st, max_rank, rk, s));
  if (c <= 4 * kThreads) return static_cast<int>(launch<4>(xyz, occ, b, c, st, max_rank, rk, s));
  if (c <= 6 * kThreads) return static_cast<int>(launch<6>(xyz, occ, b, c, st, max_rank, rk, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
