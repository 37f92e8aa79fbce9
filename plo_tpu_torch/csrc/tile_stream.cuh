// tile_stream.cuh — what the pair kernels (nearest.cu, cylinder_stats.cu,
// projected_argmin.cu) share: the stream of one block's share of a padded
// target cloud through shared memory, the slice count, the d2 gate of a run
// of 32 targets recorded as bits, and the one-launch merge of the slices'
// per-query minima (nearest, projected_argmin).
//
// The target is [T, 3] f32 rows with a [T] bool mask; the port's clouds keep
// their valid points in a prefix of T slots and pad the rest. The target is
// cut into tiles of kTile points, dealt round-robin to the slices along
// gridDim.y (tile i to slice i % gridDim.y), so that every slice gets an even
// share of the valid prefix wherever it ends. A block
//  1. finds which of its tiles hold a valid point: each thread ORs one
//     tile's mask (eight 16-byte loads), and a warp ballot and a prefix sum
//     list the live tiles in ascending order. Tiles that hold no valid point
//     cost that one read and nothing more;
//  2. streams the live tiles through two shared-memory buffers with
//     cp.async: the copy of tile k+1 is in flight while tile k is computed;
//  3. unpacks each landed tile into float4 points (x, y, z, 0), +inf where
//     the slot is invalid, so that the pair loop reads a point with one
//     16-byte shared load and an invalid slot fails every distance gate.
//     The unpacked points of the last kWindow tiles stay in shared memory,
//     so that a kernel can look at a window of tiles again after their
//     bodies ran (nearest.cu's rescan).
// Requires: blockDim.x == kThreads; target and mask 16-byte aligned (the
// wrappers in ops/cuda_nn.py see to it).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace plo {

constexpr int kTile = 128;     // target points per tile
constexpr int kThreads = 128;  // threads per block of the pair kernels
constexpr int kXyzChunks = kTile * 3 * 4 / 16;   // 16-byte copies of a tile's rows
constexpr int kMaskChunks = kTile / 16;          // ... and of its mask

// kWindow: how many unpacked tiles pts holds (the k-th live tile of a batch
// lands at pts + (k % kWindow) * kTile).
template <int kWindow = 1>
struct __align__(16) TileBuffers {
  float xyz[2][kTile * 3];           // landed rows, as in device memory
  unsigned char valid[2][kTile];     // landed mask bytes, 0 past the end
  float4 pts[kWindow * kTile];       // the window of unpacked tiles
  int list[kThreads];                // live tiles of the current batch
  unsigned warp_live[kThreads / 32];
};

// (dx*dx + dy*dy) + dz*dz, each operation rounded as PyTorch rounds it.
__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The slice count along gridDim.y for q queries at kBlockQ queries a block:
// about kBlocksPerSM blocks an SM of the current device, at most kMaxSplits.
template <int kBlockQ, int kBlocksPerSM, int kMaxSplits>
int splits_for(int q) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int xb = (q + kBlockQ - 1) / kBlockQ;
  return max(1, min(kMaxSplits, kBlocksPerSM * sms / max(xb, 1)));
}

// Sets bit k of near[u] where target pts[g + k] (k < 32) and query u pass
// d2 < gate2; +inf padding gives d2 = inf, which fails. The caller then does
// the gated work for the set bits only, in ascending target order: a branch
// around it inside this loop would be if-converted, and its predicated-off
// instructions would still take issue slots. d2 is that of t - q; round to
// nearest is odd-symmetric, so q - t gives the same bits.
template <int kQ>
__device__ __forceinline__ void gate_bits(const float4* pts, int g, const float (&qx)[kQ],
                                          const float (&qy)[kQ], const float (&qz)[kQ],
                                          float gate2, unsigned (&near)[kQ]) {
#pragma unroll
  for (int u = 0; u < kQ; ++u) near[u] = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float4 p = pts[g + k];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (d2_rn(__fsub_rn(p.x, qx[u]), __fsub_rn(p.y, qy[u]), __fsub_rn(p.z, qz[u])) < gate2)
        near[u] |= 1u << k;
    }
  }
}

// Whether any of targets [b0, b1) is valid; valid + b0 is 16-byte aligned.
__device__ __forceinline__ bool any_valid(const unsigned char* __restrict__ valid,
                                          int b0, int b1) {
  unsigned acc = 0;
  if (b1 - b0 == kTile) {
    const uint4* v = reinterpret_cast<const uint4*>(valid + b0);
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      const uint4 w = __ldg(v + k);
      acc |= w.x | w.y | w.z | w.w;
    }
  } else {
    for (int i = b0; i < b1; ++i) acc |= valid[i];
  }
  return acc != 0;
}

// Lists in sm.list, in ascending order, the live tiles among this block's
// candidates c0 .. c0 + kThreads - 1 (candidate c is tile first + c * stride).
// Returns their number; every thread gets the same.
template <class Buffers>
__device__ __forceinline__ int collect_live(Buffers& sm,
                                            const unsigned char* __restrict__ valid,
                                            int end, int first, int stride, int n_tiles,
                                            int c0) {
  const int tile = first + (c0 + static_cast<int>(threadIdx.x)) * stride;
  bool live = false;
  if (tile < n_tiles) {
    const int b0 = tile * kTile;
    live = any_valid(valid, b0, min(b0 + kTile, end));
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) sm.warp_live[warp] = ballot;
  __syncthreads();
  int pos = __popc(ballot & ((1u << lane) - 1u));
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int n = __popc(sm.warp_live[w]);
    pos += w < warp ? n : 0;
    total += n;
  }
  if (live) sm.list[pos] = tile;
  __syncthreads();
  return total;
}

// Starts the copy of tile `tile` (targets [b0, min(b0 + kTile, end))) into
// buffer `buf`; what lies past `end` lands as zeros, so its mask reads 0.
template <class Buffers>
__device__ __forceinline__ void stage(Buffers& sm, int buf,
                                      const float* __restrict__ target,
                                      const unsigned char* __restrict__ valid,
                                      int tile, int end) {
  const int b0 = tile * kTile;
  const int n = min(kTile, end - b0);
  for (int c = threadIdx.x; c < kXyzChunks + kMaskChunks; c += kThreads) {
    if (c < kXyzChunks) {
      const int bytes = max(0, min(16, (3 * n - 4 * c) * 4));
      const float* src = bytes > 0 ? target + 3 * static_cast<size_t>(b0) + 4 * c : target;
      cp_async16(&sm.xyz[buf][4 * c], src, bytes);
    } else {
      const int k = c - kXyzChunks;
      const int bytes = max(0, min(16, n - 16 * k));
      const unsigned char* src = bytes > 0 ? valid + b0 + 16 * k : valid;
      cp_async16(&sm.valid[buf][16 * k], src, bytes);
    }
  }
}

// The landed buffer `buf` as float4 points at pts, +inf where invalid.
template <class Buffers>
__device__ __forceinline__ void unpack(Buffers& sm, int buf, float4* pts) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    pts[j] = sm.valid[buf][j]
                    ? make_float4(sm.xyz[buf][3 * j], sm.xyz[buf][3 * j + 1],
                                  sm.xyz[buf][3 * j + 2], 0.f)
                    : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  }
}

// The one-launch merge of per-slice minima. Each block folds its per-query
// best (v >= 0, idx) into keys[qi] with an atomicMin on v's bits above
// idx's: for v >= 0 the key orders exactly as (v, idx) does
// lexicographically, so the slices' merge is the lowest v and, among equal v,
// the lowest index, whatever order the blocks run in (an integer min: the
// result is deterministic). The last block of each query block to finish (a
// ticket counted with atomicAdd after a __threadfence) reads the keys.
// keys [q] and one ticket per query block share the caller's scratch, which
// the C entry sets to all ones with one memset before the launch: kNoKey,
// and tickets that start at ~0u.
constexpr unsigned long long kNoKey = ~0ull;

// The scratch of q queries in query blocks of kBlockQ, in 8-byte words.
template <int kBlockQ>
int merge_scratch_words(int q) { return q + ((q + kBlockQ - 1) / kBlockQ + 1) / 2; }

__device__ __forceinline__ void fold_key(unsigned long long* keys, int qi, float v, int idx) {
  atomicMin(&keys[qi], (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
                           static_cast<unsigned>(idx));
}

// Whether this block is the last of its query block's gridDim.y slices to
// finish; every thread calls it after its fold_keys. Block-uniform.
__device__ __forceinline__ bool last_slice(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  // Tickets start at ~0u, so the last of gridDim.y arrivals reads gridDim.y - 2 (mod 2^32).
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 2u;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The merged key of query qi (read from L2, where the atomics ran): whether
// any slice folded one, and its value and index.
struct Merged {
  bool found;
  float v;
  int idx;
};
__device__ __forceinline__ Merged merged(const unsigned long long* keys, int qi) {
  const unsigned long long key = __ldcg(&keys[qi]);
  return {key != kNoKey, __uint_as_float(static_cast<unsigned>(key >> 32)),
          static_cast<int>(key & 0xffffffffu)};
}

struct NoFlush {
  __device__ void operator()() const {}
};

// Calls body(pts, base) for each live tile of this block's slice of targets
// [0, end), in ascending order; pts[j] is target base + j, and pts lies in
// sm.pts. Calls flush() after the body of the last tile of each window of
// kWindow tiles and of each batch of live tiles, while the window's tiles
// are still in sm.pts; the window is rewritten only after a __syncthreads.
template <int kWindow, class Body, class Flush = NoFlush>
__device__ __forceinline__ void stream_tiles(TileBuffers<kWindow>& sm,
                                             const float* __restrict__ target,
                                             const unsigned char* __restrict__ valid,
                                             int end, Body& body, Flush&& flush = Flush{}) {
  const int first = blockIdx.y;
  const int stride = gridDim.y;
  const int n_tiles = (end + kTile - 1) / kTile;
  const int n_cand = first < n_tiles ? (n_tiles - first + stride - 1) / stride : 0;
  for (int c0 = 0; c0 < n_cand; c0 += kThreads) {
    const int n_live = collect_live(sm, valid, end, first, stride, n_tiles, c0);
    if (n_live == 0) continue;
    stage(sm, 0, target, valid, sm.list[0], end);
    cp_async_commit();
    for (int k = 0; k < n_live; ++k) {
      if (k + 1 < n_live) stage(sm, (k + 1) & 1, target, valid, sm.list[k + 1], end);
      cp_async_commit();   // an empty group after the last tile
      cp_async_wait<1>();  // tile k has landed (this thread's copies)
      __syncthreads();     // ... everyone's; and everyone is done with tile k-1
      float4* pts = sm.pts + (k % kWindow) * kTile;
      unpack(sm, k & 1, pts);
      __syncthreads();
      body(pts, sm.list[k] * kTile);
      if (k % kWindow == kWindow - 1 || k + 1 == n_live) flush();
    }
    __syncthreads();  // the next batch rewrites list and pts
  }
}

}  // namespace plo
