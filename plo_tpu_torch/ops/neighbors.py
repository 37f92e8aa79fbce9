"""Neighbor searches (the port of plo_tpu/ops/neighbors.py): exact chunked
kNN by coordinate differences, the k=1 anchor searches of plane-ICP
(`nearest`, `projected_argmin`), the projected-distance top-k and the
azimuth-windowed adjacent-ring search.

kNN and projected_knn stay plain PyTorch, as they are plain XLA (not Pallas)
in the JAX package. `nearest` and `projected_argmin` go through the CUDA
kernels of ops/cuda_nn.py for tensors on the card, and through their plain
versions there (the ports of `_nearest_xla` and `projected_knn(k=1)`) for
tensors on the CPU. plo_tpu's `gather_mask` (a bool gather routed through
f32 for the TPU's sake) is a plain index here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from plo_tpu_torch.ops import cuda_nn

INF = math.inf


def _pairwise_d2(query: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
    """Squared distances [Q, C] by per-coordinate differences — deliberately
    NOT the |q|^2+|t|^2-2qt matmul form, which cancels to ~1e-3 absolute error
    in f32 at 100 m ranges and permutes near-tie neighbors."""
    d2 = torch.zeros((query.shape[0], tc.shape[0]), dtype=torch.float32,
                     device=query.device)
    for c in range(3):
        diff = query[:, c:c + 1] - tc[None, :, c]
        d2 = d2 + diff * diff
    return d2


def _tie_key(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d2, idx) packed into one int64 that orders as the pair does: d2 >= 0
    (or inf) orders as its f32 bit pattern, in the high word; idx + 1 (so
    that -1 packs as 0) in the low word. Selecting on it gives the lowest
    index among equal distances, as lax.top_k does, on any device."""
    return (d2.view(torch.int32).to(torch.int64) << 32) | (idx + 1)


def _knn_pass(query, target, target_valid, k: int, chunk: int, exact: bool):
    """One pass over the target's chunks, keeping per query the k smallest
    _tie_key(d2, idx). With exact=True each chunk's candidates are selected on
    the keys. With exact=False they come from a float topk of d2, which picks
    the right set unless more targets tie at the chunk's k-th distance than
    there are places left; the second result says whether that happened in
    any chunk (a 0-dim bool on the device). Ties at +inf (invalid targets) do
    not count: a chunk's +inf entries never outrank the running set's
    (+inf, -1) ones."""
    q, t = query.shape[0], target.shape[0]
    dev = query.device
    best = _tie_key(torch.full((q, k), INF, dtype=torch.float32, device=dev),
                    torch.full((q, k), -1, dtype=torch.int64, device=dev))
    ambiguous = torch.zeros((), dtype=torch.bool, device=dev)
    for base in range(0, t, chunk):
        tc = target[base:base + chunk]
        d2 = torch.where(target_valid[None, base:base + chunk],
                         _pairwise_d2(query, tc), INF)
        kk = min(k, tc.shape[0])
        if exact:
            pos = torch.arange(base, base + tc.shape[0], dtype=torch.int64, device=dev)
            ckey, _ = torch.topk(_tie_key(d2, pos[None, :]), kk, dim=1, largest=False)
        else:
            vals, cpos = torch.topk(d2, kk, dim=1, largest=False)
            kth = vals[:, -1:]
            ambiguous |= (torch.isfinite(kth[:, 0]) & ((d2 <= kth).sum(1) > kk)).any()
            ckey = _tie_key(vals, cpos + base)
        best, _ = torch.topk(torch.cat([best, ckey], dim=1), k, dim=1, largest=False)
    return best, ambiguous


def knn(query: torch.Tensor, target: torch.Tensor, target_valid: torch.Tensor,
        k: int, radius: float = INF,
        chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid targets by squared euclidean distance, chunked over the
    target with a running top-k merge; ties go to the lower index, as
    lax.top_k's do. Returns (d2 [Q, k] ascending, idx [Q, k] i64,
    valid [Q, k]); neighbors beyond `radius` (squared in f32) are invalid
    (libnabo knn with SORT_RESULTS | ALLOW_SELF_MATCH, imls_icp.cpp:372-376).

    torch.topk does not document its order among equal values, so the merge
    runs on _tie_key(d2, idx), whose values are distinct. Each chunk is
    selected with a float topk first; where a tie straddles a chunk's k-th
    place (duplicate points), the search runs again on the keys alone. That
    check is the search's one host sync."""
    if chunk is None:
        chunk = cuda_nn.chunk_size(query.shape[0], target.shape[0])
    best, ambiguous = _knn_pass(query, target, target_valid, k, chunk, exact=False)
    if bool(ambiguous):
        best, _ = _knn_pass(query, target, target_valid, k, chunk, exact=True)
    best_d2 = (best >> 32).to(torch.int32).view(torch.float32)
    best_idx = (best & 0xFFFFFFFF) - 1
    valid = ((best_idx >= 0) & (best_d2 <= cuda_nn.f32_square(radius))
             & torch.isfinite(best_d2))
    return best_d2, best_idx, valid


def nearest(query: torch.Tensor, target: torch.Tensor, target_valid: torch.Tensor,
            radius: float = INF):
    """k=1 NN (anchor search, imls_icp.cpp:597-610). Returns (d2, idx i32,
    valid), each [Q]; idx is -1 where no target is valid."""
    return cuda_nn.nearest(query, target, target_valid, radius)


def projected_knn(query: torch.Tensor, query_normal: torch.Tensor, target: torch.Tensor,
                  target_valid: torch.Tensor, k: int, euclid_gate: float, proj_gate: float,
                  chunk: Optional[int] = None):
    """Top-k smallest projected distances |(t - q) x n_q| subject to
    |t - q| < euclid_gate and proj < proj_gate (imls_icp.cpp:341-364; the
    plane_ICP variant at laser_odometry.cpp:316-334 passes its gates as
    (r^2, r_proj)). Gates are squared in f32, as the JAX package's XLA scan
    squares them. Returns (proj [Q, k] ascending, NOT squared; idx [Q, k]
    i32; valid [Q, k])."""
    q, t = query.shape[0], target.shape[0]
    dev = query.device
    if chunk is None:
        chunk = cuda_nn.chunk_size(q, t)
    eg2, pg2 = cuda_nn.f32_square(euclid_gate), cuda_nn.f32_square(proj_gate)
    best_p2 = torch.full((q, k), INF, dtype=torch.float32, device=dev)
    best_idx = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for base in range(0, t, chunk):
        tc = target[base:base + chunk]
        p2 = cuda_nn.projected_p2(query, query_normal, tc, target_valid[base:base + chunk],
                                  eg2, pg2)
        pos = torch.arange(base, base + tc.shape[0], dtype=torch.int32, device=dev)
        cat_p2 = torch.cat([best_p2, p2], dim=1)
        cat_idx = torch.cat([best_idx, pos[None, :].expand(q, -1)], dim=1)
        # A stable ascending sort keeps the earlier (lower-index) entry of a
        # tie first, as lax.top_k does.
        best_p2, order = torch.sort(cat_p2, dim=1, stable=True)
        best_p2, order = best_p2[:, :k], order[:, :k]
        best_idx = torch.gather(cat_idx, 1, order)
    valid = (best_idx >= 0) & torch.isfinite(best_p2)
    return torch.sqrt(torch.where(torch.isfinite(best_p2), best_p2, INF)), best_idx, valid


def projected_argmin(query: torch.Tensor, query_normal: torch.Tensor, target: torch.Tensor,
                     target_valid: torch.Tensor, euclid_gate: float, proj_gate: float):
    """k=1 projected-distance anchor search (imls_icp.cpp:563-595).
    Returns (proj [Q], idx [Q] i32, valid [Q])."""
    return cuda_nn.projected_argmin(query, query_normal, target, target_valid,
                                    euclid_gate, proj_gate)


def ring_neighbor_search(query_xyz: torch.Tensor, query_ring: torch.Tensor,
                         query_pos: torch.Tensor, query_valid: torch.Tensor,
                         ring_start: torch.Tensor, ring_count: torch.Tensor,
                         ring_offset: int, window: int = 8):
    """Nearest 3D point on ring r+ring_offset among the 2*window+1 points
    around the query's fractional position in that ring (findNearestPoint,
    scan_registration.cpp:117-136). Returns (d2 [P], flat index [P], found [P])."""
    h = ring_start.shape[0]
    cap = query_xyz.shape[0]
    tring = query_ring + ring_offset
    tring_ok = (tring >= 0) & (tring < h)
    tring_c = tring.clamp(0, h - 1)
    tstart = ring_start[tring_c]
    tcount = ring_count[tring_c]
    qcount = ring_count[query_ring.clamp(0, h - 1)].clamp_min(1)
    center = (query_pos.float() / qcount.float() * tcount.float()).long()

    offs = torch.arange(-window, window + 1, device=query_xyz.device)
    cand_pos = center[:, None] + offs[None, :]
    in_ring = (cand_pos >= 0) & (cand_pos < tcount[:, None]) & tring_ok[:, None]
    cand_flat = (tstart[:, None] + cand_pos).clamp(0, cap - 1)
    cand_valid = in_ring & query_valid[cand_flat]
    diff = query_xyz[cand_flat] - query_xyz[:, None, :]
    d2 = torch.where(cand_valid, (diff * diff).sum(-1), INF)
    best = torch.argmin(d2, dim=1, keepdim=True)
    best_d2 = torch.gather(d2, 1, best)[:, 0]
    best_flat = torch.gather(cand_flat, 1, best)[:, 0]
    return best_d2, best_flat, torch.isfinite(best_d2) & query_valid
