"""Neighbor searches (the port of plo_tpu/ops/neighbors.py): exact chunked
kNN by coordinate differences and the azimuth-windowed adjacent-ring search.

kNN stays plain PyTorch, as it is plain XLA (not Pallas) in the JAX package.
plo_tpu's `gather_mask` (a bool gather routed through f32 for the TPU's
sake) is a plain index here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

INF = math.inf

# Largest [Q, chunk] distance block one chunk materializes (128 MB of f32):
# PyTorch runs eagerly, so each elementwise step of the distance writes a
# block of this size.
_CHUNK_ELEMS = 1 << 25


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


def knn(query: torch.Tensor, target: torch.Tensor, target_valid: torch.Tensor,
        k: int, radius: float = INF,
        chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest valid targets by squared euclidean distance, chunked over the
    target with a running top-k merge. Returns (d2 [Q, k] ascending,
    idx [Q, k] i64, valid [Q, k]); neighbors beyond `radius` are invalid
    (libnabo knn with SORT_RESULTS | ALLOW_SELF_MATCH, imls_icp.cpp:372-376)."""
    q, t = query.shape[0], target.shape[0]
    dev = query.device
    if chunk is None:
        chunk = max(4096, min(t, _CHUNK_ELEMS // max(q, 1)))
    best_d2 = torch.full((q, k), INF, dtype=torch.float32, device=dev)
    best_idx = torch.full((q, k), -1, dtype=torch.int64, device=dev)
    for base in range(0, t, chunk):
        tc = target[base:base + chunk]
        d2 = torch.where(target_valid[None, base:base + chunk],
                         _pairwise_d2(query, tc), INF)
        cd2, cpos = torch.topk(d2, min(k, tc.shape[0]), dim=1, largest=False)
        cat_d2 = torch.cat([best_d2, cd2], dim=1)
        cat_idx = torch.cat([best_idx, cpos + base], dim=1)
        best_d2, pos = torch.topk(cat_d2, k, dim=1, largest=False)
        best_idx = torch.gather(cat_idx, 1, pos)
    valid = (best_idx >= 0) & (best_d2 <= radius * radius) & torch.isfinite(best_d2)
    return best_d2, best_idx, valid


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
