"""Stage 3a — pre-sampling features (the port of plo_tpu/ops/features.py):
per-ring curvature and the curvature presample (scan_registration.cpp:
1071-1113, 1462-1473), and the geometric-features presample (:279-327)."""
from __future__ import annotations

import torch

from plo_tpu_torch.ops.preprocess import RingCloud


def ring_curvature(cloud: RingCloud, window_size: int) -> torch.Tensor:
    """Per-point LOAM curvature |sum_k (x_{j+k} - x_j)|^2 over +-window_size
    consecutive stored points (:1075-1112). The window runs over flat
    indices of the compact ring-sorted cloud and may straddle ring
    boundaries (a reference quirk kept); points with flat index < w or
    >= size - w, or with ring position outside [5, size - 6), keep 0."""
    cap = cloud.capacity
    idx = torch.arange(cap, device=cloud.xyz.device)
    total = cloud.valid.sum()  # compact prefix length
    acc = torch.zeros_like(cloud.xyz)
    n_terms = torch.zeros((cap, 1), dtype=torch.float32, device=cloud.xyz.device)
    for k in range(-window_size, window_size + 1):
        j = idx + k
        ok = ((j >= 0) & (j < total))[:, None]
        acc = acc + torch.where(ok, cloud.xyz[j.clamp(0, cap - 1)], 0.0)
        n_terms = n_terms + ok.to(torch.float32)
    diff = acc - n_terms * cloud.xyz  # includes k = 0 (zero)
    # Summed in the JAX package's order: the curvature gate is a strict
    # threshold, so the last bit can decide a candidate.
    curv = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    size = cloud.ring_count[cloud.ring.clamp(0, cloud.ring_start.shape[0] - 1)]
    pos_ok = (cloud.pos_in_ring >= 5) & (cloud.pos_in_ring < size - 6)
    flat_ok = (idx >= window_size) & (idx < total - window_size)
    return torch.where(cloud.valid & pos_ok & flat_ok, curv, 0.0)


def presample_curvature(curvature: torch.Tensor, valid: torch.Tensor,
                        curvature_threshold: float) -> torch.Tensor:
    """Candidates: curvature > threshold (:1466-1470)."""
    return valid & (curvature > curvature_threshold)


def geometric_features(eigvals: torch.Tensor) -> torch.Tensor:
    """The 8 eigenvalue features of [P, 3] descending eigenvalues: sum,
    omnivariance, eigenentropy, anisotropy, linearity, planarity, surface
    variation, sphericity (:291-319). Returns [P, 8]."""
    l1, l2, l3 = eigvals[:, 0], eigvals[:, 1], eigvals[:, 2]
    safe = lambda x: x.clamp_min(1e-20)
    s = l1 + l2 + l3
    omni = torch.sign(l1 * l2 * l3) * (l1 * l2 * l3).abs().pow(1.0 / 3.0)
    entropy = -(l1 * torch.log(safe(l1)) + l2 * torch.log(safe(l2)) + l3 * torch.log(safe(l3)))
    aniso = (l1 - l3) / safe(l1)
    linearity = (l1 - l2) / safe(l1)
    planarity = (l2 - l3) / safe(l1)
    surf_var = l3 / safe(s)
    sphericity = l3 / safe(l1)
    return torch.stack([s, omni, entropy, aniso, linearity, planarity, surf_var,
                        sphericity], dim=1)


def presample_geometric(eigvals: torch.Tensor, valid: torch.Tensor,
                        planarity_threshold: float) -> torch.Tensor:
    """Candidates: planarity > threshold (:322-326)."""
    return valid & (geometric_features(eigvals)[:, 5] > planarity_threshold)
