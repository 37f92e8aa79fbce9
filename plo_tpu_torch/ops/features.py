"""Stage 3a — geometric-features presample (the port of
plo_tpu/ops/features.py, scan_registration.cpp:279-327)."""
from __future__ import annotations

import torch


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
