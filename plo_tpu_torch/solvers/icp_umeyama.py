"""Point-to-point ICP on matched pairs (the port of
plo_tpu/solvers/icp_umeyama.py; SolveMotionEstimationProblemICP,
solver.cpp:387-434): nearest-neighbor association through the `nearest`
kernel, then a weighted Kabsch/Umeyama alignment, for a fixed number of
iterations (the reference's epsilons are `const int`, so 0: no early stop).

The alignment's 3x3 SVD is a closed form here: torch.linalg.svd on CUDA
synchronizes with the host on every call, and ICP runs 30 alignments a solve
(Teaser up to 65). The right singular vectors of H are the eigenvectors of
H^T H (the closed-form eigh3); the left ones follow as H v_i,
Gram-Schmidt-orthonormalized; and R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T
is the Kabsch rotation with its determinant fixed, whatever the signs of v3
and u3.
"""
from __future__ import annotations

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.ops import neighbors
from plo_tpu_torch.ops.eigh3 import eigh3_descending


def _unit(v: torch.Tensor, fallback: torch.Tensor, tiny: torch.Tensor) -> torch.Tensor:
    """v normalized, or `fallback` where |v|^2 <= tiny."""
    n2 = (v * v).sum()
    return torch.where(n2 > tiny, v / torch.sqrt(n2.clamp_min(1e-30)), fallback)


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation R maximizing trace(R H) for a 3x3 cross-covariance
    H = sum w s t^T (R = V diag(1, 1, det(V U^T)) U^T for H = U S V^T),
    without an SVD. H^T H squares H's condition number, so the rotation is
    worked out in float64 (a few dozen scalar operations) and returned in
    H's dtype. Where H has rank 1 or 0 the rotation is not unique; the left
    vectors then fall back to the right ones (R = I for H = 0)."""
    dtype = H.dtype
    H = H.to(torch.float64)
    _, v = eigh3_descending(H.T @ H)
    v1, v2 = v[:, 0], v[:, 1]
    h1, h2 = H @ v1, H @ v2
    s1 = (h1 * h1).sum()
    u1 = _unit(h1, v1, torch.full_like(s1, 1e-30))
    w2 = h2 - (u1 * h2).sum() * u1
    alt = v2 - (u1 * v2).sum() * u1
    alt = _unit(alt, torch.linalg.cross(u1, v1), torch.full_like(s1, 1e-12))
    u2 = _unit(w2, alt, 1e-12 * s1)
    v3 = torch.linalg.cross(v1, v2)
    u3 = torch.linalg.cross(u1, u2)
    R = v1[:, None] * u1[None, :] + v2[:, None] * u2[None, :] + v3[:, None] * u3[None, :]
    return R.to(dtype)


def umeyama(source: torch.Tensor, target: torch.Tensor, weights: torch.Tensor):
    """Weighted Kabsch/Umeyama alignment of paired sets, no scale
    (plo_tpu.solvers.icp_umeyama.umeyama). Returns (R, t) minimizing
    sum w_i |R s_i + t - t_i|^2."""
    w = weights / weights.sum().clamp_min(1e-12)
    mu_s = (source * w[:, None]).sum(0)
    mu_t = (target * w[:, None]).sum(0)
    H = ((source - mu_s) * w[:, None]).T @ (target - mu_t)
    R = kabsch_rotation(H)
    return R, mu_t - R @ mu_s


def solve_icp_point_to_point(source: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor,
                             max_iterations: int = 20):
    """max_iterations rounds of: move the source, match each moved point to
    its nearest valid ref point (the `nearest` kernel, radius infinite),
    align. Returns (deltaTrans 4x4, ok)."""
    dev = source.device
    R = torch.eye(3, dtype=torch.float32, device=dev)
    t = torch.zeros(3, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        moved = source @ R.T + t
        _, idx, found = neighbors.nearest(moved, ref, valid)
        matched = ref[idx.clamp(0, ref.shape[0] - 1)]
        dR, dt = umeyama(moved, matched, (valid & found).to(torch.float32))
        R, t = dR @ R, dR @ t + dt
    ok = torch.isfinite(R).all() & torch.isfinite(t).all() & (valid.sum() >= 3)
    R = torch.where(ok, R, torch.eye(3, dtype=torch.float32, device=dev))
    return geo.make_se3(R, torch.where(ok, t, 0.0)), ok
