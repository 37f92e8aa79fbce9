"""Shared linearized point-to-plane system (the port of
plo_tpu/solvers/build.py, solver.cpp:89-107, 140-163).

Row i of A is [(s x n)^T, n^T] and b_i = n . (d - s); invalid
correspondences contribute all-zero rows, which leave any least-squares
solution unchanged.
"""
from __future__ import annotations

import torch

from plo_tpu_torch import geometry as geo


def build_system(source: torch.Tensor, ref: torch.Tensor, normal: torch.Tensor,
                 valid: torch.Tensor):
    """Returns (A [N, 6], b [N]) with invalid rows zeroed."""
    s, d, n = source, ref, normal
    a_rot = torch.stack([
        n[:, 2] * s[:, 1] - n[:, 1] * s[:, 2],
        n[:, 0] * s[:, 2] - n[:, 2] * s[:, 0],
        n[:, 1] * s[:, 0] - n[:, 0] * s[:, 1],
    ], dim=1)
    A = torch.cat([a_rot, n], dim=1)
    b = (n * (d - s)).sum(1)
    m = valid.to(A.dtype)
    return A * m[:, None], b * m


def masked_lstsq(A: torch.Tensor, b: torch.Tensor, rcond: float = 1e-6) -> torch.Tensor:
    """Least squares by SVD pseudo-inverse with a singular-value cutoff: no
    condition-number squaring in f32, and finite on rank-deficient systems
    (the unobservable components come out 0)."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    cutoff = rcond * s.max()
    s_inv = torch.where(s > cutoff, 1.0 / s.clamp_min(1e-30), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def se3_from_x(x: torch.Tensor) -> torch.Tensor:
    """6-vector [rotation axis-angle, translation] -> 4x4 transform with the
    reference's SVD-orthonormalized rotation."""
    return geo.make_se3(geo.rotation_from_axis_angle(x[:3]), x[3:6])
