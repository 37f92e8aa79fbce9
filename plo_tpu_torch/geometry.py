"""SE(3)/SO(3) helpers the per-frame path uses (the port of plo_tpu/geometry.py):
Rodrigues with the reference's SVD re-orthonormalization (solver.cpp:145-158),
the trace-angle convergence test (laser_odometry.cpp:636-638) and 4x4 point
transforms (laser_odometry.cpp:527-549)."""
from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v, so that hat(v) @ w = v x w."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vector -> rotation matrix (safe at ||w|| -> 0)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
    k = hat(w / theta)
    theta = theta[..., 0]
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + s * k + (1.0 - c) * (k @ k)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project onto SO(3) via SVD with det fix (solver.cpp:148-158)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * sign[..., None, None]], dim=-1)
    return u @ vt


def rotation_from_axis_angle(w: torch.Tensor) -> torch.Tensor:
    """Reference recipe: AngleAxis -> R, then SVD re-orthonormalization."""
    return orthonormalize(exp_so3(w))


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """|angle| from trace, clamped (laser_odometry.cpp:636-638)."""
    cos_theta = (R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(cos_theta.clamp(-1.0, 1.0))


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build a 4x4 homogeneous transform."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [N, 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate normals without translating."""
    return vecs @ T[:3, :3].T
