"""SE(3)/SO(3) helpers the odometry uses (the port of plo_tpu/geometry.py):
Rodrigues with the reference's SVD re-orthonormalization (solver.cpp:145-158),
its inverse and the fractional pose of motion compensation, the trace-angle
convergence test (laser_odometry.cpp:636-638), 4x4 point transforms
(laser_odometry.cpp:527-549) and the rigid inverse; plus `project_so3`, the
map chain's projection onto SO(3) without an SVD."""
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


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (inverse of exp_so3; safe near 0)."""
    cos_theta = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta > 1e-6, theta / (2.0 * torch.sin(theta)).clamp_min(1e-12), 0.5)
    return w * scale[..., None]


def interpolate_pose(T: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Fractional pose exp(alpha * log(T)) with linear translation: the
    per-point motion compensation of undistortion. T [4, 4], alpha [...];
    returns [..., 4, 4]."""
    w = log_so3(T[:3, :3])
    R = exp_so3(alpha[..., None] * w)
    return make_se3(R, alpha[..., None] * T[:3, 3])


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project onto SO(3) via SVD with det fix (solver.cpp:148-158)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * sign[..., None, None]], dim=-1)
    return u @ vt


def project_so3(M: torch.Tensor) -> torch.Tensor:
    """The nearest rotation to a 3x3 M near SO(3): its orthogonal polar
    factor M (M^T M)^-1/2, which is orthonormalize's U V^T where det(M) > 0.
    Newton's iteration X <- (X + X^-T) / 2 in float64 converges to it
    quadratically (a defect of 1e-2 is below 1e-16 after 4 steps; it takes
    6); X^-T is the cofactor matrix over the determinant, from cross products
    of the columns. No SVD, so no host sync on CUDA, where torch.linalg.svd
    waits for the host. Returns M's dtype."""
    X = M.to(torch.float64)
    for _ in range(6):
        a, b, c = X[:, 0], X[:, 1], X[:, 2]
        cof = torch.stack([torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                           torch.linalg.cross(a, b)], dim=1)
        X = 0.5 * (X + cof / (a * cof[:, 0]).sum())
    return X.to(M.dtype)


def rotation_from_axis_angle(w: torch.Tensor) -> torch.Tensor:
    """Reference recipe: AngleAxis -> R, then SVD re-orthonormalization."""
    return orthonormalize(exp_so3(w))


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """|angle| from trace, clamped (laser_odometry.cpp:636-638)."""
    cos_theta = (R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(cos_theta.clamp(-1.0, 1.0))


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build a 4x4 homogeneous transform. It starts from eye(4): writing the
    Python scalar 1.0 into a CUDA tensor is a host-to-device copy that waits
    for the host."""
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[:-2] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse [R^T, -R^T t] of a 4x4 transform."""
    Rt = T[:3, :3].T
    return make_se3(Rt, -(Rt @ T[:3, 3:4])[:, 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [N, 3] points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate normals without translating."""
    return vecs @ T[:3, :3].T
