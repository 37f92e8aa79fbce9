"""SE(3)/SO(3) helpers the odometry uses (the port of plo_tpu/geometry.py):
Rodrigues with the reference's SVD re-orthonormalization (solver.cpp:145-158),
its inverse and the fractional pose of motion compensation, the trace-angle
convergence test (laser_odometry.cpp:636-638), 4x4 point transforms
(laser_odometry.cpp:527-549) and the rigid inverse; `project_so3`, the
map chain's projection onto SO(3) without an SVD; and the quaternions of the
TUM pose files."""
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


def quat_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (x, y, z, w), the TUM order
    of the pose files (saver.cpp savePoseToFile). Shepperd's four branches
    are all computed and one is selected per matrix with torch.where, so a
    batch needs no Python branch and no host sync."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def scale(d):
        return torch.sqrt(torch.clamp_min(d, 1e-12)) * 2.0

    s0 = scale(tr + 1.0)
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = scale(1.0 + m00 - m11 - m22)
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = scale(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = scale(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)
    use0 = (tr > 0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1, torch.where(use2, q2, q3)))
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) [..., 4] -> rotation matrix [..., 3, 3]; a
    zero quaternion gives the identity."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.clamp_min(n, 1e-12), torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], dim=-2)
