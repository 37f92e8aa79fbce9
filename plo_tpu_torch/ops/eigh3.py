"""Batched closed-form symmetric 3x3 eigendecomposition (the port of
plo_tpu/ops/eigh3.py): trigonometric eigenvalues plus cross-product
eigenvectors, DESCENDING order with matching eigenvector columns.

torch.linalg.eigh is not a substitute: it returns ascending order, and its
eigenvector signs differ from this construction, which the +z normal flip and
the plane test downstream would then see.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvals3_descending(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3] in descending order (analytic)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt((p2 / 6.0).clamp_min(0.0))
    safe_p = p.clamp_min(_EPS)

    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = (detb / 2.0).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lmid = 3.0 * q - lmax - lmin
    return torch.stack([lmax, lmid, lmin], dim=-1)


def _unit(k: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., k] = 1.0
    return e


def _null_vector(M: torch.Tensor) -> torch.Tensor:
    """Unit vector approximately in the null space of symmetric [..., 3, 3] M:
    the largest of the three row cross products, or for (near-)degenerate M a
    vector orthogonal to the dominant row."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    best_norm2 = torch.maximum(torch.maximum(n01, n02), n12)

    n0, n1, n2 = (r0 * r0).sum(-1), (r1 * r1).sum(-1), (r2 * r2).sum(-1)
    dom = torch.where(((n0 >= n1) & (n0 >= n2))[..., None], r0,
                      torch.where((n1 >= n2)[..., None], r1, r2))
    ex, ey = _unit(0, dom), _unit(1, dom)
    alt = torch.where((dom[..., 0].abs() < 0.9)[..., None],
                      torch.linalg.cross(dom, ex), torch.linalg.cross(dom, ey))
    alt = torch.where(((alt * alt).sum(-1) > _EPS)[..., None], alt, ex)

    v = torch.where((best_norm2 > _EPS)[..., None], best, alt)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(_EPS)


def eigh3_descending(A: torch.Tensor):
    """Full eigendecomposition of symmetric [..., 3, 3]: (eigvals [..., 3]
    descending, eigvecs [..., 3, 3] with column k the eigenvector of
    eigvals[..., k])."""
    w = eigvals3_descending(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    vmax = _null_vector(A - w[..., 0, None, None] * eye)
    vmin = _null_vector(A - w[..., 2, None, None] * eye)
    vmin = vmin - (vmin * vmax).sum(-1, keepdim=True) * vmax
    vmin_n = torch.linalg.norm(vmin, dim=-1, keepdim=True)
    ex, ey = _unit(0, vmax), _unit(1, vmax)
    fallback = torch.where((vmax[..., 0].abs() < 0.9)[..., None],
                           torch.linalg.cross(vmax, ex), torch.linalg.cross(vmax, ey))
    fallback = fallback / torch.linalg.norm(fallback, dim=-1, keepdim=True).clamp_min(_EPS)
    vmin = torch.where(vmin_n > 1e-6, vmin / vmin_n.clamp_min(_EPS), fallback)
    vmid = torch.linalg.cross(vmin, vmax)
    return w, torch.stack([vmax, vmid, vmin], dim=-1)
