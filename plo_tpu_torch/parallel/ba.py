"""Windowed bundle adjustment, on one device and sharded (the port of
plo_tpu/parallel/ba.py).

A window of K poses is refined by Gauss-Newton over recorded point-to-plane
correspondences between frame pairs (i, j):

    r = n . ((T_i)^-1 T_j s - y)

with s in frame j and (y, n) in frame i. Pose updates are right
perturbations T <- T exp(xi); the window's first pose is gauge-fixed.

As in plo_tpu, each pair forms a dense Jacobian [N, 6(K-1)] and adds J^T J,
so the float32 sums run in the same order; the 6(K-1) system is solved with
torch.linalg.solve_ex, which leaves the result on the device (torch.linalg.
solve checks for errors by waiting for the host on CUDA). `refine_window`
makes no host sync.

The sharded form (`make_distributed_refine`) cuts the correspondences over a
mesh's shards on their point axis: each shard assembles its partial normal
equations, which are summed over the shards in shard order (sharding.psum,
one 6(K-1) system a Gauss-Newton step), and the solve and the pose update run
replicated.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.parallel import sharding


def _residual_jacobian(T_rel, src, ref, normal, valid):
    """Residuals and Jacobian blocks of one frame pair: (r [N], Ji [N, 6],
    Jj [N, 6]), each 6-vector [rotation, translation], zero where invalid."""
    p = geo.transform_points(T_rel, src)          # T_i^-1 T_j s, in frame i
    r = (normal * (p - ref)).sum(-1)
    nR = normal @ T_rel[:3, :3]                   # n^T R_rel
    m = valid.to(torch.float32)[:, None]
    Ji = torch.cat([-torch.linalg.cross(p, normal), -normal], dim=1) * m
    Jj = torch.cat([torch.linalg.cross(src, nR), nR], dim=1) * m
    return r * valid.to(torch.float32), Ji, Jj


def _assemble(poses, src, ref, normal, valid, k_window: int,
              pairs: Optional[Sequence[Tuple[int, int]]] = None,
              huber_delta: Optional[float] = None):
    """The window's normal equations (H [6(K-1), 6(K-1)], g [6(K-1)]).
    poses [K, 4, 4]; src, ref, normal [P, N, 3] and valid [P, N] for the P
    pose pairs `pairs` (default: the consecutive chain), src[p] in frame j's
    coordinates and (ref, normal)[p] in frame i's. With `huber_delta`, each
    residual takes the IRLS Huber weight sqrt(min(1, delta / |r|))."""
    dof = 6 * (k_window - 1)
    dev = poses.device
    H = torch.zeros((dof, dof), dtype=torch.float32, device=dev)
    g = torch.zeros(dof, dtype=torch.float32, device=dev)
    for p, (i, j) in enumerate(pairs or [(k, k + 1) for k in range(k_window - 1)]):
        T_rel = geo.se3_inverse(poses[i]) @ poses[j]
        r, Ji, Jj = _residual_jacobian(T_rel, src[p], ref[p], normal[p], valid[p])
        if huber_delta is not None:
            w = torch.sqrt(torch.clamp(huber_delta / r.abs().clamp_min(1e-12), max=1.0))
            r, Ji, Jj = r * w, Ji * w[:, None], Jj * w[:, None]
        J = torch.zeros((src.shape[1], dof), dtype=torch.float32, device=dev)
        if i > 0:
            J[:, 6 * (i - 1):6 * i] = Ji
        if j > 0:
            J[:, 6 * (j - 1):6 * j] = Jj
        H = H + J.T @ J
        g = g + J.T @ r
    return H, g


def refine_window(poses, src, ref, normal, valid, k_window: int, iterations: int = 5,
                  damping: float = 1e-6, pairs: Optional[Sequence[Tuple[int, int]]] = None,
                  huber_delta: Optional[float] = None) -> torch.Tensor:
    """Gauss-Newton refinement of a K-pose window: `iterations` steps of
    (H + damping I) delta = -g and T_i <- T_i exp(delta_i) for i = 1..K-1.
    Arguments as _assemble's; returns the refined poses [K, 4, 4] f32."""
    for _ in range(iterations):
        H, g = _assemble(poses, src, ref, normal, valid, k_window, pairs, huber_delta)
        poses = _update(poses, H, g, k_window, damping)
    return poses


def _update(poses, H, g, k_window: int, damping: float) -> torch.Tensor:
    """One Gauss-Newton step: (H + damping I) delta = -g, then
    T_i <- T_i exp(delta_i) for i = 1..K-1."""
    eye = torch.eye(H.shape[0], dtype=torch.float32, device=poses.device)
    delta = -torch.linalg.solve_ex(H + damping * eye, g)[0]
    return torch.stack([poses[0]] + [
        poses[i] @ geo.make_se3(geo.exp_so3(delta[6 * (i - 1):6 * (i - 1) + 3]),
                                delta[6 * (i - 1) + 3:6 * i])
        for i in range(1, k_window)])


def make_distributed_refine(mesh: "sharding.Mesh", k_window: int, iterations: int = 5,
                            damping: float = 1e-6,
                            pairs: Optional[Sequence[Tuple[int, int]]] = None):
    """refine_window with the correspondences sharded over the mesh's point
    axis: each shard's (H, g) summed over the shards in shard order, the
    solve and update replicated (plo_tpu.parallel.ba.make_distributed_refine).
    Returns refine(poses, src, ref, normal, valid) -> refined poses [K, 4, 4]
    on mesh.device."""

    def refine(poses, src, ref, normal, valid):
        shards = [sharding.shard_rows(mesh, x.transpose(0, 1))
                  for x in (src, ref, normal, valid)]
        local = [[x[j].transpose(0, 1) for x in shards] for j in range(mesh.n_local)]
        poses = poses.to(mesh.device)
        for _ in range(iterations):
            pose_parts = sharding.replicate(poses, mesh)
            systems = [_assemble(p, *part, k_window, pairs)
                       for p, part in zip(pose_parts, local)]
            H = sharding.psum(mesh, [h for h, _ in systems])
            g = sharding.psum(mesh, [g for _, g in systems])
            poses = _update(poses, H, g, k_window, damping)
        return poses

    return refine
