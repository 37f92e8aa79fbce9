"""Batched RANSAC point-to-plane solver (the port of
plo_tpu/solvers/ransac.py; SolveMotionEstimationProblemRANSAC,
solver.cpp:222-385).

All hypotheses are seeded (FPS-3, common.cpp:19-85), solved (min-norm 3x6)
and scored in one batch; the reference's sequential early exit is recovered
with a prefix cumulative max. Staged evaluation scores the first 256
hypotheses and generates the rest only when none of them reaches
min_inliers — the winner is the same either way. That decision is one
device-to-host sync (JAX takes it with lax.cond on the device).

Random numbers come in as `draws`: for each hypothesis the rank, among the
valid correspondences in index order, of its first seed point (JAX draws
them with jax.random.randint(key, (max_iterations,), 0, n_valid)).
"""
from __future__ import annotations

import math

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.config import RANSACConfig
from plo_tpu_torch.solvers.build import build_system
from plo_tpu_torch.solvers.drpm import solve_drpm
from plo_tpu_torch.solvers.ls import solve_ls_trimmed, solve_weighted_ls

STAGE = 256


def _fps23_from_firsts(xyz: torch.Tensor, valid: torch.Tensor, firsts: torch.Tensor):
    """Farthest-first picks 2 and 3 for first picks [M] -> seeds [M, 3].
    Squared distances in matmul form: the argmax picks are invariant under
    the square, and far-apart seeds make its f32 cancellation irrelevant."""
    n = xyz.shape[0]
    col = torch.arange(n, device=xyz.device)[None, :]
    x2 = (xyz * xyz).sum(-1)

    def sqdist(pts):
        return ((pts * pts).sum(-1)[:, None] - 2.0 * (pts @ xyz.T) + x2[None, :]).clamp_min(0.0)

    d1 = torch.where(valid[None, :], sqdist(xyz[firsts]), -math.inf)
    d1 = torch.where(col == firsts[:, None], -math.inf, d1)
    seconds = torch.argmax(d1, dim=1)
    min_d = torch.minimum(d1, torch.where(valid[None, :], sqdist(xyz[seconds]), -math.inf))
    min_d = torch.where(col == seconds[:, None], -math.inf, min_d)
    thirds = torch.argmax(min_d, dim=1)
    return torch.stack([firsts, seconds, thirds], dim=1)


def _solve_seeds(A3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Min-norm solutions of [M] 3x6 seed systems, x = A^T (A A^T)^-1 b, with
    the closed-form adjugate inverse of the 3x3 Gram matrix."""
    G = A3 @ A3.transpose(1, 2) + 1e-9 * torch.eye(3, dtype=A3.dtype, device=A3.device)
    g = lambda i, j: G[:, i, j]
    c00 = g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1)
    c01 = g(1, 2) * g(2, 0) - g(1, 0) * g(2, 2)
    c02 = g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0)
    det = g(0, 0) * c00 + g(0, 1) * c01 + g(0, 2) * c02
    adj = torch.stack([
        torch.stack([c00, g(0, 2) * g(2, 1) - g(0, 1) * g(2, 2), g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1)], -1),
        torch.stack([c01, g(0, 0) * g(2, 2) - g(0, 2) * g(2, 0), g(0, 2) * g(1, 0) - g(0, 0) * g(1, 2)], -1),
        torch.stack([c02, g(0, 1) * g(2, 0) - g(0, 0) * g(2, 1), g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0)], -1),
    ], dim=-2)
    lam = (adj @ b3[..., None])[..., 0] / torch.where(det.abs() > 1e-30, det, 1e-30)[:, None]
    return (A3.transpose(1, 2) @ lam[..., None])[..., 0]


def _score(source, ref, normal, valid, R, t, distance_threshold: float):
    """Inlier counts [M]: |<R_m, n_p s_p^T> + t_m.n_p - ref_p.n_p| < thr."""
    P = torch.einsum("ni,nj->nij", normal, source).reshape(-1, 9).T
    c = (ref * normal).sum(-1)
    term = R.reshape(-1, 9) @ P + t @ normal.T - c[None, :]
    return ((term.abs() < distance_threshold) & valid[None, :]).sum(1)


def _pick(counts: torch.Tensor, min_inliers: torch.Tensor) -> torch.Tensor:
    """The sequential loop's winner (solver.cpp:316-326): the first max
    within the prefix that ends where the running best first exceeds
    min_inliers (the whole stream when it never does)."""
    m = counts.shape[0]
    exceeded = (torch.cummax(counts, 0).values > min_inliers).to(torch.int32)
    stop = torch.where(exceeded.any(), torch.argmax(exceeded), m - 1)
    prefix = torch.arange(m, device=counts.device) <= stop
    return torch.argmax(torch.where(prefix, counts, -1))


def solve_ransac(source, ref, normal, valid, draws: torch.Tensor, cfg: RANSACConfig):
    """Returns (deltaTrans 4x4, ok, DRPM probabilities [6]; ones when the
    final solve is not DRPM). `draws` [max_iterations] i64 in [0, n_valid)."""
    m = cfg.max_iterations
    thr = cfg.distance_threshold
    n_valid = valid.sum()
    min_inliers = (cfg.min_inliers_percentage * n_valid.to(torch.float32)).long()
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    firsts = order[draws]
    A_full, b_full = build_system(source, ref, normal, valid)

    def hypotheses(f):
        seeds = _fps23_from_firsts(source, valid, f)
        x = _solve_seeds(A_full[seeds], b_full[seeds])
        return geo.exp_so3(x[:, :3]), x[:, 3:6]

    if m <= 2 * STAGE:
        R_all, t_all = hypotheses(firsts)
        best = _pick(_score(source, ref, normal, valid, R_all, t_all, thr), min_inliers)
    else:
        R_all, t_all = hypotheses(firsts[:STAGE])
        counts = _score(source, ref, normal, valid, R_all, t_all, thr)
        if not bool((counts > min_inliers).any()):  # host sync: the stage decision
            R_b, t_b = hypotheses(firsts[STAGE:])
            counts = torch.cat([counts, _score(source, ref, normal, valid, R_b, t_b, thr)])
            R_all, t_all = torch.cat([R_all, R_b]), torch.cat([t_all, t_b])
        best = _pick(counts, min_inliers)
    R_best, t_best = R_all[best], t_all[best]

    # Inlier refit with exp-Huber weights (solver.cpp:328-364).
    dist = (((source @ R_best.T + t_best) - ref) * normal).sum(-1).abs()
    inlier = valid & (dist < thr)
    h2 = cfg.huber_threshold * thr
    e = torch.exp(-dist)
    w = torch.where(torch.sqrt(e) < h2, e, 2.0 * h2 * torch.sqrt(e) - h2 * h2)
    w = torch.where(inlier, w, 0.0)
    wsum = w.sum()
    w = torch.where(wsum > 0, w / wsum.clamp_min(1e-20), w)

    probs = torch.ones(6, dtype=torch.float32, device=source.device)
    method = cfg.final_solve_method
    if method == "LS":
        T, ok = solve_ls_trimmed(source, ref, normal, inlier, cfg.ls_threshold)
    elif method == "Weighted LS":
        T, ok = solve_weighted_ls(source, ref, normal, inlier, w)
    elif method == "DRPM":
        T, ok, probs = solve_drpm(source, ref, normal, inlier, w, cfg.drpm_threshold,
                                  cfg.drpm_stdev_points, cfg.drpm_stdev_normals)
    else:
        raise ValueError(f"invalid RANSAC final_solve_method {method!r}")
    return T, ok & (n_valid >= 3), probs
