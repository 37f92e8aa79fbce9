"""Degeneracy-aware probabilistic solver — DRPM (the port of
plo_tpu/solvers/drpm.py; SolveMotionEstimationProblemDRPM, solver.cpp:499-603,
degeneracy.h:5-131).

Weighted H = A^T W A -> eigen-structure -> per-direction noise mean and
variance from isotropic point/normal noise -> signal-to-noise probability
through the normal CDF (snr_factor 10) -> if the least probable direction is
below threshold, the probability-weighted pseudo-inverse; else weighted LS.
The normal CDF is torch.special.ndtr (jax.scipy.stats.norm.cdf in plo_tpu).
"""
from __future__ import annotations

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.solvers.build import build_system, masked_lstsq, se3_from_x

SNR_FACTOR = 10.0  # solver.cpp:547


def compute_noise_estimate(points, normals, weights, valid, U,
                           stdev_points: float, stdev_normals: float):
    """degeneracy::ComputeNoiseEstimate (degeneracy.h:14-72) in the closed
    form of plo_tpu.solvers.drpm.compute_noise_estimate: the per-point 6x6
    tensors B Ncov B^T reduce to 3x3 moment sums over {n, p, p x n}.
    Returns (mean [6, 6], variance [6])."""
    w = weights * valid.to(torch.float32)
    sp2 = stdev_points ** 2
    sn2 = stdev_normals ** 2
    p, n = points, normals
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    pxn = torch.linalg.cross(p, n)
    n2 = (n * n).sum(-1)
    p2 = (p * p).sum(-1)

    wn2 = w * n2
    M_sum = wn2.sum() * eye - torch.einsum("n,ni,nj->ij", w, n, n)
    TL2 = ((wn2 * p2).sum() * eye - torch.einsum("n,ni,nj->ij", wn2, p, p)
           - torch.einsum("n,ni,nj->ij", w, pxn, pxn))
    S_n2_p = torch.einsum("n,ni->i", wn2, p)
    TR = sn2 * (geo.hat(S_n2_p[None])[0] - torch.einsum("n,ni,nj->ij", w, pxn, n))

    mean = torch.zeros((6, 6), dtype=p.dtype, device=p.device)
    mean[0:3, 0:3] = sp2 * M_sum + sn2 * TL2
    mean[0:3, 3:6] = TR
    mean[3:6, 0:3] = TR.T
    mean[3:6, 3:6] = sn2 * M_sum

    # a_nk = u_k^T (w_n B Ncov B^T) u_k with u_k = [u1; u2], c = -(p x u1):
    # a/w = sp2 (u1^T M u1) + sn2 (c^T M c + 2 c^T M u2 + u2^T M u2),
    # x^T M y = |n|^2 (x.y) - (n.x)(n.y).
    u1, u2 = U[0:3, :], U[3:6, :]
    ndot1 = n @ u1
    ndot2 = n @ u2
    c = -torch.linalg.cross(p[:, None, :].expand(-1, 6, 3), u1.T[None].expand(p.shape[0], 6, 3))
    ndotc = torch.einsum("nki,ni->nk", c, n)
    c2 = (c * c).sum(-1)
    cdotu2 = torch.einsum("nki,ik->nk", c, u2)
    u1sq = (u1 * u1).sum(0)[None, :]
    u2sq = (u2 * u2).sum(0)[None, :]
    n2c = n2[:, None]
    quad = (sp2 * (n2c * u1sq - ndot1 ** 2)
            + sn2 * ((n2c * c2 - ndotc ** 2)
                     + 2.0 * (n2c * cdotu2 - ndotc * ndot2)
                     + (n2c * u2sq - ndot2 ** 2)))
    a = w[:, None] * quad
    sw = torch.sqrt(w)
    bb = torch.cat([sw[:, None] * pxn, sw[:, None] * n], dim=1) @ U
    var = (2.0 * a * a + 4.0 * a * bb * bb).sum(0)
    return mean, var


def signal_to_noise_probabilities(H, noise_mean, noise_var, U):
    """degeneracy::ComputeSignalToNoiseProbabilities (degeneracy.h:74-105)."""
    measurement = torch.einsum("ik,ij,jk->k", U, H, U)
    expected_noise = torch.einsum("ik,ij,jk->k", U, noise_mean, U)
    stdev = torch.sqrt(noise_var.clamp_min(0.0))
    test_point = measurement / (1.0 + SNR_FACTOR)
    prob = torch.special.ndtr((test_point - expected_noise) / stdev.clamp_min(1e-20))
    bad = ~(torch.isfinite(expected_noise) & torch.isfinite(stdev) & torch.isfinite(test_point))
    return torch.where(bad, 0.0, prob)


def solve_drpm(source, ref, normal, valid, weights, threshold: float,
               stdev_points: float, stdev_normals: float):
    """Returns (deltaTrans 4x4, ok, probabilities [6])."""
    A, b = build_system(source, ref, normal, valid)
    sw = torch.sqrt(weights.clamp_min(0.0)) * valid.to(torch.float32)
    Aw = A * sw[:, None]
    bw = b * sw

    # Eigen-structure of H = Aw^T Aw from the SVD of Aw (lambda = sigma^2,
    # ascending as Eigen's SelfAdjointEigenSolver): forming H in f32 would
    # square the condition number the SNR pseudo-inverse divides by.
    W, sig, vt = torch.linalg.svd(Aw, full_matrices=False)
    order = torch.argsort(sig)
    sig = sig[order]
    U = vt.T[:, order]
    W = W[:, order]
    eigvals = sig * sig
    H = (U * eigvals[None, :]) @ U.T

    noise_mean, noise_var = compute_noise_estimate(
        source, normal, weights, valid, U, stdev_points, stdev_normals)
    probs = signal_to_noise_probabilities(H, noise_mean, noise_var, U)

    # SNR pseudo-inverse (degeneracy.h:107-131): x = U diag(p/sigma) W^T b.
    d_psinv = torch.where(eigvals > 1e-10, probs / sig.clamp_min(1e-20), 0.0)
    x_snr = U @ (d_psinv * (W.T @ bw))
    x_wls = masked_lstsq(Aw, bw)
    x = torch.where(probs.min() < threshold, x_snr, x_wls)
    ok = torch.isfinite(x).all() & (valid.sum() >= 3)
    return se3_from_x(torch.where(ok, x, 0.0)), ok, probs
