"""TEASER-style robust registration (the port of plo_tpu/solvers/gnc.py; the
Teaser solver slot, solver.cpp:436-483):
  1. with estimate_scaling, the scale as the median ratio of
     translation-invariant measurement norms over sampled pairs;
  2. with use_max_clique, inlier pruning by the maximum non-empty k-core of
     the TIM consistency graph (edge iff | |s_i - s_j| - |r_i - r_j| | <=
     2 noise_bound), found by a binary search over k with a fixed number of
     peeling rounds — TEASER's k-core heuristic for the max clique;
  3. graduated non-convexity on the survivors: GNC_TLS (truncated least
     squares, mu annealed up), FGR (Geman-McClure, annealed down) or QUATRO
     (GNC-TLS weights, yaw-only alignment).
The pair draws of step 1 come in as arguments. The GNC loop with a cost
threshold is plo_tpu's while_loop as a fixed number of predicated
iterations: the state freezes once the cost has converged, with no host
sync.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.solvers.icp_umeyama import umeyama

ALGORITHMS = ("GNC_TLS", "FGR", "QUATRO")


def _consistency_kcore(source, ref, valid, noise_bound: float, peel_iters: int = 12):
    """The maximum non-empty k-core of the TIM consistency graph, as a bool
    [N] inlier mask: 17 rounds of binary search over k, each probe peeling
    vertices of in-core degree < k for peel_iters rounds ([N, N] matvecs)."""
    n = source.shape[0]
    ds = torch.linalg.norm(source[:, None, :] - source[None, :, :], dim=-1)
    dr = torch.linalg.norm(ref[:, None, :] - ref[None, :, :], dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=source.device)
    adj = ((ds - dr).abs() <= 2.0 * noise_bound) & valid[:, None] & valid[None, :] & ~eye
    adj_f = adj.to(torch.float32)

    def core(k):
        keep = valid.to(torch.float32)
        for _ in range(peel_iters):
            keep = keep * ((adj_f @ keep) >= k).to(torch.float32)
        return keep

    lo = torch.ones((), dtype=torch.int64, device=source.device)
    hi = torch.full((), n, dtype=torch.int64, device=source.device)
    best = core(1.0)   # invariant: the lo-core is non-empty, the hi-core empty
    for _ in range(17):
        mid = (lo + hi) // 2
        keep = core(mid.to(torch.float32))
        nonempty = keep.sum() > 0
        lo, hi = torch.where(nonempty, mid, lo), torch.where(nonempty, hi, mid)
        best = torch.where(nonempty, keep, best)
    return best > 0.5


def _estimate_scale(source, ref, valid, pairs: Tuple[torch.Tensor, torch.Tensor]):
    """Median of |r_a - r_b| / |s_a - s_b| over the drawn index pairs (ia, ib)
    that are valid, distinct and not degenerate; 1 with fewer than 3
    (teaser::ScalarTLSEstimator, median flavor)."""
    ia, ib = pairs
    n_pairs = ia.shape[0]
    ok = valid[ia] & valid[ib] & (ia != ib)
    ns = torch.linalg.norm(source[ia] - source[ib], dim=-1)
    nr = torch.linalg.norm(ref[ia] - ref[ib], dim=-1)
    ratio = torch.where(ok & (ns > 1e-6), nr / ns.clamp_min(1e-6), math.nan)
    srt = torch.sort(ratio).values   # NaNs sort last
    count = torch.isfinite(ratio).sum()
    med = srt.gather(0, ((count - 1) // 2).clamp(0, n_pairs - 1).reshape(1))[0]
    return torch.where(count >= 3, med, 1.0)


def _umeyama_yaw(source, ref, w):
    """Weighted yaw-only alignment: rotation about z by the 2-D Procrustes
    angle atan2(sum w (sx ry - sy rx), sum w (sx rx + sy ry)) of the
    centered pairs, and a full translation."""
    wsum = w.sum().clamp_min(1e-12)
    mu_s = (source * w[:, None]).sum(0) / wsum
    mu_r = (ref * w[:, None]).sum(0) / wsum
    s, r = source - mu_s, ref - mu_r
    num = (w * (s[:, 0] * r[:, 1] - s[:, 1] * r[:, 0])).sum()
    den = (w * (s[:, 0] * r[:, 0] + s[:, 1] * r[:, 1])).sum()
    theta = torch.atan2(num, torch.where(den.abs() > 1e-20, den, 1e-20))
    c, sn = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -sn, zero]), torch.stack([sn, c, zero]),
                     torch.stack([zero, zero, one])])
    return R, mu_r - R @ mu_s


def solve_gnc_tls(source, ref, valid, noise_bound: float = 0.01, gnc_factor: float = 1.4,
                  max_iterations: int = 64, use_max_clique: bool = False,
                  kcore_min_fraction: float = 0.0, estimate_scaling: bool = False,
                  pairs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  algorithm: str = "GNC_TLS", cost_threshold: float = 0.0):
    """Returns (deltaTrans 4x4, ok). With use_max_clique the k-core replaces
    the valid set unless it is a sliver (< 3 points or below
    kcore_min_fraction of them). With estimate_scaling, `pairs` are the
    drawn index pairs of _estimate_scale and the scale is folded into R.
    cost_threshold > 0 stops the loop once the weighted truncated cost
    changes by less than it (TEASER's convergence test)."""
    dev = source.device
    nb = np.float32(noise_bound)
    eps2 = float(max(nb * nb, np.float32(1e-12)))
    base_w = valid.to(torch.float32)
    scale = _estimate_scale(source, ref, valid, pairs) if estimate_scaling else 1.0
    src = source * scale
    if use_max_clique:
        core = _consistency_kcore(src, ref, valid, float(nb))
        n_core = core.to(torch.float32).sum()
        use_core = (n_core >= 3) & (n_core / base_w.sum().clamp_min(1.0) >= kcore_min_fraction)
        base_w = torch.where(use_core, core.to(torch.float32) * base_w, base_w)
    align = _umeyama_yaw if algorithm == "QUATRO" else umeyama
    fgr = algorithm == "FGR"

    R, t = align(src, ref, base_w + 1e-9)
    r2 = ((src @ R.T + t - ref) ** 2).sum(-1)
    r2_max = torch.where(base_w > 0, r2, 0.0).max().clamp_min(eps2)
    mu = r2_max / eps2 if fgr else (1.0 / (2.0 * r2_max / eps2 - 1.0)).clamp_min(1e-6)

    def weights(r2, mu):
        if fgr:
            m = mu * eps2
            return (m / (m + r2)) ** 2
        up = (mu + 1.0) / mu * eps2
        lo = mu / (mu + 1.0) * eps2
        w = torch.where(r2 <= lo, 1.0, torch.where(
            r2 >= up, 0.0, torch.sqrt(eps2 * mu * (mu + 1.0) / r2.clamp_min(1e-20)) - mu))
        return w.clamp(0.0, 1.0)

    done = torch.zeros((), dtype=torch.bool, device=dev)
    prev_cost = torch.full((), math.inf, dtype=torch.float32, device=dev)
    for _ in range(min(max_iterations, 64)):
        r2 = ((src @ R.T + t - ref) ** 2).sum(-1)
        w = weights(r2, mu) * base_w
        R2, t2 = align(src, ref, w + 1e-9)
        cost = (w * r2.clamp_max(eps2)).sum()
        mu2 = (mu / gnc_factor).clamp_min(1.0) if fgr else mu * gnc_factor
        converged = ((cost - prev_cost).abs() < cost_threshold if cost_threshold > 0.0
                     else done)
        # Predicated: once done, the state stays as it was (the while_loop's exit).
        R, t, mu, prev_cost = (torch.where(done, old, new) for old, new in
                               ((R, R2), (t, t2), (mu, mu2), (prev_cost, cost)))
        done = done | converged
    ok = torch.isfinite(R).all() & torch.isfinite(t).all() & (valid.sum() >= 3)
    R = torch.where(ok, R, torch.eye(3, dtype=torch.float32, device=dev))
    return geo.make_se3(R * scale, torch.where(ok, t, 0.0)), ok
