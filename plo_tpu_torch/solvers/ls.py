"""Trimmed and weighted least-squares solvers (the port of
plo_tpu/solvers/ls.py, solver.cpp:74-220) — RANSAC's "LS" and "Weighted LS"
final solves."""
from __future__ import annotations

import torch

from plo_tpu_torch.solvers.build import build_system, masked_lstsq, se3_from_x


def _rank_by_abs(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank of each valid element by ascending |value|; invalid get N."""
    n = values.shape[0]
    order = torch.argsort(torch.where(valid, values.abs(), torch.inf), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=values.device)
    return torch.where(valid, rank, n)


def solve_ls_trimmed(source, ref, normal, valid, threshold: float):
    """Initial LS solve, then drop BOTH the smallest and largest `threshold`
    fraction of |residuals| (reference quirk, solver.cpp:117-137) and
    re-solve. Returns (deltaTrans 4x4, ok)."""
    A, b = build_system(source, ref, normal, valid)
    residuals = A @ masked_lstsq(A, b) - b
    n_valid = valid.sum()
    rank = _rank_by_abs(residuals, valid)
    lower = (threshold * n_valid.to(torch.float32)).long()
    upper = ((1.0 - threshold) * n_valid.to(torch.float32)).long()
    keep = valid & (rank >= lower) & (rank <= upper)
    x = masked_lstsq(*build_system(source, ref, normal, keep))
    ok = torch.isfinite(x).all() & (n_valid >= 3)
    return se3_from_x(torch.where(ok, x, 0.0)), ok


def solve_weighted_ls(source, ref, normal, valid, weights):
    """Rows scaled by sqrt(w) (solver.cpp:168-220). Returns (deltaTrans, ok)."""
    A, b = build_system(source, ref, normal, valid)
    sw = torch.sqrt(weights.clamp_min(0.0)) * valid.to(torch.float32)
    x = masked_lstsq(A * sw[:, None], b * sw)
    ok = torch.isfinite(x).all() & (valid.sum() >= 3)
    return se3_from_x(torch.where(ok, x, 0.0)), ok
