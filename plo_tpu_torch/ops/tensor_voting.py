"""Tensor voting (the port of plo_tpu/ops/tensor_voting.py): the saliency
presample (CustomSaliencyDataPointsFilter, scan_registration.cpp:334-490)
and VoteForAny, the voted anchor normals of tensor-voting IMLS
(imls_icp.cpp:171-296).

Each point's tensor is encoded from its PCA eigen-pairs (the "aware tensor"
((l1-l2)/k) S + (l3/k) P, a unit ball where the eigen-data are not finite),
its ball part removed, and the k nearest neighbors vote on it:
S = w R T R' with r = receiver - voter, R = I - 2 r r^T, R' = (I - r r^T / 2) R
and w = exp(-|r|^2 / sigma) (/ sigma, not / sigma^2, imls_icp.cpp:220). The
voted tensor decomposes into surfaceness l1-l2, curveness l2-l3 and
pointness l3; the label is the argmax of (pointness, curveness, surfaceness)
and the effective normal the voted tensor's max eigenvector.
"""
from __future__ import annotations

import dataclasses

import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import IMLSTensorVotingConfig, TensorVotingConfig
from plo_tpu_torch.ops import neighbors
from plo_tpu_torch.ops.eigh3 import eigh3_descending

# Queries a cast_votes block takes: its [Q, k, 3, 3] vote tensors stay
# within ~60 MB each at k = 50 (a capacity-sized cloud is 131,072 queries).
VOTE_BLOCK = 16384


@dataclasses.dataclass(frozen=True)
class SaliencyResult:
    cloud: PointCloud          # normals / curvature replaced by the voted values
    candidates: torch.Tensor   # [P] bool: non-ball points (label != 1)
    labels: torch.Tensor       # [P] i32 in {0: invalid, 1: point, 2: curve, 3: surface}
    surfaceness: torch.Tensor  # [P]
    curveness: torch.Tensor    # [P]
    pointness: torch.Tensor    # [P]
    eigvecs: torch.Tensor      # [P, 3, 3] voted-tensor eigenvectors (descending columns)

    def descriptors(self) -> torch.Tensor:
        """The reference's 22-row DataPoints descriptor block (saver.cpp:
        135-306): rows 0-2 surfaceness / curveness / pointness, 3-5 normals
        (min eigenvector), 6-8 tangents (max eigenvector, the field the
        reference consumes as the normal), 9 labels, 10-13 sticks, 14-20
        plates, 21 balls. Returns [22, P]."""
        e1, e2, e3 = (self.eigvecs[:, :, j].T for j in range(3))
        row = lambda x: x[None, :]
        return torch.cat([
            row(self.surfaceness), row(self.curveness), row(self.pointness), e3, e1,
            row(self.labels.to(torch.float32)),
            row(self.surfaceness), e1,
            row(self.curveness), e1, e2,
            row(self.pointness),
        ])


def encode_aware_tensors(eigvals: torch.Tensor, eigvecs: torch.Tensor, k: float) -> torch.Tensor:
    """Aware-tensor encoding (scan_registration.cpp:362-388). eigvals [P, 3]
    (abs taken, as the reference does), eigvecs [P, 3, 3] with descending
    columns; a unit ball where the eigenvalues are not finite."""
    va = eigvals.abs()
    l1 = va.max(-1).values
    l3 = va.min(-1).values
    l2 = va.sum(-1) - l1 - l3
    e1, e2 = eigvecs[:, :, 0], eigvecs[:, :, 1]
    s = torch.einsum("pi,pj->pij", e1, e1)
    p = s + torch.einsum("pi,pj->pij", e2, e2)
    t = ((l1 - l2) / k)[:, None, None] * s + (l3 / k)[:, None, None] * p
    bad = ~torch.isfinite(va).all(-1)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return torch.where(bad[:, None, None], eye, t)


def remove_ball_component(t: torch.Tensor) -> torch.Tensor:
    """disableBallComponent: subtract each tensor's isotropic part (its
    smallest eigenvalue times I)."""
    w, _ = eigh3_descending(t)
    return t - w[:, 2, None, None] * torch.eye(3, dtype=t.dtype, device=t.device)


def _vote_kernel(r: torch.Tensor, t_voter: torch.Tensor, sigma: float) -> torch.Tensor:
    """One vote w R T R' for receiver - voter offsets r [..., 3] and voter
    tensors T [..., 3, 3] (imls_icp.cpp:219-224)."""
    d2 = (r * r).sum(-1)
    rn = r / torch.sqrt(d2).clamp_min(1e-12)[..., None]
    rrt = rn[..., :, None] * rn[..., None, :]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    rot = eye - 2.0 * rrt
    rot_p = (eye - 0.5 * rrt) @ rot
    w = torch.exp(-d2 / sigma)
    return w[..., None, None] * (rot @ t_voter @ rot_p)


def cast_votes(query_xyz: torch.Tensor, query_valid: torch.Tensor,
               voter_xyz: torch.Tensor, voter_valid: torch.Tensor,
               voter_tensors: torch.Tensor, k: int, sigma: float,
               distance_threshold: float = float("inf"), exclude_self: bool = True):
    """The votes of each query's k nearest valid voters, gated by
    0 < |r| / sigma < distance_threshold (imls_icp.cpp:212-217) and, with
    exclude_self, |r|^2 > 1e-20. Runs in blocks of VOTE_BLOCK queries (the
    same per-query results, less memory). Returns (voted tensors [Q, 3, 3],
    received_any [Q])."""
    acc, received = [], []
    cap = voter_xyz.shape[0]
    for b in range(0, query_xyz.shape[0], VOTE_BLOCK):
        q = query_xyz[b:b + VOTE_BLOCK]
        d2, idx, ok = neighbors.knn(q, voter_xyz, voter_valid, k=k)
        idx_c = idx.clamp(0, cap - 1)
        r = q[:, None, :] - voter_xyz[idx_c]
        dist_sig = torch.sqrt(d2.clamp_min(0.0)) / sigma
        gate = ok & (dist_sig > 0.0) & (dist_sig < distance_threshold)
        if exclude_self:
            gate = gate & (d2 > 1e-20)
        votes = torch.where(gate[..., None, None],
                            _vote_kernel(r, voter_tensors[idx_c], sigma), 0.0)
        acc.append(votes.sum(1))
        received.append(query_valid[b:b + VOTE_BLOCK] & gate.any(1))
    return torch.cat(acc), torch.cat(received)


def decompose(t: torch.Tensor):
    """Saliencies of voted tensors [P, 3, 3] (scan_registration.cpp:416-428):
    (surfaceness, curveness, pointness, eigenvectors [P, 3, 3] in descending
    columns, so the stick is [:, :, 0], labels = 1 + argmax(pointness,
    curveness, surfaceness), the first on ties)."""
    w, v = eigh3_descending(t)
    surfaceness = w[:, 0] - w[:, 1]
    curveness = w[:, 1] - w[:, 2]
    pointness = w[:, 2]
    coeff = torch.stack([pointness, curveness, surfaceness], dim=1)
    labels = torch.argmax(coeff, dim=1).to(torch.int32) + 1
    return surfaceness, curveness, pointness, v, labels


def _plus_z(stick: torch.Tensor) -> torch.Tensor:
    """The stick direction flipped into the +z hemisphere, unit length."""
    n = stick * torch.where(stick[:, 2:3] < 0, -1.0, 1.0)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)


def saliency_presample(cloud: PointCloud, eigvecs: torch.Tensor,
                       cfg: TensorVotingConfig) -> SaliencyResult:
    """The tensor-voting presample (applySaliencyFilter and the candidate
    selection, scan_registration.cpp:455-490, 1409-1446): the cloud's points
    vote among themselves; a point stays valid if it received a vote, takes
    the voted normal (+z hemisphere) and surfaceness as its curvature
    (common.h:96-99), and is a candidate unless its label is 1 (ball)."""
    t_in = remove_ball_component(encode_aware_tensors(cloud.eigvals, eigvecs, float(cfg.k)))
    voted, received = cast_votes(cloud.xyz, cloud.valid, cloud.xyz, cloud.valid,
                                 t_in, cfg.k, cfg.sigma)
    surfaceness, curveness, pointness, voted_vecs, labels = decompose(voted)
    valid = cloud.valid & received
    labels = torch.where(valid, labels, 0)
    out = dataclasses.replace(
        cloud, normal=torch.where(valid[:, None], _plus_z(voted_vecs[:, :, 0]), 0.0),
        curvature=torch.where(valid, surfaceness, 0.0), valid=valid)
    return SaliencyResult(cloud=out, candidates=valid & (labels != 1), labels=labels,
                          surfaceness=surfaceness, curveness=curveness,
                          pointness=pointness, eigvecs=voted_vecs)


def vote_for_any(target_xyz: torch.Tensor, target_valid: torch.Tensor,
                 target_normal: torch.Tensor, query_xyz: torch.Tensor,
                 query_valid: torch.Tensor, cfg: IMLSTensorVotingConfig):
    """VoteForAny (imls_icp.cpp:171-296): normals for arbitrary query points,
    voted from the target's stick tensors n n^T; the query normal is the
    voted stick direction in the +z hemisphere (:271-276). Returns
    (normals [Q, 3], ok [Q])."""
    t_t = target_normal[:, :, None] * target_normal[:, None, :]
    voted, received = cast_votes(query_xyz, query_valid, target_xyz, target_valid, t_t,
                                 cfg.k, cfg.sigma, distance_threshold=cfg.distance_threshold)
    _, _, _, v, _ = decompose(voted)
    return torch.where(received[:, None], _plus_z(v[:, :, 0]), 0.0), received
