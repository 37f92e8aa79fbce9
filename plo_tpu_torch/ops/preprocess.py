"""Stage 1 — range gating, ring assignment, relative time, the ring-sorted
compaction and the range-image rasterization (the port of
plo_tpu/ops/preprocess.py, scan_registration.cpp:847-1113).

Points are stable-sorted by ring (arrival order kept within a ring) into one
padded array with per-ring start/count tables; padding and dropped points
carry ring id n_scans and sort last. So every valid point lies below
sum(ring_count) — the valid-prefix property the cylinder_stats kernel's
`t_live` bound relies on (plo_tpu/ops/pallas_nn.py:197-202).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from plo_tpu_torch.config import SensorConfig

# VLP-32C elevation table — 27 entries for 32 rings, a reference quirk kept
# verbatim (scan_registration.cpp:960-964).
VLP32C_ANGLES = np.array(
    [-25.000, -15.639, -11.310, -8.843, -7.254, -6.148, -5.333, -4.667, -4.000,
     -3.667, -3.333, -3.000, -2.667, -2.333, -2.000, -1.667, -1.333, -1.000,
     -0.667, -0.333, 0.000, 0.333, 0.667, 1.000, 1.333, 1.667, 2.333],
    dtype=np.float32,
)


def ring_elevation_table(n_scans: int) -> np.ndarray:
    """Ring/row index -> beam elevation (degrees) of the ring model that ring
    assignment and the grid16 rasterizer bin with, so grid16 reconstruction
    inverts exactly that model (plo_tpu.ops.preprocess.ring_elevation_table).

    16: -15 + 2k (scan_registration.cpp:948-958); 32: the 27-entry VLP-32C
    table (:960-964) padded to 32 rows that ring assignment never produces;
    64: the HDL-64 piecewise formula (:990-1003), rings 51-63 stay empty."""
    if n_scans == 16:
        return (-15.0 + 2.0 * np.arange(16)).astype(np.float32)
    if n_scans == 32:
        pad = VLP32C_ANGLES[-1] + 0.333 * (1 + np.arange(32 - len(VLP32C_ANGLES)))
        return np.concatenate([VLP32C_ANGLES, pad.astype(np.float32)])
    if n_scans == 64:
        upper = 2.0 - np.arange(32) / 3.0
        lower = -8.83 - np.arange(32) / 2.0
        return np.concatenate([upper, lower]).astype(np.float32)
    raise ValueError(f"unsupported n_scans {n_scans}")


@dataclasses.dataclass(frozen=True)
class RingCloud:
    """Ring-sorted compact scan (plo_tpu.ops.preprocess.RingCloud)."""

    xyz: torch.Tensor          # [P, 3] f32
    ring: torch.Tensor         # [P] i64 (== n_scans for padding slots)
    rel_time: torch.Tensor     # [P] f32
    intensity: torch.Tensor    # [P] f32 = ring + 0.1 * rel_time
    valid: torch.Tensor        # [P] bool
    ring_start: torch.Tensor   # [n_scans] i64 — first flat index of each ring
    ring_count: torch.Tensor   # [n_scans] i64
    pos_in_ring: torch.Tensor  # [P] i64 — index within own ring

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def assign_rings(xyz: torch.Tensor, valid: torch.Tensor,
                 n_scans: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized scanID assignment (scan_registration.cpp:948-1003).
    Returns (ring [P] i64, valid [P] with out-of-fan points dropped)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rng2d = torch.sqrt(x * x + y * y)
    angle = torch.rad2deg(torch.atan2(z, rng2d.clamp_min(1e-12)))
    if n_scans == 16:
        ring = torch.floor((angle + 15.0) / 2.0 + 0.5).long()
        ok = (ring >= 0) & (ring < n_scans)
    elif n_scans == 32:
        table = torch.as_tensor(VLP32C_ANGLES, device=xyz.device)
        ring = torch.argmin((angle[:, None] - table[None, :]).abs(), dim=1)
        ok = (ring >= 0) & (ring < n_scans)
    elif n_scans == 64:
        upper_bound, lower_bound = 2.0, -24.33
        ring_hi = torch.floor((upper_bound - angle) * 3.0 + 0.5).long()
        ring_lo = n_scans // 2 + torch.floor((-8.83 - angle) * 2.0 + 0.5).long()
        ring = torch.where(angle >= -8.83, ring_hi, ring_lo)
        # rings > 50 are removed as outliers (scan_registration.cpp:997-1002)
        ok = (angle <= upper_bound) & (angle >= lower_bound) & (ring <= 50) & (ring >= 0)
    else:
        raise ValueError("only 16/32/64 scan lines supported (scan_registration.cpp:1585)")
    return ring.clamp(0, n_scans - 1), valid & ok


def relative_times(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Azimuth -> relTime in [0, 1], the reference's sequential halfPassed
    latch (scan_registration.cpp:899-1041) as a cumulative-or."""
    p = xyz.shape[0]
    pi = math.pi
    ori_raw = -torch.atan2(xyz[:, 1], xyz[:, 0])
    v8 = valid.to(torch.int8)
    first = torch.argmax(v8)
    last = p - 1 - torch.argmax(v8.flip(0))
    start_ori = ori_raw[first]
    end_ori = ori_raw[last] + 2.0 * pi
    span = end_ori - start_ori
    end_ori = torch.where(span > 3.0 * pi, end_ori - 2.0 * pi,
                          torch.where(span < pi, end_ori + 2.0 * pi, end_ori))

    ori_pre = ori_raw
    ori_pre = torch.where(ori_pre < start_ori - pi / 2, ori_pre + 2 * pi, ori_pre)
    ori_pre = torch.where(ori_pre > start_ori + pi * 3 / 2, ori_pre - 2 * pi, ori_pre)

    # The latch flips once ori - startOri > pi; point i branches on the state
    # left by points < i (the reference tests the flag before updating it).
    trigger = (ori_pre - start_ori > pi) & valid
    half_passed_after = torch.cumsum(trigger.to(torch.int32), 0) > 0
    half_passed = torch.cat([half_passed_after.new_zeros(1), half_passed_after[:-1]])

    ori_post = ori_raw + 2.0 * pi
    ori_post = torch.where(ori_post < end_ori - pi * 3 / 2, ori_post + 2 * pi, ori_post)
    ori_post = torch.where(ori_post > end_ori + pi / 2, ori_post - 2 * pi, ori_post)

    ori = torch.where(half_passed, ori_post, ori_pre)
    return (ori - start_ori) / (end_ori - start_ori).clamp_min(1e-9)


def preprocess(pts: torch.Tensor, n_valid: int, sensor: SensorConfig,
               sort: bool = True) -> RingCloud:
    """Stage-1 preprocessing of one padded raw scan [P, >=3] whose first
    `n_valid` rows are returns (plo_tpu.ops.preprocess.preprocess).

    sort=False keeps the arrival order (ring id n_scans on dropped points,
    pos_in_ring zero): for consumers that only rasterize."""
    p = pts.shape[0]
    dev = pts.device
    n_scans = sensor.n_scans
    xyz = pts[:, :3]
    in_cap = torch.arange(p, device=dev) < n_valid

    # NaN removal + 3D range gate (scan_registration.cpp:860-863, :101-102).
    finite = torch.isfinite(xyz).all(dim=-1)
    xyz = torch.where(finite[:, None], xyz, 0.0)
    d2 = (xyz * xyz).sum(-1)
    valid = (in_cap & finite & (d2 >= sensor.minimum_range ** 2)
             & (d2 <= sensor.maximum_range ** 2))

    ring, valid = assign_rings(xyz, valid, n_scans)
    rel_time = torch.where(valid, relative_times(xyz, valid), 0.0)

    ring_u = torch.where(valid, ring, n_scans)
    counts_full = torch.bincount(ring_u, minlength=n_scans + 1)
    starts_full = torch.cumsum(counts_full, 0) - counts_full
    if sort:
        # Stable sort by ring id (padding -> n_scans, sorted last): within a
        # ring the arrival order is kept — the reference's per-ring
        # push_back + concatenation order (:1064-1069).
        ring_s, order = torch.sort(ring_u, stable=True)
        pos_in_ring = torch.arange(p, device=dev) - starts_full[ring_s]
        xyz_s, rel_s, valid_s = xyz[order], rel_time[order], valid[order]
    else:
        ring_s, xyz_s, rel_s, valid_s = ring_u, xyz, rel_time, valid
        pos_in_ring = torch.zeros(p, dtype=torch.int64, device=dev)
    intensity = ring_s.to(torch.float32) + 0.1 * rel_s
    return RingCloud(
        xyz=xyz_s, ring=ring_s, rel_time=rel_s,
        intensity=torch.where(valid_s, intensity, 0.0), valid=valid_s,
        ring_start=starts_full[:n_scans], ring_count=counts_full[:n_scans],
        pos_in_ring=pos_in_ring)


def rasterize_range_image(cloud: RingCloud, height: int, width: int):
    """Scatter-min fill of the dense range image (scan_registration.cpp:
    1045-1057; plo_tpu.ops.preprocess.rasterize_range_image). col =
    floor(relTime * width) clipped; the stored value is the reference's 2D
    range sqrt(x^2 + y^2).

    Among the points that tie at a cell's minimum the one with the largest
    index wins, the point XLA's scatter keeps on the CPU; choosing it with
    one amax scatter makes the write unique, so the card gives the same
    grid. Returns (rng2d [H, W] with +inf holes, xyz [H, W, 3], rel_time
    [H, W], occupied [H, W], src_idx [H, W] index of the winning point)."""
    hw = height * width
    dev = cloud.xyz.device
    col = (cloud.rel_time * width).to(torch.int64).clamp(0, width - 1)
    row = cloud.ring.clamp(0, height - 1)
    cell = torch.where(cloud.valid, row * width + col, hw)
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    # As XLA computes it: x*x + y*y contracted into fma(x, x, y*y) (the f64
    # product of two f32 is exact), then a correctly rounded f32 root (the
    # f64 root of an f32 rounds to it exactly), the same on every device.
    xd = x.double()
    r2 = (xd * xd + (y * y).double()).float()
    rng2d = torch.sqrt(r2.double()).float()
    inf = torch.full((hw + 1,), math.inf, dtype=torch.float32, device=dev)
    flat = inf.scatter_reduce(0, cell, torch.where(cloud.valid, rng2d, math.inf), "amin")
    is_winner = cloud.valid & (rng2d <= flat[cell])
    idx = torch.arange(cloud.capacity, device=dev)
    none = torch.full((hw + 1,), -1, dtype=torch.int64, device=dev)
    win = none.scatter_reduce(0, cell, torch.where(is_winner, idx, -1), "amax")[:hw]
    won = win >= 0
    src = win.clamp_min(0)
    xyz = torch.where(won[:, None], cloud.xyz[src], 0.0)
    rel = torch.where(won, cloud.rel_time[src], 0.0)
    rng_img = flat[:hw].reshape(height, width)
    return (rng_img, xyz.reshape(height, width, 3), rel.reshape(height, width),
            torch.isfinite(rng_img), torch.where(won, src, 0).reshape(height, width))
