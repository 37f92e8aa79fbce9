"""Per-point motion compensation, "undistortion" (the port of
plo_tpu/ops/undistort.py).

The reference declares the capability and ships it disabled (DISTORTION 0,
laser_odometry.cpp:29,119-124,459). Each point moves by the fractional pose
exp(rel_time * log(T_rel)): constant-velocity compensation with the point's
relative sweep time, which preprocessing encodes in the intensity
(ring + 0.1 * relTime, scan_registration.cpp:1042).
"""
from __future__ import annotations

import dataclasses

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.cloud import PointCloud


def undistort_cloud(cloud: PointCloud, rel_pose: torch.Tensor) -> PointCloud:
    """Move each valid point into the scan-start frame assuming constant
    velocity over the sweep: p' = interp(rel_pose, rel_time_p) @ p."""
    rel_time = ((cloud.intensity - torch.floor(cloud.intensity)) / 0.1).clamp(0.0, 1.0)
    T = geo.interpolate_pose(rel_pose, rel_time)          # [P, 4, 4]
    xyz = torch.einsum("pij,pj->pi", T[:, :3, :3], cloud.xyz) + T[:, :3, 3]
    return dataclasses.replace(cloud, xyz=torch.where(cloud.valid[:, None], xyz, cloud.xyz))
