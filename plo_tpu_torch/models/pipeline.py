"""Front-end driver — the scan-registration pipeline, pointcloud path (the
port of plo_tpu/models/pipeline.py::FrontEnd, scan_registration.cpp:809-1560).

Stages: preprocess -> PCA normals -> geometric-features or curvature
presample -> random sampling, normal sampling (first frame, and the "normal"
method) or major-axis sampling against the previous filtered cloud. Outputs the model cloud
("/laser_cloud_filtered") and the sampled cloud ("/laser_cloud_flat").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from plo_tpu_torch import resolve_device
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.ops import features, normals as normals_ops, preprocess as pre_ops
from plo_tpu_torch.ops import sampling


@dataclasses.dataclass(frozen=True)
class FrontEndOutput:
    filtered: PointCloud   # model cloud (scan_registration.cpp:1460,1504)
    flat: PointCloud       # sampled cloud (:1499-1501)
    stats: Dict[str, torch.Tensor]


class FrontEnd:
    """The per-config front-end on one device."""

    def __init__(self, cfg: Config, capacity: int = 131072, device=None):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        sr = cfg.scan_registration
        cn = sr.compute_normal_method
        if (cn.format, cn.method) != ("pointcloud", "pca"):
            raise NotImplementedError(
                f"compute_normal_method {cn.format}/{cn.method}: the port covers pointcloud/pca")
        self.presample_method = sr.presample_method.method
        if self.presample_method not in ("geometric_features", "curvature"):
            raise NotImplementedError(f"presample_method {self.presample_method!r}: the port "
                                      "covers geometric_features, curvature")
        sm = sr.sample_method
        if sm.method not in ("normal", "major_axis", "random"):
            raise NotImplementedError(
                f"sample_method {sm.method!r}: the port covers normal, major_axis, random")
        if sm.method in ("normal", "major_axis") and sm.normal.sampling_strategy != "random":
            raise NotImplementedError("normal sampling: the port covers the random strategy")
        if sm.method == "major_axis" and sm.major_axis.sampling_strategy != "FPS":
            raise NotImplementedError("major_axis sampling: the port covers the FPS strategy")
        self.sample_method = sm.method
        n = sm.normal
        normal_size = n.azimuth_bins * n.elevation_bins * n.max_points_per_bin
        if sm.method == "random":
            self.sample_size = sm.random.max_points
        elif sm.method == "major_axis":
            # frame 1 falls back to `normal` binning (scan_registration.cpp:783)
            self.sample_size = max(sm.major_axis.max_total_points, normal_size)
        else:
            self.sample_size = normal_size

    def n_draws(self, first_frame: bool) -> int:
        """How many [capacity] uniform score vectors `process` takes."""
        return 2 if self.sample_method == "major_axis" and not first_frame else 1

    def process(self, raw_pts: np.ndarray, scores: Sequence[torch.Tensor],
                last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """Run the pipeline on one raw scan [N, >=3] (numpy). `scores` holds
        n_draws(first_frame) uniform [0, 1) vectors of length `capacity`:
        the order of random sampling, the within-bin order of normal
        sampling, or the weight-subsample and FPS slot orders of major-axis
        sampling."""
        cfg = self.cfg
        sr = cfg.scan_registration
        pts = np.zeros((self.capacity, 4), np.float32)
        n = min(len(raw_pts), self.capacity)
        pts[:n, :raw_pts.shape[1]] = raw_pts[:n, :4]
        rc = pre_ops.preprocess(torch.from_numpy(pts).to(self.device), n, cfg.sensor)

        nres = normals_ops.compute_normals_pca(rc, sr.compute_normal_method.pca,
                                               sr.use_all_points)
        cloud = nres.cloud
        if self.presample_method == "curvature":
            # Stage-1 curvature, kept in the model cloud (pipeline.py:169-172, 188).
            cv = sr.presample_method.curvature
            curv = features.ring_curvature(rc, cv.window_size)
            cloud = dataclasses.replace(cloud, curvature=torch.where(cloud.valid, curv, 0.0))
            cand = features.presample_curvature(cloud.curvature, cloud.valid,
                                                cv.curvature_threshold)
        else:
            cand = features.presample_geometric(
                cloud.eigvals, cloud.valid,
                sr.presample_method.geometric_features.planarity_threshold)
        if sr.use_all_points:  # plane-fail points stay in the model, not in the sample
            cand = cand & ~nres.plane_fail

        sm = sr.sample_method
        if self.sample_method == "random":
            idx, ivalid = sampling.random_sampling(cand, scores[0], sm.random.max_points)
        elif self.sample_method == "normal" or first_frame:
            nm = sm.normal
            idx, ivalid = sampling.normal_sampling(
                cloud.normal, cand, scores[0], nm.azimuth_bins, nm.elevation_bins,
                nm.min_points_per_bin, nm.max_points_per_bin, self.sample_size)
        else:
            ma = sm.major_axis
            idx, ivalid = sampling.major_axis_sampling(
                cloud.xyz, cloud.normal, cand, last_filtered.xyz, last_filtered.valid,
                scores[0], scores[1], ma.r, ma.r_proj, ma.max_total_points,
                ma.azimuth_bins, ma.elevation_bins, ma.min_points_per_bin,
                ma.max_points_per_bin, self.sample_size)

        flat = cloud.gather(idx, ivalid)
        stats = {
            "n_preprocessed": rc.valid.sum(),
            "n_filtered": cloud.valid.sum(),
            "n_candidates": cand.sum(),
            "n_sampled": flat.valid.sum(),
            "n_plane_fail": nres.plane_fail.sum(),
        }
        return FrontEndOutput(filtered=cloud, flat=flat, stats=stats)
