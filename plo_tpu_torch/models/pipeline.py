"""Front-end driver — the scan-registration pipeline, pointcloud path (the
port of plo_tpu/models/pipeline.py::FrontEnd, scan_registration.cpp:809-1560).

Stages: preprocess -> PCA normals -> geometric-features presample ->
normal sampling (first frame, and the "normal" method) or major-axis
sampling against the previous filtered cloud. Outputs the model cloud
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
        if sr.presample_method.method != "geometric_features":
            raise NotImplementedError(
                f"presample_method {sr.presample_method.method!r}: the port covers geometric_features")
        sm = sr.sample_method
        if sm.method not in ("normal", "major_axis"):
            raise NotImplementedError(f"sample_method {sm.method!r}: the port covers normal, major_axis")
        if sm.normal.sampling_strategy != "random":
            raise NotImplementedError("normal sampling: the port covers the random strategy")
        if sm.method == "major_axis" and sm.major_axis.sampling_strategy != "FPS":
            raise NotImplementedError("major_axis sampling: the port covers the FPS strategy")
        self.sample_method = sm.method
        n = sm.normal
        normal_size = n.azimuth_bins * n.elevation_bins * n.max_points_per_bin
        # frame 1 falls back to `normal` binning (scan_registration.cpp:783)
        self.sample_size = (max(sm.major_axis.max_total_points, normal_size)
                            if sm.method == "major_axis" else normal_size)

    def n_draws(self, first_frame: bool) -> int:
        """How many [capacity] uniform score vectors `process` takes."""
        return 1 if first_frame or self.sample_method == "normal" else 2

    def process(self, raw_pts: np.ndarray, scores: Sequence[torch.Tensor],
                last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """Run the pipeline on one raw scan [N, >=3] (numpy). `scores` holds
        n_draws(first_frame) uniform [0, 1) vectors of length `capacity`:
        the within-bin order of normal sampling, or the weight-subsample and
        FPS slot orders of major-axis sampling."""
        cfg = self.cfg
        sr = cfg.scan_registration
        pts = np.zeros((self.capacity, 4), np.float32)
        n = min(len(raw_pts), self.capacity)
        pts[:n, :raw_pts.shape[1]] = raw_pts[:n, :4]
        rc = pre_ops.preprocess(torch.from_numpy(pts).to(self.device), n, cfg.sensor)

        nres = normals_ops.compute_normals_pca(rc, sr.compute_normal_method.pca,
                                               sr.use_all_points)
        cloud = nres.cloud
        cand = features.presample_geometric(
            cloud.eigvals, cloud.valid,
            sr.presample_method.geometric_features.planarity_threshold)
        if sr.use_all_points:  # plane-fail points stay in the model, not in the sample
            cand = cand & ~nres.plane_fail

        sm = sr.sample_method
        if self.sample_method == "normal" or first_frame:
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
