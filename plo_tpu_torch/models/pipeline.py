"""Front-end — the scan-registration pipeline (the port of
plo_tpu/models/pipeline.py::FrontEnd, scan_registration.cpp:809-1560).

Stages: preprocess -> normals (pointcloud: PCA or cross_product on the ring
layout; range_image: the rasterized grid's PCA stencil, FALS or SRI) ->
geometric-features, curvature or tensor-voting presample -> three-axis or
random sampling, normal sampling (first frame, and the "normal" method) or
major-axis sampling against the previous filtered cloud. Outputs the model
cloud ("/laser_cloud_filtered") and the sampled cloud ("/laser_cloud_flat").
A scan comes in as points (`process`, `run`) or, for the grid16 transfer, as
the [H, W] uint16 range raster the sensor fires on (`process_grid`,
`run_grid`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from plo_tpu_torch import resolve_device
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.ops import features, normals as normals_ops, preprocess as pre_ops
from plo_tpu_torch.ops import sampling, tensor_voting

# Per-frame stats every pipeline emits, sorted: their order in the packed
# per-frame result row of Odometry.
STATS_KEYS = ("n_candidates", "n_filtered", "n_plane_fail", "n_preprocessed", "n_sampled")

# grid16 transfer quantization: uint16 3D range in 5 mm steps (0 = empty).
GRID16_SCALE = 0.005

# Vertical field of view (up, down) in degrees per beam count, for the
# range-image methods (scan_registration.cpp:921-930).
_FOV = {16: (15.0, -15.0), 32: (15.0, -25.0), 64: (2.0, -24.33)}

NORMAL_METHODS = {"pointcloud": ("pca", "cross_product"), "range_image": ("pca", "FALS", "SRI")}


def grid_to_device(grid_u16: np.ndarray, device) -> torch.Tensor:
    """uint16 rasters [..., H, W] (numpy) as int32 on the device: the 2-byte
    cells cross as int16 and are widened there (torch's uint16 has few ops)."""
    raw = torch.from_numpy(np.ascontiguousarray(grid_u16).view(np.int16)).to(device)
    return raw.to(torch.int32) & 0xFFFF


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
        self.format = cn.format
        self.normal_method = cn.method
        if cn.format not in NORMAL_METHODS:
            raise ValueError(f"invalid data format {cn.format!r}")
        if cn.method not in NORMAL_METHODS[cn.format]:
            raise ValueError(f"invalid normal method {cn.method!r}")
        self.presample_method = sr.presample_method.method
        if self.presample_method not in ("geometric_features", "curvature", "tensor_voting"):
            raise ValueError(f"invalid presample method {self.presample_method!r}")
        # Tensor voting encodes each point's tensor from PCA eigen-pairs
        # (scan_registration.cpp:342-390), which only the PCA methods give.
        if self.presample_method == "tensor_voting" and cn.method != "pca":
            raise ValueError(
                "presample_method 'tensor_voting' requires compute_normal_method "
                f"'pca' (got format={cn.format!r} method={cn.method!r}): "
                "the saliency filter encodes each point's tensor from PCA "
                "eigen-pairs; FALS/SRI/cross_product produce none.")
        sm = sr.sample_method
        self.sample_method = sm.method
        n = sm.normal
        normal_size = n.azimuth_bins * n.elevation_bins * n.max_points_per_bin
        if sm.method == "three_axis":
            self.sample_size = 9 * sm.three_axis.points_per_list
        elif sm.method == "random":
            self.sample_size = sm.random.max_points
        elif sm.method == "major_axis":
            # frame 1 falls back to `normal` binning (scan_registration.cpp:783)
            self.sample_size = max(sm.major_axis.max_total_points, normal_size)
        elif sm.method == "normal":
            self.sample_size = normal_size
        else:
            raise ValueError(f"invalid sample method {sm.method!r}")
        self.height = cfg.sensor.n_scans
        self.width = cfg.grid_width
        # Size of the model cloud: the raw capacity for pointcloud layouts,
        # H*W for the grid.
        self.filtered_capacity = (self.height * self.width if self.format == "range_image"
                                  else capacity)
        self._dirs = self._grid_dirs(self.device) if self.format == "range_image" else None
        self._cos_e = (torch.cos(self._elevation(self.device))[:, None]
                       if self.format == "range_image" else None)
        self._ri_engine = None
        if cn.method in ("FALS", "SRI"):
            fov_up, fov_down = _FOV[cfg.sensor.n_scans]
            ws = (cn.fals if cn.method == "FALS" else cn.sri).window_size
            self._ri_engine = normals_ops.RangeImageNormals(self.height, self.width, fov_up,
                                                            fov_down, ws, device=self.device)

    def n_draws(self, first_frame: bool) -> int:
        """How many [filtered_capacity] uniform score vectors a frame takes."""
        if self.sample_method == "three_axis":
            return 0
        return 2 if self.sample_method == "major_axis" and not first_frame else 1

    def process(self, raw_pts: np.ndarray, scores: Sequence[torch.Tensor],
                last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """Run the pipeline on one raw scan [N, >=3] (numpy). `scores` holds
        n_draws(first_frame) uniform [0, 1) vectors of length
        `filtered_capacity`: the order of random sampling, the within-bin
        order of normal sampling, or the weight-subsample and FPS slot
        orders of major-axis sampling."""
        pts = np.zeros((self.capacity, 4), np.float32)
        n = min(len(raw_pts), self.capacity)
        pts[:n, :raw_pts.shape[1]] = raw_pts[:n, :4]
        return self.run(torch.from_numpy(pts).to(self.device), n, scores, last_filtered,
                        first_frame)

    def process_grid(self, grid_u16: np.ndarray, scores: Sequence[torch.Tensor],
                     last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """Run the pipeline on one grid16-packed scan [H, W] uint16 (numpy)."""
        return self.run_grid(grid_to_device(grid_u16, self.device), scores, last_filtered,
                             first_frame)

    def run(self, pts: torch.Tensor, n_valid: int, scores: Sequence[torch.Tensor],
            last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """The pipeline on a padded scan [capacity, >=3] on the device whose
        first n_valid rows are returns."""
        sr = self.cfg.scan_registration
        # The grid only rasterizes, so the ring-sorted compaction runs only
        # where a consumer needs it: pointcloud normals or ring curvature.
        curvature = self.presample_method == "curvature"
        rc = pre_ops.preprocess(pts, n_valid, self.cfg.sensor,
                                sort=self.format == "pointcloud" or curvature)
        curv = features.ring_curvature(rc, sr.presample_method.curvature.window_size) \
            if curvature else None
        if self.format == "pointcloud":
            cn = sr.compute_normal_method
            if self.normal_method == "cross_product":
                nres = normals_ops.compute_normals_cross_product(rc, cn.cross_product)
            else:
                # The tensor-voting presample consumes the full eigen-pairs, which
                # the rolled kd arc perturbs: it takes the exact two-gather form
                # (plo_tpu/models/pipeline.py:178-183).
                nres = normals_ops.compute_normals_pca(
                    rc, cn.pca, sr.use_all_points,
                    exact_kd=self.presample_method == "tensor_voting")
            cloud, plane_fail, eigvecs = nres.cloud, nres.plane_fail, nres.eigvecs
            if curvature:  # stage-1 curvature, kept in the model cloud (pipeline.py:169-172)
                cloud = dataclasses.replace(cloud, curvature=torch.where(cloud.valid, curv, 0.0))
        else:
            rng_img, xyzg, relg, occ, srcg = pre_ops.rasterize_range_image(
                rc, self.height, self.width)
            cloud, plane_fail, eigvecs = self._grid_stage2(
                rng_img, xyzg, relg, occ, curv[srcg.reshape(-1)] if curvature else None)
        return self._stage3(cloud, plane_fail, eigvecs, rc.valid.sum(), scores, last_filtered,
                            first_frame)

    def run_grid(self, grid: torch.Tensor, scores: Sequence[torch.Tensor],
                 last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """The pipeline on a grid16 raster [H, W] (integer, on the device):
        xyz = r * dir(ring, col) from the beam table, so ring assignment,
        relTime recovery and the rasterization fall away; the range image
        (the reference's 2D range) is r * cos(elevation)."""
        r3d = grid.to(torch.float32) * GRID16_SCALE
        occ = grid > 0
        xyzg = r3d[..., None] * self._dirs
        rng_img = torch.where(occ, r3d * self._cos_e, torch.inf)
        relg = (torch.arange(self.width, dtype=torch.float32, device=grid.device)[None, :]
                / self.width).expand(self.height, self.width)
        cloud, plane_fail, eigvecs = self._grid_stage2(rng_img, xyzg, relg, occ, None)
        return self._stage3(cloud, plane_fail, eigvecs, occ.sum(), scores, last_filtered,
                            first_frame)

    def _elevation(self, device) -> torch.Tensor:
        """Beam elevations [H] in radians from ring_elevation_table, the ring
        model the rasterizer binned with."""
        return torch.deg2rad(torch.from_numpy(pre_ops.ring_elevation_table(self.height))
                             .to(device))

    def _grid_dirs(self, device) -> torch.Tensor:
        """Unit ray directions [H, W, 3] of the grid16 raster: elevation from
        `_elevation`, azimuth clockwise from +x per column
        (scan_registration.cpp:901)."""
        elev = self._elevation(device)
        az = -2.0 * math.pi * torch.arange(self.width, dtype=torch.float32,
                                           device=device) / self.width
        cos_e = torch.cos(elev)[:, None]
        return torch.stack([cos_e * torch.cos(az)[None, :], cos_e * torch.sin(az)[None, :],
                            torch.sin(elev)[:, None].expand(self.height, self.width)], dim=-1)

    def _grid_stage2(self, rng_img, xyzg, relg, occ, curv_flat):
        """Normals and the model cloud of the grid layout (plo_tpu's
        grid_stage2): the grid-stencil PCA, or FALS / SRI on the range image
        (whose normals stay unmasked where they fail, as plo_tpu leaves
        them; they carry no eigen-data and no plane-fail points). Returns
        (cloud, plane_fail, eigvecs [H*W, 3, 3] or None)."""
        sr = self.cfg.scan_registration
        hw = self.height * self.width
        dev = occ.device
        if self._ri_engine is not None:
            nrm, ok = (self._ri_engine.fals(rng_img) if self.normal_method == "FALS"
                       else self._ri_engine.sri(rng_img))
            ok = ok.reshape(hw)
            nrm = nrm.reshape(hw, 3)
            gev = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
            plane_fail = torch.zeros(hw, dtype=torch.bool, device=dev)
            eigvecs = None
        else:
            nrm, gev, eigvecs, keep, pfail = normals_ops.compute_normals_pca_grid(
                xyzg, occ, sr.compute_normal_method.pca, sr.use_all_points)
            ok = (keep & occ).reshape(hw)
            nrm = torch.where(ok[:, None], nrm.reshape(hw, 3), 0.0)
            gev = torch.where(ok[:, None], gev.reshape(hw, 3), 0.0)
            plane_fail = (pfail & occ).reshape(hw)
            eigvecs = eigvecs.reshape(hw, 3, 3)
        ring = torch.arange(self.height, dtype=torch.float32,
                            device=dev).repeat_interleave(self.width)
        if curv_flat is None:
            curv_flat = torch.zeros(hw, dtype=torch.float32, device=dev)
        cloud = PointCloud(xyz=xyzg.reshape(hw, 3), normal=nrm,
                           intensity=ring + 0.1 * relg.reshape(hw),
                           curvature=torch.where(ok, curv_flat, 0.0), eigvals=gev, valid=ok)
        return cloud, plane_fail, eigvecs

    def _stage3(self, cloud: PointCloud, plane_fail, eigvecs, n_preprocessed, scores,
                last_filtered: Optional[PointCloud], first_frame: bool) -> FrontEndOutput:
        """Presample candidates, then sample."""
        sr = self.cfg.scan_registration
        if self.presample_method == "curvature":
            cand = features.presample_curvature(cloud.curvature, cloud.valid,
                                                sr.presample_method.curvature.curvature_threshold)
        elif self.presample_method == "tensor_voting":
            # The voted cloud replaces the model cloud (pipeline.py:218-223).
            tv = tensor_voting.saliency_presample(cloud, eigvecs,
                                                  sr.presample_method.tensor_voting)
            cloud, cand = tv.cloud, tv.candidates
        else:
            cand = features.presample_geometric(
                cloud.eigvals, cloud.valid,
                sr.presample_method.geometric_features.planarity_threshold)
        if sr.use_all_points:  # plane-fail points stay in the model, not in the sample
            cand = cand & ~plane_fail

        sm = sr.sample_method
        if self.sample_method == "three_axis":
            idx, ivalid = sampling.three_axis_sampling(
                cloud.xyz, cloud.normal, cloud.eigvals, cand, sm.three_axis.points_per_list)
        elif self.sample_method == "random":
            idx, ivalid = sampling.random_sampling(cand, scores[0], sm.random.max_points)
        elif self.sample_method == "normal" or first_frame:
            nm = sm.normal
            idx, ivalid = sampling.normal_sampling(
                cloud.normal, cand, scores[0], nm.azimuth_bins, nm.elevation_bins,
                nm.min_points_per_bin, nm.max_points_per_bin, self.sample_size,
                strategy=nm.sampling_strategy, xyz=cloud.xyz)
        else:
            ma = sm.major_axis
            idx, ivalid = sampling.major_axis_sampling(
                cloud.xyz, cloud.normal, cand, last_filtered.xyz, last_filtered.valid,
                scores[0], scores[1], ma.r, ma.r_proj, ma.max_total_points,
                ma.azimuth_bins, ma.elevation_bins, ma.min_points_per_bin,
                ma.max_points_per_bin, self.sample_size, strategy=ma.sampling_strategy)

        flat = cloud.gather(idx, ivalid)
        stats = {
            "n_preprocessed": n_preprocessed,
            "n_filtered": cloud.valid.sum(),
            "n_candidates": cand.sum(),
            "n_sampled": flat.valid.sum(),
            "n_plane_fail": plane_fail.sum(),
        }
        return FrontEndOutput(filtered=cloud, flat=flat, stats=stats)
