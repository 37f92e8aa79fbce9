"""Typed configuration mirroring the reference's `config.json` tree.

A copy of the JAX package's `plo_tpu/config.py`: the same key tree, the same
dataclass defaults and the same `load()`, so a reference config loads into
both packages unchanged (`_comment` keys are ignored). The port keeps its own
copy because it must not import the JAX package, whose `__init__` imports
JAX. tests/test_torch_config.py holds the two copies equal field for field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


def _get(d: Dict[str, Any], key: str, default):
    v = d.get(key, default)
    return v


@dataclasses.dataclass(frozen=True)
class PlaneConstraint:  # config.json:13-16
    distance_threshold: float = 0.02
    valid_points_threshold: float = 0.8


@dataclasses.dataclass(frozen=True)
class PCAConfig:  # config.json:7-17
    window_size: int = 3
    iter_step: int = 1
    knn_distance_threshold: float = 10.0
    neighbor_scan: str = "kdtree"  # "kdtree" | "index"
    plane_constraint: PlaneConstraint = PlaneConstraint()


@dataclasses.dataclass(frozen=True)
class CrossProductConfig:  # config.json:18-22
    knn_distance_threshold: float = 1.0
    neighbor_scan: str = "index"


@dataclasses.dataclass(frozen=True)
class RangeImageNormalConfig:  # config.json:23-28 (FALS / SRI)
    window_size: int = 3


@dataclasses.dataclass(frozen=True)
class ComputeNormalConfig:  # config.json:3-29
    format: str = "pointcloud"  # "pointcloud" | "range_image"
    method: str = "pca"         # "pca" | "cross_product" | "FALS" | "SRI"
    pca: PCAConfig = PCAConfig()
    cross_product: CrossProductConfig = CrossProductConfig()
    fals: RangeImageNormalConfig = RangeImageNormalConfig()
    sri: RangeImageNormalConfig = RangeImageNormalConfig()


@dataclasses.dataclass(frozen=True)
class TensorVotingConfig:  # config.json:33-37
    k: int = 50
    sigma: float = 0.2


@dataclasses.dataclass(frozen=True)
class GeometricFeaturesConfig:  # config.json:38-41
    planarity_threshold: float = 0.05


@dataclasses.dataclass(frozen=True)
class CurvaturePresampleConfig:  # config.json:42-46
    curvature_threshold: float = 0.02
    window_size: int = 5


@dataclasses.dataclass(frozen=True)
class PresampleConfig:  # config.json:30-47
    method: str = "geometric_features"  # "tensor_voting" | "geometric_features" | "curvature"
    tensor_voting: TensorVotingConfig = TensorVotingConfig()
    geometric_features: GeometricFeaturesConfig = GeometricFeaturesConfig()
    curvature: CurvaturePresampleConfig = CurvaturePresampleConfig()


@dataclasses.dataclass(frozen=True)
class ThreeAxisConfig:  # config.json:51-53
    points_per_list: int = 200


@dataclasses.dataclass(frozen=True)
class RandomSampleConfig:  # config.json:54-56
    max_points: int = 2000


@dataclasses.dataclass(frozen=True)
class NormalSampleConfig:  # config.json:57-64
    azimuth_bins: int = 8
    elevation_bins: int = 8
    min_points_per_bin: int = 20
    max_points_per_bin: int = 100
    sampling_strategy: str = "random"  # "FPS" | "random"


@dataclasses.dataclass(frozen=True)
class MajorAxisConfig:  # config.json:65-75
    r: float = 0.5
    r_proj: float = 1.5
    max_total_points: int = 2000
    azimuth_bins: int = 8
    elevation_bins: int = 8
    min_points_per_bin: int = 20
    max_points_per_bin: int = 200
    sampling_strategy: str = "FPS"


@dataclasses.dataclass(frozen=True)
class SampleConfig:  # config.json:48-76
    method: str = "major_axis"  # "three_axis" | "random" | "normal" | "major_axis"
    three_axis: ThreeAxisConfig = ThreeAxisConfig()
    random: RandomSampleConfig = RandomSampleConfig()
    normal: NormalSampleConfig = NormalSampleConfig()
    major_axis: MajorAxisConfig = MajorAxisConfig()


@dataclasses.dataclass(frozen=True)
class ScanRegistrationConfig:  # config.json:2-82
    compute_normal_method: ComputeNormalConfig = ComputeNormalConfig()
    presample_method: PresampleConfig = PresampleConfig()
    sample_method: SampleConfig = SampleConfig()
    use_all_points: bool = True  # config.json:77-80 ("model")


@dataclasses.dataclass(frozen=True)
class IMLSTensorVotingConfig:  # config.json:93-99
    enabled: bool = False
    k: int = 50
    sigma: float = 0.2
    distance_threshold: float = 0.6


@dataclasses.dataclass(frozen=True)
class GetNormalsConfig:  # config.json:100-105
    enabled: bool = True
    r_normal: float = 1.0
    search_number_normal: int = 10


@dataclasses.dataclass(frozen=True)
class ProjectedDistanceConfig:  # config.json:106-109
    enabled: bool = False
    r_proj: float = 0.8


@dataclasses.dataclass(frozen=True)
class NormalAngleConstraintConfig:  # config.json:110-113
    enabled: bool = True
    angle_diff_threshold: float = 30.0  # degrees


@dataclasses.dataclass(frozen=True)
class IMLSConfig:  # config.json:90-118
    h: float = 1.0
    r: float = 3.0
    use_tensor_voting: IMLSTensorVotingConfig = IMLSTensorVotingConfig()
    get_normals: GetNormalsConfig = GetNormalsConfig()
    use_projected_distance: ProjectedDistanceConfig = ProjectedDistanceConfig()
    normal_angle_constraint: NormalAngleConstraintConfig = NormalAngleConstraintConfig()
    search_number: int = 20  # config.json:114-117 ("IMLS function")


@dataclasses.dataclass(frozen=True)
class PlaneICPConfig:  # config.json:119-129
    r: float = 1.5
    use_projected_distance: ProjectedDistanceConfig = ProjectedDistanceConfig()
    normal_angle_constraint: NormalAngleConstraintConfig = NormalAngleConstraintConfig()


@dataclasses.dataclass(frozen=True)
class MatchingConfig:  # config.json:86-130
    method: str = "IMLS"  # "IMLS" | "plane_ICP"
    correspond_number: int = 6
    imls: IMLSConfig = IMLSConfig()
    plane_icp: PlaneICPConfig = PlaneICPConfig()


@dataclasses.dataclass(frozen=True)
class CeresConfig:  # config.json:137-139
    max_iterations: int = 20


@dataclasses.dataclass(frozen=True)
class LSConfig:  # config.json:140-142
    threshold: float = 0.02


@dataclasses.dataclass(frozen=True)
class RANSACConfig:  # config.json:143-154
    max_iterations: int = 5000
    distance_threshold: float = 0.8
    min_inliers_percentage: float = 0.95
    huber_threshold: float = 0.648
    final_solve_method: str = "DRPM"  # "LS" | "Weighted LS" | "DRPM"
    ls_threshold: float = 0.02
    drpm_threshold: float = 0.05
    drpm_stdev_points: float = 0.02
    drpm_stdev_normals: float = 0.05


@dataclasses.dataclass(frozen=True)
class ICPSolverConfig:  # config.json:155-159
    max_iterations: int = 1000
    # NOTE: the reference declares these `const int` (solver.h:121-122), so the
    # JSON's 1e-8 truncates to 0; we keep floats but default to the effective 0.
    t_epsilon: float = 0.0
    e_epsilon: float = 0.0


@dataclasses.dataclass(frozen=True)
class TeaserConfig:  # config.json:160-169
    noise_bound: float = 0.01
    estimate_scaling: bool = False
    rotation_max_iterations: int = 1000
    rotation_gnc_factor: float = 1.4
    rotation_estimation_algorithm: str = "GNC_TLS"
    rotation_cost_threshold: float = 0.005
    use_max_clique: bool = True
    kcore_heuristic_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class SolveConfig:  # config.json:131-170
    method: str = "RANSAC"  # "Ceres" | "LS" | "RANSAC" | "ICP" | "Teaser"
    iterations: int = 30
    delta_dist_threshold: float = 0.001
    delta_angle_threshold: float = 0.0001745353
    ceres: CeresConfig = CeresConfig()
    ls: LSConfig = LSConfig()
    ransac: RANSACConfig = RANSACConfig()
    icp: ICPSolverConfig = ICPSolverConfig()
    teaser: TeaserConfig = TeaserConfig()


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Extension: persistent voxel-map target (frame-to-map odometry).

    Generalizes accumulateTargetCloud (laser_odometry.cpp:116-136): the model
    is a fixed-capacity world-frame voxel map (one stable point per occupied
    voxel, farthest-from-sensor eviction — ops/voxel.py::voxel_map_insert)
    instead of a rolling window of whole frames."""
    voxel_size: float = 0.3
    capacity: int = 65536
    n_buckets: int = 1 << 19
    # Correspondence search against the map: "dense" = the exact chunked
    # engine (ops/neighbors.py); "grid_hash" = the sub-linear 27-cell bucket
    # gather (ops/grid_hash.py; freeze-mode euclidean IMLS only). On TPU the
    # fused dense scan WINS below ~512k map points (0.46 ms at 57.6k targets
    # vs gather-bound bucket lookups — measured 76 vs 15.5 scans/s e2e at a
    # 65k map); grid_hash is the asymptotic tool for city-scale maps.
    search: str = "dense"
    grid_cell: float = 1.5     # grid-hash cell edge; exact within min(r, cell)
    grid_m: int = 128          # grid-hash per-cell candidate cap
    grid_buckets: int = 1 << 17


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Extension: sliding-window bundle adjustment over the pose chain
    (parallel/ba.py). Each frame records point-to-plane correspondences to
    the previous frame (the ICP's own matched set) AND to the skip frame
    (k-2 -> k, the term that makes the joint window informative — a chain of
    consecutive pairs alone reproduces the per-frame ICP optima); the last
    `window` poses are then jointly refined by Gauss-Newton."""
    enabled: bool = False
    window: int = 4
    iterations: int = 4
    max_correspondences: int = 512
    damping: float = 1e-6
    # Huber IRLS scale (m) on the point-to-plane residuals: the frozen
    # correspondence assignments include wrong-surface outliers that
    # unweighted GN absorbs wholesale.
    huber_delta: float = 0.05


@dataclasses.dataclass(frozen=True)
class LaserOdometryConfig:  # config.json:83-171
    max_queue_size: int = 1
    # Extension: target model selection. "window" = the reference's rolling
    # max_queue_size window of filtered frames (parity mode); "map" = the
    # persistent world-frame voxel map (MapConfig). ICP runs in the previous
    # frame's coords for "window" and in world coords for "map".
    target_mode: str = "window"
    map: MapConfig = MapConfig()
    transform_normal: bool = False
    # Extension: per-point constant-velocity motion compensation (the
    # reference ships this capability disabled — DISTORTION 0,
    # laser_odometry.cpp:29; off by default for parity).
    undistort: bool = False
    # Extension: initialize each frame's ICP at the previous relative pose
    # (constant-velocity prior — the intent of the reference's commented-out
    # TransformToStart call, laser_odometry.cpp:459). ON by default: measured
    # 8.8 mm vs 989 mm ATE over a 26 m curved synthetic run (the reference's
    # shipped rPose=Identity init, :484-485, re-anchors every frame through
    # the h-gate and intermittently freezes at speed); set False for strict
    # shipped-behavior parity.
    motion_prior: bool = True
    # Extension: True (reference semantics, laser_odometry.cpp:524-647) re-runs
    # the full anchor+kNN target search every ICP iteration; False freezes the
    # candidate set after each frame's first search and re-evaluates gates,
    # anchor, bandwidth and heights from the updated source pose only
    # (ops/matching.py::imls_project_cached) — ~2x faster ICP at equal ATE
    # when a motion prior puts iteration 0 within centimeters of the optimum.
    # Euclidean-anchor IMLS only; other modes ignore the flag.
    refresh_correspondences: bool = True
    # Extension (hybrid refresh, euclidean IMLS with
    # refresh_correspondences=True only): re-run the full target search ONLY
    # when the accumulated per-point motion since the last search exceeds
    # this bound (meters); between searches the frozen candidate set is
    # re-gated/re-sorted at the updated pose (imls_project_cached — exact at
    # the search pose). The identity-init reference regime re-searches its
    # first few >2 cm iterations and reuses across the ~25 sub-mm tail
    # iterations. 0.0 = re-search every iteration (strict
    # laser_odometry.cpp:524-647 parity); trajectory parity at the default
    # is pinned by tests/test_odometry.py::
    # test_hybrid_refresh_matches_full_research.
    refresh_motion_threshold: float = 0.02
    ba: BAConfig = BAConfig()
    matching_method: MatchingConfig = MatchingConfig()
    solve_method: SolveConfig = SolveConfig()


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Sensor geometry (the reference takes these as ROS launch params,
    planetary_slam_VLP_32.launch:3-13)."""
    n_scans: int = 64
    azimuth_resolution: float = 0.2  # degrees -> grid width = 360/res
    minimum_range: float = 2.0
    maximum_range: float = 150.0
    scan_period: float = 0.1  # scan_registration.cpp:55


@dataclasses.dataclass(frozen=True)
class SaverConfig:  # config.json:173-176
    output_dir: str = ""
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    scan_registration: ScanRegistrationConfig = ScanRegistrationConfig()
    laser_odometry: LaserOdometryConfig = LaserOdometryConfig()
    sensor: SensorConfig = SensorConfig()
    saver: SaverConfig = SaverConfig()

    @property
    def grid_width(self) -> int:
        return int(360.0 / self.sensor.azimuth_resolution)


def _plane_constraint(d):
    return PlaneConstraint(
        distance_threshold=float(_get(d, "distance_threshold", 0.02)),
        valid_points_threshold=float(_get(d, "valid_points_threshold", 0.8)),
    )


def from_dict(tree: Dict[str, Any], sensor: Optional[SensorConfig] = None) -> Config:
    """Parse a reference-format config tree (the full config.json object)."""
    sr = tree.get("scan_registration", {})
    cn = sr.get("compute_normal_method", {})
    ps = sr.get("presample_method", {})
    sm = sr.get("sample_method", {})
    lo = tree.get("laser_odometry", {})
    mm = lo.get("matching_method", {})
    sv = lo.get("solve_method", {})
    imls = mm.get("IMLS", {})
    picp = mm.get("plane_ICP", {})

    def proj(d):
        return ProjectedDistanceConfig(
            enabled=bool(_get(d, "enabled", False)), r_proj=float(_get(d, "r_proj", 0.8))
        )

    def angle(d):
        return NormalAngleConstraintConfig(
            enabled=bool(_get(d, "enabled", True)),
            angle_diff_threshold=float(_get(d, "angle_diff_threshold", 30.0)),
        )

    cfg = Config(
        scan_registration=ScanRegistrationConfig(
            compute_normal_method=ComputeNormalConfig(
                format=str(_get(cn, "format", "pointcloud")),
                method=str(_get(cn, "method", "pca")),
                pca=PCAConfig(
                    window_size=int(_get(cn.get("pca", {}), "window_size", 3)),
                    iter_step=int(_get(cn.get("pca", {}), "iter_step", 1)),
                    knn_distance_threshold=float(_get(cn.get("pca", {}), "knn_distance_threshold", 10.0)),
                    neighbor_scan=str(_get(cn.get("pca", {}), "neighbor_scan", "kdtree")),
                    plane_constraint=_plane_constraint(cn.get("pca", {}).get("plane_constraint", {})),
                ),
                cross_product=CrossProductConfig(
                    knn_distance_threshold=float(_get(cn.get("cross_product", {}), "knn_distance_threshold", 1.0)),
                    neighbor_scan=str(_get(cn.get("cross_product", {}), "neighbor_scan", "index")),
                ),
                fals=RangeImageNormalConfig(window_size=int(_get(cn.get("FALS", {}), "window_size", 3))),
                sri=RangeImageNormalConfig(window_size=int(_get(cn.get("SRI", {}), "window_size", 3))),
            ),
            presample_method=PresampleConfig(
                method=str(_get(ps, "method", "geometric_features")),
                tensor_voting=TensorVotingConfig(
                    k=int(_get(ps.get("tensor_voting", {}), "k", 50)),
                    sigma=float(_get(ps.get("tensor_voting", {}), "sigma", 0.2)),
                ),
                geometric_features=GeometricFeaturesConfig(
                    planarity_threshold=float(_get(ps.get("geometric_features", {}), "planarity_threshold", 0.05)),
                ),
                curvature=CurvaturePresampleConfig(
                    curvature_threshold=float(_get(ps.get("curvature", {}), "curvature_threshold", 0.02)),
                    window_size=int(_get(ps.get("curvature", {}), "window_size", 5)),
                ),
            ),
            sample_method=SampleConfig(
                method=str(_get(sm, "method", "major_axis")),
                three_axis=ThreeAxisConfig(points_per_list=int(_get(sm.get("three_axis", {}), "points_per_list", 200))),
                random=RandomSampleConfig(max_points=int(_get(sm.get("random", {}), "max_points", 2000))),
                normal=NormalSampleConfig(
                    azimuth_bins=int(_get(sm.get("normal", {}), "azimuth_bins", 8)),
                    elevation_bins=int(_get(sm.get("normal", {}), "elevation_bins", 8)),
                    min_points_per_bin=int(_get(sm.get("normal", {}), "min_points_per_bin", 20)),
                    max_points_per_bin=int(_get(sm.get("normal", {}), "max_points_per_bin", 100)),
                    sampling_strategy=str(_get(sm.get("normal", {}), "sampling_strategy", "random")),
                ),
                major_axis=MajorAxisConfig(
                    r=float(_get(sm.get("major_axis", {}), "r", 0.5)),
                    r_proj=float(_get(sm.get("major_axis", {}), "r_proj", 1.5)),
                    max_total_points=int(_get(sm.get("major_axis", {}), "max_total_points", 2000)),
                    azimuth_bins=int(_get(sm.get("major_axis", {}), "azimuth_bins", 8)),
                    elevation_bins=int(_get(sm.get("major_axis", {}), "elevation_bins", 8)),
                    min_points_per_bin=int(_get(sm.get("major_axis", {}), "min_points_per_bin", 20)),
                    max_points_per_bin=int(_get(sm.get("major_axis", {}), "max_points_per_bin", 200)),
                    sampling_strategy=str(_get(sm.get("major_axis", {}), "sampling_strategy", "FPS")),
                ),
            ),
            use_all_points=bool(_get(sr.get("model", {}), "use_all_points", True)),
        ),
        laser_odometry=LaserOdometryConfig(
            max_queue_size=int(_get(lo, "max_queue_size", 1)),
            target_mode=str(_get(lo, "target_mode", "window")),
            map=MapConfig(
                voxel_size=float(_get(lo.get("map", {}), "voxel_size", 0.3)),
                capacity=int(_get(lo.get("map", {}), "capacity", 65536)),
                search=str(_get(lo.get("map", {}), "search", "dense")),
                grid_cell=float(_get(lo.get("map", {}), "grid_cell", 1.5)),
                grid_m=int(_get(lo.get("map", {}), "grid_m", 128)),
            ),
            transform_normal=bool(_get(lo, "transform_normal", False)),
            # Reference-format loads default to reference semantics: the
            # shipped laser_odometry node initializes every frame's ICP at
            # identity (rPose reset, laser_odometry.cpp:484-485) and runs no
            # sweep compensation (DISTORTION 0, :29). The extensions are
            # explicit opt-ins via these (non-reference) keys; the Python
            # `Config()` constructor keeps motion_prior=True as the
            # framework's own recommended default.
            motion_prior=bool(_get(lo, "motion_prior", False)),
            undistort=bool(_get(lo, "undistort", False)),
            refresh_correspondences=bool(_get(lo, "refresh_correspondences", True)),
            ba=BAConfig(
                enabled=bool(_get(lo.get("ba", {}), "enabled", False)),
                window=int(_get(lo.get("ba", {}), "window", 4)),
                iterations=int(_get(lo.get("ba", {}), "iterations", 4)),
                max_correspondences=int(_get(lo.get("ba", {}), "max_correspondences", 512)),
            ),
            matching_method=MatchingConfig(
                method=str(_get(mm, "method", "IMLS")),
                correspond_number=int(_get(mm, "correspond_number", 6)),
                imls=IMLSConfig(
                    h=float(_get(imls, "h", 1.0)),
                    r=float(_get(imls, "r", 3.0)),
                    use_tensor_voting=IMLSTensorVotingConfig(
                        enabled=bool(_get(imls.get("use_tensor_voting", {}), "enabled", False)),
                        k=int(_get(imls.get("use_tensor_voting", {}), "k", 50)),
                        sigma=float(_get(imls.get("use_tensor_voting", {}), "sigma", 0.2)),
                        distance_threshold=float(_get(imls.get("use_tensor_voting", {}), "distance_threshold", 0.6)),
                    ),
                    get_normals=GetNormalsConfig(
                        enabled=bool(_get(imls.get("get_normals", {}), "enabled", True)),
                        r_normal=float(_get(imls.get("get_normals", {}), "r_normal", 1.0)),
                        search_number_normal=int(_get(imls.get("get_normals", {}), "search_number_normal", 10)),
                    ),
                    use_projected_distance=proj(imls.get("use_projected_distance", {})),
                    normal_angle_constraint=angle(imls.get("normal_angle_constraint", {})),
                    search_number=int(_get(imls.get("IMLS function", {}), "search_number", 20)),
                ),
                plane_icp=PlaneICPConfig(
                    r=float(_get(picp, "r", 1.5)),
                    use_projected_distance=proj(picp.get("use_projected_distance", {})),
                    normal_angle_constraint=angle(picp.get("normal_angle_constraint", {})),
                ),
            ),
            solve_method=SolveConfig(
                method=str(_get(sv, "method", "RANSAC")),
                iterations=int(_get(sv, "iterations", 30)),
                delta_dist_threshold=float(_get(sv, "delta_dist_threshold", 0.001)),
                delta_angle_threshold=float(_get(sv, "delta_angle_threshold", 0.0001745353)),
                ceres=CeresConfig(max_iterations=int(_get(sv.get("Ceres", {}), "max_iterations", 20))),
                ls=LSConfig(threshold=float(_get(sv.get("LS", {}), "threshold", 0.02))),
                ransac=RANSACConfig(
                    max_iterations=int(_get(sv.get("RANSAC", {}), "max_iterations", 5000)),
                    distance_threshold=float(_get(sv.get("RANSAC", {}), "distance_threshold", 0.8)),
                    min_inliers_percentage=float(_get(sv.get("RANSAC", {}), "min_inliers_percentage", 0.95)),
                    huber_threshold=float(_get(sv.get("RANSAC", {}), "huber_threshold", 0.648)),
                    final_solve_method=str(_get(sv.get("RANSAC", {}), "final_solve_method", "DRPM")),
                    ls_threshold=float(_get(sv.get("RANSAC", {}), "LS_threshold", 0.02)),
                    drpm_threshold=float(_get(sv.get("RANSAC", {}), "DRPM_threshold", 0.05)),
                    drpm_stdev_points=float(_get(sv.get("RANSAC", {}), "DRPM_stdev_points", 0.02)),
                    drpm_stdev_normals=float(_get(sv.get("RANSAC", {}), "DRPM_stdev_normals", 0.05)),
                ),
                icp=ICPSolverConfig(
                    max_iterations=int(_get(sv.get("ICP", {}), "max_iterations", 1000)),
                    t_epsilon=float(int(_get(sv.get("ICP", {}), "t_epsilon", 0))),
                    e_epsilon=float(int(_get(sv.get("ICP", {}), "e_epsilon", 0))),
                ),
                teaser=TeaserConfig(
                    noise_bound=float(_get(sv.get("Teaser", {}), "noise_bound", 0.01)),
                    estimate_scaling=bool(_get(sv.get("Teaser", {}), "estimate_scaling", False)),
                    rotation_max_iterations=int(_get(sv.get("Teaser", {}), "rotation_max_iterations", 1000)),
                    rotation_gnc_factor=float(_get(sv.get("Teaser", {}), "rotation_gnc_factor", 1.4)),
                    rotation_estimation_algorithm=str(_get(sv.get("Teaser", {}), "rotation_estimation_algorithm", "GNC_TLS")),
                    rotation_cost_threshold=float(_get(sv.get("Teaser", {}), "rotation_cost_threshold", 0.005)),
                    use_max_clique=bool(_get(sv.get("Teaser", {}), "use_max_clique", True)),
                    kcore_heuristic_threshold=float(_get(sv.get("Teaser", {}), "kcore_heuristic_threshold", 0.5)),
                ),
            ),
        ),
        sensor=sensor or SensorConfig(),
        saver=SaverConfig(
            output_dir=str(_get(tree.get("saver", {}), "output_dir", "")),
            enabled=bool(_get(tree.get("saver", {}), "enabled", False)),
        ),
    )
    return cfg


def load(path: str, sensor: Optional[SensorConfig] = None) -> Config:
    """Load a reference-format config.json (common.cpp:8-17)."""
    with open(path, "r") as f:
        tree = json.load(f)
    return from_dict(tree, sensor=sensor)
