"""Map mode (target_mode="map": a persistent world-frame voxel map, searched
dense or through the grid hash, and the world-pose chain) against plo_tpu's,
per frame and batched, resumed from plo_tpu's state, and its pieces: the pose
algebra, the sync-free projection onto SO(3), undistort_cloud, the guards.

Sizes: 5 synthetic 32-beam x 450 scans of the corridor world (capacity
16384, a 32,768-point map at 0.3 m); the headline front-end (range_image
PCA, geometric presample) with random sampling of 1,200, frozen IMLS and
the LS solver (bench --map's RANSAC + DRPM finds many solves degenerate at
32 x 450, tests/test_torch_headline.py; chip_smoke phase 9 runs it at
HDL-64 x 900). Tolerances: poses within 2 mm / 1e-4 rad of plo_tpu's (the
bound of tests/test_torch_odometry.py's resume test); the world rotation's
determinant within 1e-5 of 1; geometry within 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu import geometry as jax_geo
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.ops.undistort import undistort_cloud as jax_undistort
from plo_tpu_torch import bench, config as port_cfg, geometry as geo
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.convert import config_from_dict, odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models import odometry as port_odometry
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import grid_hash, voxel
from plo_tpu_torch.ops.undistort import undistort_cloud

from test_torch_odometry import JaxBatchDraws, JaxDraws, cloud_arrays

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, RESUME_AFTER, BATCH = 32, 450, 16384, 5, 2, 2


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for this module (see tests/test_torch_headline.py),
    then one parallel sqrt on every thread (tests/test_torch_odometry.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def map_config(m, search="dense"):
    return m.Config(
        scan_registration=m.ScanRegistrationConfig(
            compute_normal_method=m.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=m.PresampleConfig(method="geometric_features"),
            sample_method=m.SampleConfig(method="random",
                                         random=m.RandomSampleConfig(max_points=1200))),
        laser_odometry=m.LaserOdometryConfig(
            target_mode="map", map=m.MapConfig(voxel_size=0.3, capacity=32768, search=search),
            refresh_correspondences=False, matching_method=m.MatchingConfig(method="IMLS"),
            solve_method=m.SolveConfig(method="LS", iterations=20)),
        sensor=m.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


def rotations(rng, n):
    w = rng.normal(size=(n, 3)) * np.array([[0.3]] * (n - 3) + [[1e-7], [0.0], [3.0]])
    return np.stack([np.asarray(jax_geo.exp_so3(jnp.asarray(x, jnp.float32))) for x in w])


def test_pose_algebra_matches_jax(rng):
    """log_so3, interpolate_pose and se3_inverse within 1e-6 of plo_tpu's
    (near-zero, zero and large angles among the rotations)."""
    for R in rotations(rng, 12):
        T = np.asarray(jax_geo.make_se3(jnp.asarray(R), jnp.asarray(rng.normal(size=3),
                                                                    jnp.float32)))
        np.testing.assert_allclose(geo.log_so3(t(R)).numpy(),
                                   np.asarray(jax_geo.log_so3(jnp.asarray(R))), atol=1e-6)
        alpha = rng.random(64).astype(np.float32)
        np.testing.assert_allclose(geo.interpolate_pose(t(T), t(alpha)).numpy(), np.asarray(
            jax_geo.interpolate_pose(jnp.asarray(T), jnp.asarray(alpha))), atol=1e-6)
        np.testing.assert_allclose(geo.se3_inverse(t(T)).numpy(),
                                   np.asarray(jax_geo.se3_inverse(jnp.asarray(T))), atol=1e-6)


@pytest.mark.parametrize("defect", [0.0, 1e-7, 1e-5, 1e-3, 1e-2])
def test_project_so3_matches_jax_svd(rng, defect):
    """The sync-free projection equals plo_tpu's SVD orthonormalize within
    1e-6 (its f32 SVD errs by ~2e-7) on rotations perturbed by `defect`."""
    for R in rotations(rng, 8):
        M = (R + defect * rng.normal(size=(3, 3))).astype(np.float32)
        ref = np.asarray(jax_geo.orthonormalize(jnp.asarray(M)))
        out = geo.project_so3(t(M)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        P = out.astype(np.float64)
        np.testing.assert_allclose(P.T @ P, np.eye(3), atol=1e-6)


def test_the_world_chain_stays_orthonormal(rng):
    """The chain world -> rel = world^-1 @ wpose -> next init, composed 60
    times with f32 solver-sized errors: with the per-frame projection det(R)
    stays within 1e-6 of 1; without it the transpose inverse lets the
    defect grow (plo_tpu's reason for the projection)."""
    eye = torch.eye(4)
    fixed, raw = eye.clone(), eye.clone()
    rel_f, rel_r = eye.clone(), eye.clone()
    for R in rotations(rng, 60):
        step = geo.make_se3(t(R) + 3e-5 * torch.from_numpy(rng.normal(size=(3, 3))).float(),
                            torch.from_numpy(rng.normal(size=3)).float())
        w = port_odometry._fix_pose(fixed @ rel_f @ step)
        rel_f = port_odometry._fix_pose(geo.se3_inverse(fixed) @ w)
        fixed = w
        w = raw @ rel_r @ step
        rel_r = geo.se3_inverse(raw) @ w
        raw = w
    assert abs(float(torch.linalg.det(fixed[:3, :3].double())) - 1) < 1e-6
    assert not abs(float(torch.linalg.det(raw[:3, :3].double())) - 1) < 1e-3   # or NaN


def test_the_map_step_makes_no_host_sync(monkeypatch, rng):
    """The map's device work (projection, rigid inverse, undistortion, voxel
    insert, grid-hash build and search) reads nothing back to the host and
    takes no SVD, so a batched map step keeps its one fetch a drain."""
    def refuse(*a, **k):
        raise AssertionError("host sync in the map step")
    cloud = PointCloud(xyz=t(rng.normal(size=(3000, 3)).astype(np.float32) * 8),
                       normal=t(rng.normal(size=(3000, 3)).astype(np.float32)),
                       intensity=t((rng.integers(0, 32, 3000) + 0.1 * rng.random(3000))
                                   .astype(np.float32)),
                       curvature=torch.zeros(3000), eigvals=torch.zeros(3000, 3),
                       valid=torch.ones(3000, dtype=torch.bool))
    T = geo.make_se3(t(rotations(rng, 4)[0]), torch.tensor([0.5, 0.1, 0.0]))
    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.linalg, "svd", refuse)
    w = port_odometry._fix_pose(T @ T)
    port_odometry._fix_pose(geo.se3_inverse(T) @ w)
    moved = undistort_cloud(cloud, T)
    m = voxel.voxel_map_insert(port_odometry._zeros_cloud(4096, "cpu"), moved, 0.3, w[:3, 3])
    grid_hash.knn(grid_hash.build(m.xyz, m.valid, 1.5, 1 << 12), cloud.xyz[:500], 20, 3.0, m=64)


def test_undistort_cloud_matches_jax(rng):
    """undistort_cloud within 1e-5 m of plo_tpu's (points up to ~60 m: a few
    f32 ulps of the per-point 3x3 product) and undoing a sweep's distortion
    to 1e-3 m, as tests/test_odometry.py checks plo_tpu's."""
    xyz = (rng.normal(size=(5000, 3)) * 20).astype(np.float32)
    rel_time = rng.random(5000).astype(np.float32)
    inten = (rng.integers(0, 64, 5000) + 0.1 * rel_time).astype(np.float32)
    valid = rng.random(5000) > 0.1
    rel = np.asarray(jax_geo.make_se3(jax_geo.exp_so3(jnp.asarray([0.01, -0.02, 0.05],
                                                                  jnp.float32)),
                                      jnp.asarray([0.5, 0.1, -0.02], jnp.float32)))
    jc = JaxCloud.from_xyz(jnp.asarray(xyz), jnp.asarray(valid))
    jc = dataclasses.replace(jc, intensity=jnp.asarray(inten))
    ref = np.asarray(jax_undistort(jc, jnp.asarray(rel)).xyz)
    pc = PointCloud(**{k: t(v) for k, v in cloud_arrays(jc).items()})
    out = undistort_cloud(pc, t(rel)).xyz.numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out[~valid], xyz[~valid])
    T = np.asarray(jax_geo.interpolate_pose(jnp.asarray(rel),
                                            jnp.asarray((inten - np.floor(inten)) / 0.1)))
    Ti = np.linalg.inv(T.astype(np.float64))
    distorted = (np.einsum("pij,pj->pi", Ti[:, :3, :3], xyz) + Ti[:, :3, 3]).astype(np.float32)
    pc = dataclasses.replace(pc, xyz=t(distorted))
    restored = undistort_cloud(pc, t(rel)).xyz.numpy()
    np.testing.assert_allclose(restored[valid], xyz[valid], atol=1e-3)


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


@pytest.fixture(scope="module")
def jax_runs(scans):
    """plo_tpu's map-mode runs: frame by frame (dense, with its state after
    frame RESUME_AFTER; and grid_hash) and batched (dense, batch 2)."""
    scans, _ = scans
    runs = {}
    for search in ("dense", "grid_hash"):
        odo = JaxOdometry(map_config(jax_cfg, search), capacity=CAPACITY, seed=0,
                          transfer="float32")
        state = None
        for i, s in enumerate(scans):
            odo.process_scan(s)
            if i == RESUME_AFTER and search == "dense":
                state = dict(
                    last_filtered=cloud_arrays(odo.last_filtered),
                    frame_count=odo.frame_count, last_rel=np.array(odo._last_rel),
                    trajectory=[dataclasses.asdict(f) for f in odo.trajectory],
                    device_map=cloud_arrays(odo._device_map), world=np.array(odo._world_dev))
        runs[search] = odo.poses(), state
    odo = JaxOdometry(map_config(jax_cfg), capacity=CAPACITY, seed=0, async_mode=True,
                      transfer="float32")
    odo.process_scans(scans, batch=BATCH)
    odo.finalize()
    runs["batched"] = odo.poses(), None
    return runs


def port(search="dense", **kw):
    return Odometry(config_from_dict(dataclasses.asdict(map_config(jax_cfg, search))),
                    capacity=CAPACITY, seed=0, device="cpu", transfer="float32", **kw)


def assert_poses_close(est, ref):
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(est[:, :3, :3], ref[:, :3, :3], atol=1e-4)


def assert_world_is_a_rotation(odo):
    R = odo._world_dev[:3, :3].double()
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    np.testing.assert_allclose(torch.linalg.svdvals(R).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("search", ["dense", "grid_hash"])
def test_map_process_scan_matches_jax(scans, jax_runs, search):
    """Frame by frame on plo_tpu's draws: world poses within 2 mm / 1e-4 rad
    of plo_tpu's, the map as large, the world pose a rotation; and the
    trajectory under the 0.1 m ATE bound."""
    from plo_tpu_torch.utils import evaluate
    scans, gt = scans
    ref, _ = jax_runs[search]
    odo = port(search)
    frames = [odo.process_scan(s, draws=JaxDraws(0, k)) for k, s in enumerate(scans)]
    assert_poses_close(odo.poses(), ref)
    assert all(f.n_correspondences > 300 for f in frames[1:])
    assert 4000 < int(odo._device_map.valid.sum()) <= 32768
    assert_world_is_a_rotation(odo)
    assert evaluate.ate_rmse(odo.poses(), gt, align=False) < 0.1
    np.testing.assert_allclose(frames[-1].rel_pose,
                               np.linalg.inv(frames[-2].pose) @ frames[-1].pose, atol=1e-12)


def test_map_process_scans_matches_jax(scans, jax_runs):
    """The batched map step (frame 0 alone, frames 1-4 in batches of 2, the
    map, world pose and last relative pose on the device, the rows fetched
    once a drain) on plo_tpu's batched draws."""
    scans, _ = scans
    ref, _ = jax_runs["batched"]
    draws = [JaxDraws(0, 0)] + [JaxBatchDraws(0, f) for f in range(1, N_FRAMES)]
    odo = port(async_mode=True)
    odo.process_scans(scans, batch=BATCH, draws=draws)
    assert len(odo.finalize()) == N_FRAMES
    assert_poses_close(odo.poses(), ref)
    assert_world_is_a_rotation(odo)


def test_map_resume_from_jax_state_matches_jax(scans, jax_runs):
    """plo_tpu's map-mode state after frame 2 (its voxel map as a cloud, its
    f32 world pose, last relative pose, filtered cloud and trajectory)
    loaded through convert.py: frames 3-4 on plo_tpu's draws match its
    poses."""
    scans, _ = scans
    ref, state = jax_runs["dense"]
    odo = odometry_state_from_numpy(port(), **state)
    np.testing.assert_array_equal(odo.poses(), ref[:RESUME_AFTER + 1])
    for k in range(RESUME_AFTER + 1, N_FRAMES):
        odo.process_scan(scans[k], draws=JaxDraws(0, k))
    assert_poses_close(odo.poses(), ref)


def test_map_grid_hash_matches_dense():
    """tests/test_map_mode.py::test_map_grid_hash_matches_dense on the port,
    with its config, frames and bound: on the port's own draws the
    grid-hash search reproduces the dense engine's trajectory within 2 mm."""
    from test_map_mode import AZ_STEPS as AZ, N_SCANS as N, mkcfg
    scans, _ = synthetic.synthetic_sequence(6, n_scans=N, azimuth_steps=AZ, speed=0.5,
                                            yaw_rate=0.01, seed=3)
    poses = {}
    for search in ("dense", "grid_hash"):
        cfg = config_from_dict(dataclasses.asdict(mkcfg("map", search=search, match="IMLS")))
        odo = Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu", transfer="float32")
        for s in scans:
            odo.process_scan(s)
        poses[search] = odo.poses()
    dt = np.linalg.norm(poses["grid_hash"][:, :3, 3] - poses["dense"][:, :3, 3], axis=1)
    assert dt.max() < 2e-3


def test_bench_map_config_is_the_tools():
    """bench.map_config(search) is tools/bench_map_mode.py's Config."""
    for search in ("dense", "grid_hash"):
        m = jax_cfg
        cfg = m.Config(
            scan_registration=m.ScanRegistrationConfig(
                compute_normal_method=m.ComputeNormalConfig(format="range_image", method="pca"),
                presample_method=m.PresampleConfig(method="geometric_features"),
                sample_method=m.SampleConfig(
                    method="random", random=m.RandomSampleConfig(max_points=2000))),
            laser_odometry=m.LaserOdometryConfig(
                target_mode="map",
                map=m.MapConfig(voxel_size=0.3, capacity=65536, search=search),
                refresh_correspondences=False,
                matching_method=m.MatchingConfig(method="IMLS"),
                solve_method=m.SolveConfig(
                    method="RANSAC", iterations=30,
                    ransac=m.RANSACConfig(max_iterations=1000, distance_threshold=0.2,
                                          final_solve_method="DRPM"))),
            sensor=m.SensorConfig(n_scans=64, azimuth_resolution=0.4))
        assert dataclasses.asdict(bench.map_config(search)) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("case", ["ba", "grid_hash-projected"])
def test_map_mode_guards_match_jax(case):
    """plo_tpu's two map-mode guards (odometry.py:700-703, 716-723), with
    their texts."""
    def cfg(m):
        lo = map_config(m, "grid_hash").laser_odometry
        if case == "ba":
            lo = dataclasses.replace(lo, ba=m.BAConfig(enabled=True))
        else:
            mm = lo.matching_method
            lo = dataclasses.replace(lo, matching_method=dataclasses.replace(mm, imls=dataclasses.replace(
                mm.imls, use_projected_distance=dataclasses.replace(
                    mm.imls.use_projected_distance, enabled=True))))
        return dataclasses.replace(map_config(m), laser_odometry=lo)
    with pytest.raises(ValueError) as ref:
        JaxOdometry(cfg(jax_cfg), capacity=CAPACITY)
    with pytest.raises(ValueError) as err:
        Odometry(cfg(port_cfg), capacity=CAPACITY, device="cpu")
    assert str(err.value) == str(ref.value)


@pytest.mark.parametrize("field,value", [("target_mode", "frames"), ("search", "kdtree")])
def test_unknown_map_options_raise(field, value):
    lo = map_config(port_cfg).laser_odometry
    lo = (dataclasses.replace(lo, target_mode=value) if field == "target_mode" else
          dataclasses.replace(lo, map=dataclasses.replace(lo.map, search=value)))
    with pytest.raises(ValueError, match=value):
        Odometry(dataclasses.replace(map_config(port_cfg), laser_odometry=lo),
                 capacity=CAPACITY, device="cpu")
