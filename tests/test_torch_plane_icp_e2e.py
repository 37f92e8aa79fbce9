"""The plane-ICP slice end to end: the shipped configs/aloam_kitti00.json
(curvature presample, random sampling, plane-ICP, Gauss-Newton) through the
port's Odometry against plo_tpu's, in both anchor modes:
  B1  as shipped, euclidean plane-ICP (the `nearest` search);
  B2  plane_ICP.use_projected_distance enabled (`projected_argmin`);
and B1 solved by LS (trimmed least squares) instead of Ceres.
5 corridor frames at the tests/test_odometry.py CPU size (32 beams x 450,
capacity 16384), as loaded by `config.load` (motion_prior=False).

Tolerances: poses within 2 mm and 1e-4 rad of JAX's on JAX's draws (f32
differences of the same arithmetic through the ICP iterations, the bound of
tests/test_torch_odometry.py); ATE < 0.1 m, the bound of
tests/test_odometry.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws, cloud_arrays

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.convert import odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import cuda_nn
from plo_tpu_torch.utils import evaluate

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, RESUME_AFTER = 32, 450, 16384, 5, 2
ALOAM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "aloam_kitti00.json")
MODES = ["B1", "B2"]


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """One parallel sqrt on every torch CPU thread before any comparison. In a
    process where JAX has run, the first vectorized sqrt a fresh torch worker
    thread computes can come back far off the last bit on that thread's rows
    (seen with torch 2.13+cpu); later calls are within an ulp. A defect of the
    CPU math library, not of the code under test."""
    torch.sqrt(torch.rand(4096, 512))


def aloam(mod, mode):
    cfg = mod.load(ALOAM, sensor=mod.SensorConfig(n_scans=N_SCANS,
                                                  azimuth_resolution=360.0 / AZ_STEPS))
    lo = cfg.laser_odometry
    if mode == "B1":
        return cfg
    if mode == "B1-LS":
        return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
            lo, solve_method=dataclasses.replace(lo.solve_method, method="LS")))
    mm = lo.matching_method
    picp = dataclasses.replace(mm.plane_icp, use_projected_distance=dataclasses.replace(
        mm.plane_icp.use_projected_distance, enabled=True))
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        lo, matching_method=dataclasses.replace(mm, plane_icp=picp)))


@pytest.fixture(scope="module")
def world():
    w = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=w)
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


@pytest.fixture(scope="module")
def jax_runs(world):
    """plo_tpu's run of each mode (made once, on first use): its trajectory
    and its carried state after frame RESUME_AFTER."""
    scans, _ = world
    runs = {}

    def get(mode):
        if mode not in runs:
            odo = JaxOdometry(aloam(jax_cfg, mode), capacity=CAPACITY, seed=0,
                              transfer="float32")
            state = None
            for i, s in enumerate(scans):
                odo.process_scan(s)
                if i == RESUME_AFTER:
                    state = dict(
                        last_filtered=cloud_arrays(odo.last_filtered),
                        cloud_queue=[cloud_arrays(c) for c in odo.cloud_queue],
                        frame_count=odo.frame_count, last_rel=np.array(odo._last_rel),
                        trajectory=[dataclasses.asdict(f) for f in odo.trajectory])
            runs[mode] = (odo.trajectory, odo.poses(), state)
        return runs[mode]
    return get


def assert_poses_close(frames, jax_traj):
    for f, fj in zip(frames, jax_traj):
        np.testing.assert_allclose(f.pose[:3, 3], fj.pose[:3, 3], atol=2e-3)
        np.testing.assert_allclose(f.pose[:3, :3], fj.pose[:3, :3], atol=1e-4)


@pytest.mark.parametrize("mode", MODES + ["B1-LS"])
def test_aloam_matches_jax_on_jax_draws(world, jax_runs, mode):
    """From frame 0 on JAX's draws: every pose within 2 mm of JAX's, the
    same ICP iteration counts (to one for LS), both under the ATE bound; on the CPU the
    searches take their plain versions (no kernel launches)."""
    scans, gt = world
    jax_traj, jax_poses, _ = jax_runs(mode)
    assert evaluate.ate_rmse(jax_poses, gt, align=False) < 0.1
    odo = Odometry(aloam(port_cfg, mode), capacity=CAPACITY, seed=0, device="cpu")
    cuda_nn.reset_launches()
    frames = [odo.process_scan(s, draws=JaxDraws(0, k)) for k, s in enumerate(scans)]
    assert all(n == 0 for n in cuda_nn.LAUNCHES.values())
    assert_poses_close(frames, jax_traj)
    iters, jax_iters = [f.iterations for f in frames], [f.iterations for f in jax_traj]
    if mode == "B1-LS":
        # LS trims by the rank of |residual|, so f32 differences move its
        # delta, and a delta near the 1 mm convergence threshold can stop
        # one iteration earlier or later (poses still agree to 2 mm).
        assert all(abs(a - b) <= 1 for a, b in zip(iters, jax_iters)), (iters, jax_iters)
    else:
        assert iters == jax_iters
    assert all(f.n_correspondences > 500 for f in frames[1:])
    assert all(f.stats["n_sampled"] == 2000 for f in frames)
    assert evaluate.ate_rmse(odo.poses(), gt, align=False) < 0.1


@pytest.mark.parametrize("mode", MODES)
def test_aloam_on_its_own_draws_meets_the_ate_bound(world, mode):
    scans, gt = world
    odo = Odometry(aloam(port_cfg, mode), capacity=CAPACITY, seed=0, device="cpu")
    frames = [odo.process_scan(s) for s in scans]
    assert np.isfinite(odo.poses()).all()
    assert evaluate.ate_rmse(odo.poses(), gt, align=False) < 0.1
    assert all(1 <= f.iterations < 30 for f in frames[1:])


@pytest.mark.parametrize("mode", MODES)
def test_aloam_resumed_from_jax_state_matches_jax(world, jax_runs, mode):
    """plo_tpu's state after frame 2 (the filtered cloud with its stage-1
    curvature, the window, the trajectory) loaded through convert.py; the
    remaining frames on JAX's draws match JAX's poses."""
    scans, _ = world
    jax_traj, jax_poses, state = jax_runs(mode)
    assert (state["last_filtered"]["curvature"] > 0).sum() > 1000
    odo = Odometry(aloam(port_cfg, mode), capacity=CAPACITY, seed=0, device="cpu")
    odometry_state_from_numpy(odo, **state)
    assert odo.last_filtered.curvature.dtype == torch.float32
    np.testing.assert_array_equal(odo.poses(), jax_poses[:RESUME_AFTER + 1])
    frames = [odo.process_scan(scans[k], draws=JaxDraws(0, k))
              for k in range(RESUME_AFTER + 1, N_FRAMES)]
    assert_poses_close(frames, jax_traj[RESUME_AFTER + 1:])


@pytest.mark.parametrize("what", ["cross_product", "FALS", "SRI", "map"])
def test_options_still_unported_raise(what):
    """What the port still leaves for later raises, on an otherwise
    supported config: the cross-product, FALS and SRI normals and map mode
    (projected and tensor-voting IMLS, the ICP and Teaser solvers and
    three-axis sampling run since slice C: tests/test_torch_solvers_c.py,
    tests/test_torch_tensor_voting.py, tests/test_torch_matrix.py)."""
    cfg = aloam(port_cfg, "B1")
    lo, sr = cfg.laser_odometry, cfg.scan_registration
    if what == "map":
        lo = dataclasses.replace(lo, target_mode="map")
    else:
        fmt = "pointcloud" if what == "cross_product" else "range_image"
        sr = dataclasses.replace(sr, compute_normal_method=dataclasses.replace(
            sr.compute_normal_method, format=fmt, method=what))
    cfg = dataclasses.replace(cfg, laser_odometry=lo, scan_registration=sr)
    with pytest.raises(NotImplementedError):
        Odometry(cfg, capacity=CAPACITY, device="cpu")
