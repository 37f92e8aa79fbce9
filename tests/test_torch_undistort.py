"""Undistortion (per-point constant-velocity motion compensation) in both
drivers of the port against plo_tpu's, and its effect on swept scans.

The frames are those of tests/test_odometry.py::test_undistortion_improves_
ate_on_swept_scans: 8 corridor scans at 32 beams x 450, 0.8 m and 0.02 rad
a frame, each point moved as the sweep saw it (synthetic.distort_sequence).
The ATE claims run that test's config (pointcloud PCA, random 1,500,
plane-ICP, LS with 25 iterations, the motion prior). The parity runs take
the map-mode tests' front-end and matcher instead (range_image PCA, random
1,200, frozen IMLS, LS) on the first 5 frames, with 8 ICP iterations a
frame and no convergence test. On these swept frames plane-ICP over
pointcloud normals is chaotic at the tolerance, with undistortion on and off
alike: an ulp of difference flips a correspondence and the runs part by 2e-4
rad within 3 frames, as far as the port's own runs on 2 and 4 torch threads
part. And where a step lands next to the 1 mm convergence threshold, the
two packages stop one iteration apart (seen on frame 1 of the batched map
run, undistortion off as well), and the frames after part by 2e-4.

Tolerances: poses within 2 mm / 1e-4 rad of plo_tpu's (the bound of
tests/test_torch_odometry.py's resume test); the JAX test's ATE bounds."""
import dataclasses

import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import evaluate

from test_torch_odometry import JaxBatchDraws, JaxDraws

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, PARITY_FRAMES = 32, 450, 16384, 8, 5


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for this module (see tests/test_torch_headline.py),
    then one parallel sqrt on every thread (tests/test_torch_odometry.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def parity_config(target_mode="window"):
    """The parity runs' config, undistortion on, in plo_tpu's classes."""
    m = jax_cfg
    return m.Config(
        scan_registration=m.ScanRegistrationConfig(
            compute_normal_method=m.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=m.PresampleConfig(method="geometric_features"),
            sample_method=m.SampleConfig(method="random",
                                         random=m.RandomSampleConfig(max_points=1200))),
        laser_odometry=m.LaserOdometryConfig(
            undistort=True, target_mode=target_mode, map=m.MapConfig(capacity=32768),
            refresh_correspondences=False, matching_method=m.MatchingConfig(method="IMLS"),
            solve_method=m.SolveConfig(method="LS", iterations=8, delta_dist_threshold=0.0,
                                       delta_angle_threshold=0.0)),
        sensor=m.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


def config(undistort=True):
    """The JAX test's config (tests/test_odometry.py::base_config), in
    plo_tpu's classes."""
    m = jax_cfg
    return m.Config(
        scan_registration=m.ScanRegistrationConfig(
            compute_normal_method=m.ComputeNormalConfig(format="pointcloud", method="pca"),
            presample_method=m.PresampleConfig(method="geometric_features"),
            sample_method=m.SampleConfig(method="random",
                                         random=m.RandomSampleConfig(max_points=1500))),
        laser_odometry=m.LaserOdometryConfig(
            motion_prior=True, undistort=undistort,
            matching_method=m.MatchingConfig(method="plane_ICP"),
            solve_method=m.SolveConfig(method="LS", iterations=25)),
        sensor=m.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


def port(cfg, **kw):
    return Odometry(config_from_dict(dataclasses.asdict(cfg)), capacity=CAPACITY, seed=0,
                    device="cpu", transfer="float32", **kw)


@pytest.fixture(scope="module")
def swept():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.8, yaw_rate=0.02, seed=3, world=world)
    return (synthetic.distort_sequence(scans, gt, N_SCANS),
            np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt))


def batch_draws(n, batch):
    """plo_tpu's draws for process_scans(batch): frame 0 alone, full
    batches, then the short tail alone (host counter keys 1, 2, ...)."""
    full = 1 + (n - 1) // batch * batch
    return ([JaxDraws(0, 0)] + [JaxBatchDraws(0, f) for f in range(1, full)]
            + [JaxDraws(0, k) for k in range(1, n - full + 1)])


@pytest.fixture(scope="module")
def jax_runs(swept):
    """plo_tpu's parity runs on the first PARITY_FRAMES swept frames: window
    mode frame by frame, window and map mode batched (batch 2)."""
    scans = swept[0][:PARITY_FRAMES]
    odo = JaxOdometry(parity_config(), capacity=CAPACITY, seed=0, transfer="float32")
    for s in scans:
        odo.process_scan(s)
    runs = {"frames": odo.poses()}
    for mode in ("window", "map"):
        odo = JaxOdometry(parity_config(mode), capacity=CAPACITY, seed=0, async_mode=True,
                          transfer="float32")
        odo.process_scans(scans, batch=2)
        odo.finalize()
        runs[mode] = odo.poses()
    return runs


@pytest.fixture(scope="module")
def port_frames(swept):
    """The port frame by frame on the JAX test's config and plo_tpu's draws,
    undistortion on and off."""
    scans, _ = swept
    out = {}
    for undistort in (True, False):
        odo = port(config(undistort))
        for k, s in enumerate(scans):
            odo.process_scan(s, draws=JaxDraws(0, k))
        out[undistort] = odo.poses()
    return out


def assert_poses_close(est, ref):
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(est[:, :3, :3], ref[:, :3, :3], atol=1e-4)


def test_undistorted_process_scan_matches_jax(swept, jax_runs):
    """Source compensated with the last rPose, the window's model cloud with
    the one just solved: poses as plo_tpu's."""
    odo = port(parity_config())
    for k, s in enumerate(swept[0][:PARITY_FRAMES]):
        odo.process_scan(s, draws=JaxDraws(0, k))
    assert_poses_close(odo.poses(), jax_runs["frames"])


def test_undistortion_lowers_ate_on_swept_scans(swept, port_frames):
    """The JAX test's claim on the port: undistortion lowers the ATE, below
    0.03 m."""
    _, gt = swept
    ate = {u: evaluate.ate_rmse(p, gt, align=False) for u, p in port_frames.items()}
    assert ate[True] < ate[False]
    assert ate[True] < 0.03


def test_undistorted_process_scans_matches_jax(swept, jax_runs):
    """The batched window step compensates the source with the carried rPose
    and the model cloud with the solved one, as plo_tpu's: its poses (frames
    1-4 in batches of 2)."""
    scans, _ = swept
    odo = port(parity_config(), async_mode=True)
    odo.process_scans(scans[:PARITY_FRAMES], batch=2, draws=batch_draws(PARITY_FRAMES, 2))
    assert len(odo.finalize()) == PARITY_FRAMES
    assert_poses_close(odo.poses(), jax_runs["window"])


def test_undistorted_map_step_matches_jax(swept, jax_runs):
    """The batched map step with undistortion (the source compensated with
    the carried relative pose, the model cloud with the one just solved,
    before it enters the map at the new world pose): plo_tpu's poses."""
    scans, _ = swept
    odo = port(parity_config("map"), async_mode=True)
    odo.process_scans(scans[:PARITY_FRAMES], batch=2, draws=batch_draws(PARITY_FRAMES, 2))
    assert_poses_close(odo.poses(), jax_runs["map"])
