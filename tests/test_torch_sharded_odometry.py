"""The port's sharded map odometry (plo_tpu_torch/parallel/odometry.py) at
tests/test_parallel.py's CPU size (32 beams x 450, 8 CPU shards): against the
port's single-device map run, batched against per frame, against plo_tpu's
ShardedMapOdometry with plo_tpu's draws, and with a lost map shard
(tests/test_fault_injection.py:69-110).

Tolerances: the single-device bounds of tests/test_parallel.py:131-181
(positions within 0.01 m, ATE gap below 5 mm, no shard above 2/8 of the map);
batched equal to per frame bit for bit (the same operations on the same
inputs, the draws in the same order); plo_tpu parity within 2 mm / 1e-4 rad
a pose, the bound of tests/test_torch_map_mode.py (seen 3.8e-5 m and 4.9e-6
rad). The parity run solves with LS, as tests/test_torch_map_mode.py does:
its random sampling still takes plo_tpu's draws, but with RANSAC-300 at
32 x 450 one of ~500 correspondences crossing a gate, where XLA's FMA-fused
f32 distances round apart from torch's, makes the consensus pick another
hypothesis (8.4e-4 m and 2.5e-4 rad there; the port's single-device map run
parts from plo_tpu's by 9.7e-4 m on the same frames and draws).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.parallel import ShardedMapOdometry as JaxShardedMapOdometry
from plo_tpu.parallel import get_mesh as jax_get_mesh
from plo_tpu_torch import config as cfgmod
from plo_tpu_torch.convert import config_from_dict, odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.parallel import get_mesh
from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
from plo_tpu_torch.utils import checkpoint, evaluate

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, PARITY_FRAMES = 32, 450, 16384, 10, 8


@pytest.fixture(scope="module", autouse=True)
def torch_two_threads():
    """Two torch threads for the module (the suite runs on 6 pytest workers
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_config(matching="IMLS", solve=None, max_points=1200):
    """tests/test_parallel.py's sharded-map config (IMLS, RANSAC-300 + DRPM,
    frozen candidates, a 32,768-point map at 0.3 m)."""
    solve = solve or jax_cfg.SolveConfig(
        method="RANSAC", iterations=30,
        ransac=jax_cfg.RANSACConfig(max_iterations=300, distance_threshold=0.2,
                                    final_solve_method="DRPM"))
    return jax_cfg.Config(
        scan_registration=jax_cfg.ScanRegistrationConfig(
            sample_method=jax_cfg.SampleConfig(
                method="random", random=jax_cfg.RandomSampleConfig(max_points=max_points))),
        laser_odometry=jax_cfg.LaserOdometryConfig(
            target_mode="map", map=jax_cfg.MapConfig(voxel_size=0.3, capacity=32768),
            matching_method=jax_cfg.MatchingConfig(method=matching),
            solve_method=solve, refresh_correspondences=False),
        sensor=jax_cfg.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


def port(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def frames():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


@pytest.fixture(scope="module")
def per_frame(frames):
    scans, _ = frames
    sodo = ShardedMapOdometry(port(jax_config()), get_mesh(8, device="cpu"),
                              capacity=CAPACITY, seed=0)
    returned = [sodo.process_scan(s) for s in scans]
    assert [f.index for f in returned] == list(range(N_FRAMES))
    return sodo


def test_sharded_map_trajectory_matches_single_device(frames, per_frame):
    """tests/test_parallel.py::test_sharded_map_trajectory_matches_single_device
    in the port: 8 shards against the single-device map run."""
    scans, gt = frames
    odo = Odometry(port(jax_config()), capacity=CAPACITY, seed=0, device="cpu")
    for s in scans:
        odo.process_scan(s)
    ps, p1 = per_frame.poses(), odo.poses()
    assert np.linalg.norm(ps[:, :3, 3] - p1[:, :3, 3], axis=1).max() < 0.01
    ate_s, ate_1 = (evaluate.ate_rmse(p, gt, align=False) for p in (ps, p1))
    assert abs(ate_s - ate_1) < 0.005 and ate_s < 0.1
    total = int(per_frame.store.cloud.valid.sum())
    assert total > 1024
    assert per_frame.map_points_per_device() < max(2 * total // 8, 1024)
    assert all(s.capacity == 32768 // 8 for s in per_frame.store.shards)


def test_sharded_batched_scan_matches_per_frame(frames, per_frame):
    """tests/test_parallel.py::test_sharded_batched_scan_matches_per_frame in
    the port: frame 0 alone, two batches of 4, the last frame alone."""
    scans, _ = frames
    b = ShardedMapOdometry(port(jax_config()), get_mesh(8, device="cpu"), capacity=CAPACITY,
                           seed=0, defer_fetch=True)
    uploads = []
    real = b._upload_batch
    b._upload_batch = lambda batch: uploads.append(len(batch)) or real(batch)
    b.process_scans(scans, batch=4)
    assert uploads == [4, 4] and b.trajectory == []   # nothing fetched before finalize
    pb = b.poses()
    np.testing.assert_array_equal(pb, per_frame.poses())
    f = b.trajectory[-1]
    assert f.n_correspondences > 0 and "drpm_prob_0" in f.stats
    assert [x.iterations for x in b.trajectory] == [x.iterations for x in per_frame.trajectory]


def test_sharded_odometry_matches_jax(frames):
    """8 frames against plo_tpu's ShardedMapOdometry on 8 virtual devices
    (LS; random sampling of 1,024), the port fed plo_tpu's [seed, counter]
    draws (JaxDraws: the front-end
    key [0, 1] on frame 0, [0, 2k] and [0, 2k + 1] on frame k)."""
    scans, _ = frames
    scans = scans[:PARITY_FRAMES]
    cfg = jax_config(solve=jax_cfg.SolveConfig(method="LS", iterations=20), max_points=1024)
    jodo = JaxShardedMapOdometry(cfg, jax_get_mesh(8), capacity=CAPACITY, seed=0,
                                 defer_fetch=True)
    for s in scans:
        jodo.process_scan(s)
    jax_poses = jodo.poses()
    sodo = ShardedMapOdometry(port(cfg), get_mesh(8, device="cpu"), capacity=CAPACITY,
                              seed=0, defer_fetch=True)
    for k, s in enumerate(scans):
        sodo.process_scan(s, draws=JaxDraws(0, k))
    poses = sodo.poses()
    np.testing.assert_allclose(poses[:, :3, 3], jax_poses[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(poses[:, :3, :3], jax_poses[:, :3, :3], atol=1e-4)
    assert all(f.n_correspondences > 300 for f in sodo.trajectory[1:])


def test_lost_map_shard_degrades_gracefully(frames):
    """tests/test_fault_injection.py::test_lost_map_shard_degrades_gracefully
    in the port: shard 3's map wiped after 6 frames (a lost host rejoining
    blank); tracking goes on over the other 7/8, stays finite and under the
    ATE bound, and the shard fills again."""
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.4, yaw_rate=0.01, seed=3, world=world)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    cfg = jax_config(solve=jax_cfg.SolveConfig(method="LS", iterations=20))
    sodo = ShardedMapOdometry(port(cfg), get_mesh(8, device="cpu"), capacity=CAPACITY, seed=0)
    for s in scans[:6]:
        sodo.process_scan(s)
    lost = sodo.store.shards[3]
    assert int(lost.valid.sum()) > 0
    sodo.store.shards[3] = dataclasses.replace(lost, valid=torch.zeros_like(lost.valid))
    for s in scans[6:]:
        sodo.process_scan(s)
    est = sodo.poses()
    assert np.isfinite(est).all()
    assert evaluate.ate_rmse(est, gt, align=False) < 0.1
    assert int(sodo.store.shards[3].valid.sum()) > 0


@pytest.mark.parametrize("option", ["undistort", "saver"])
def test_options_outside_the_sharded_scope_raise(option, tmp_path):
    """plo_tpu's sharded odometry has no undistortion and no saver artifacts:
    a config asking for either is refused, not run without them."""
    cfg = port(jax_config())
    if option == "undistort":
        cfg = dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
            cfg.laser_odometry, undistort=True))
    else:
        cfg = dataclasses.replace(cfg, saver=cfgmod.SaverConfig(output_dir=str(tmp_path),
                                                                enabled=True))
    with pytest.raises(ValueError, match="sharded map path has no"):
        ShardedMapOdometry(cfg, get_mesh(8, device="cpu"), capacity=CAPACITY)


@pytest.mark.parametrize("loader", ["save", "load", "convert"])
def test_single_device_state_io_refuses_a_sharded_run(loader, tmp_path):
    """Odometry's checkpoint and its plo_tpu state loader would miss the shard
    store: they raise on a ShardedMapOdometry (save_sharded / load_sharded
    carry its state)."""
    sodo = ShardedMapOdometry(port(jax_config()), get_mesh(8, device="cpu"), capacity=CAPACITY)
    path = str(tmp_path / "state.npz")
    with pytest.raises(TypeError, match="ShardedMapOdometry"):
        if loader == "save":
            checkpoint.save(sodo, path)
        elif loader == "load":
            checkpoint.load(sodo, path)
        else:
            odometry_state_from_numpy(sodo, last_filtered={}, frame_count=0, last_rel=None,
                                      trajectory=())
