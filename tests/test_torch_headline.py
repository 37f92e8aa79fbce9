"""bench.py's headline config end to end: the port's batched path
(`Odometry.process_scans`) against plo_tpu's on the same draws, against its
own per-frame loop, on its own draws against the ground truth, and resumed
from plo_tpu's state after a batch; plus the port's bench entry point.

Sizes: 6 synthetic 32-beam x 450 scans of the corridor world (capacity
16384, batch 2: frame 0 alone, frames 1-4 as two batches, frame 5 alone),
except the trajectory bound, which needs the full HDL-64 x 900 scans (at
32 x 450 the DRPM stage finds this config's solves degenerate on some
frames). Tolerances: poses within 2 mm / 1e-4 rad of plo_tpu's (f32
differences of the same arithmetic through up to 30 ICP iterations, the bound
of test_torch_odometry.py's resume test); bit-identical where the port is
compared with itself.

plo_tpu packs int16 and grid16 scans with its C++ library when that builds,
and the C++ forms round differently from the NumPy forms the port copies
(tests/test_torch_grid_frontend.py); its runs here use the NumPy forms."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu import native as jax_native
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import bench, config as port_cfg
from plo_tpu_torch.convert import config_from_dict, odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import evaluate

from test_torch_grid_frontend import headline
from test_torch_odometry import JaxBatchDraws, JaxDraws, cloud_arrays

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, BATCH = 32, 450, 16384, 6, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for this module, restored after it: the suite runs
    six pytest workers on the host's cores, and a worker's full set of
    OpenMP threads on these small tensors spends its time waiting for the
    other workers' threads. Then one parallel sqrt on every thread (see
    tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                            speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return scans


def jax_draws():
    """The draws of plo_tpu's process_scans(batch=2) over the 6 frames:
    frames 0 and 5 one by one (host counter keys 1, then 2 and 3), frames
    1-4 in batches."""
    return [JaxDraws(0, 0)] + [JaxBatchDraws(0, f) for f in range(1, 5)] + [JaxDraws(0, 1)]


@pytest.fixture(scope="module")
def jax_runs(scans):
    """plo_tpu's process_scans per transfer, in two calls (frames 0-2, then
    3-5; the same frames run alone and batched as in one call), with its
    state after the first call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "quantize_pack", lambda *a: None)
    mp.setattr(jax_native, "rasterize_grid16", lambda *a: None)
    runs = {}
    try:
        for transfer in ("int16", "grid16"):
            odo = JaxOdometry(headline(jax_cfg), capacity=CAPACITY, seed=0, async_mode=True,
                              transfer=transfer)
            odo.process_scans(scans[:3], batch=BATCH)
            odo.finalize()
            state = dict(
                last_filtered=cloud_arrays(odo.last_filtered),
                window=cloud_arrays(odo._window_state()), frame_count=odo.frame_count,
                last_rel=np.array(odo._last_rel),
                trajectory=[dataclasses.asdict(f) for f in odo.trajectory])
            assert not odo.cloud_queue
            odo.process_scans(scans[3:], batch=BATCH)
            odo.finalize()
            runs[transfer] = odo.poses(), [f.iterations for f in odo.trajectory], state
    finally:
        mp.undo()
    return runs


def port_odometry(transfer, **kw):
    return Odometry(config_from_dict(dataclasses.asdict(headline(jax_cfg))), capacity=CAPACITY,
                    seed=0, device="cpu", transfer=transfer, **kw)


def assert_poses_close(est, ref):
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(est[:, :3, :3], ref[:, :3, :3], atol=1e-4)


@pytest.mark.parametrize("transfer", ["int16", "grid16"])
def test_process_scans_matches_jax(scans, jax_runs, transfer):
    """The port's process_scans on plo_tpu's draws: every pose within 2 mm /
    1e-4 rad of plo_tpu's; the ICP converged on every frame after the first."""
    ref, iters, _ = jax_runs[transfer]
    odo = port_odometry(transfer, async_mode=True)
    odo.process_scans(scans, batch=BATCH, draws=jax_draws())
    assert len(odo.finalize()) == N_FRAMES
    assert_poses_close(odo.poses(), ref)
    assert all(0 < f.iterations < 30 for f in odo.trajectory[1:])
    assert all(0 < i < 30 for i in iters[1:])


def test_resume_after_a_batch_matches_jax(scans, jax_runs):
    """plo_tpu's state after frames 0-2 (frame 0 alone, 1-2 as a batch; read
    through its _window_state(), since the batch leaves its cloud queue
    empty) loaded into the port: frames 3-5 on plo_tpu's draws match its
    poses."""
    ref, _, state = jax_runs["int16"]
    odo = odometry_state_from_numpy(port_odometry("int16"), **state)
    np.testing.assert_array_equal(odo.poses(), ref[:3])
    odo.process_scans(scans[3:], batch=BATCH, draws=jax_draws()[3:])
    assert_poses_close(odo.poses(), ref)


@pytest.mark.parametrize("async_mode", [False, True])
def test_process_scans_bit_identical_to_the_frame_loop(scans, async_mode):
    """At float32 (the per-frame path ships float32 too) and on the same
    draws, how frames are grouped changes nothing: poses, iterations and
    stats bit-identical (frame 0, frames 1-2 as a batch, frame 3 alone)."""
    loop = port_odometry("float32")
    for s in scans[:4]:
        loop.process_scan(s)
    batched = port_odometry("float32", async_mode=async_mode, sync_every=2)
    batched.process_scans(scans[:4], batch=BATCH)
    np.testing.assert_array_equal(batched.poses(), loop.poses())
    for a, b in zip(batched.trajectory, loop.trajectory):
        assert (a.index, a.iterations, a.n_correspondences, a.stats) == \
            (b.index, b.iterations, b.n_correspondences, b.stats)


@pytest.mark.parametrize("transfer", ["int16", "grid16"])
def test_headline_trajectory_under_the_bound(transfer):
    """The port on its own draws at HDL-64 x 900, capacity 57600 (frame 0,
    then frames 1-3 as one batch): ATE below test_grid16_transfer_trajectory's
    0.05 m."""
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(4, n_scans=64, azimuth_steps=900, speed=0.5,
                                             yaw_rate=0.01, seed=3, world=world)
    odo = Odometry(bench.headline_config(), capacity=bench.CAPACITY, seed=0, device="cpu",
                   async_mode=True, transfer=transfer)
    odo.process_scans(scans, batch=3)
    est = odo.poses()
    assert np.isfinite(est).all()
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    assert evaluate.ate_rmse(est, gt, align=False) < 0.05


def test_transfer_validation_as_jax():
    pointcloud = port_cfg.Config()
    with pytest.raises(ValueError, match="requires compute_normal_method.format='range_image'"):
        Odometry(pointcloud, device="cpu", transfer="grid16")
    curvature = dataclasses.replace(headline(port_cfg), scan_registration=dataclasses.replace(
        headline(port_cfg).scan_registration,
        presample_method=port_cfg.PresampleConfig(method="curvature")))
    with pytest.raises(ValueError, match="does not support the curvature presample"):
        Odometry(curvature, device="cpu", transfer="grid16")
    with pytest.raises(ValueError, match="transfer"):
        Odometry(pointcloud, device="cpu", transfer="float16")
    assert Odometry(pointcloud, device="cpu").transfer == "int16"


def test_headline_config_equals_bench_py():
    """bench.headline_config() is the Config bench.py builds (bench.py:117-141),
    field by field."""
    cfg = jax_cfg.Config(
        scan_registration=jax_cfg.ScanRegistrationConfig(
            compute_normal_method=jax_cfg.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=jax_cfg.PresampleConfig(method="geometric_features"),
            sample_method=jax_cfg.SampleConfig(
                method="random", random=jax_cfg.RandomSampleConfig(max_points=2000))),
        laser_odometry=jax_cfg.LaserOdometryConfig(
            refresh_correspondences=False,
            matching_method=jax_cfg.MatchingConfig(method="IMLS"),
            solve_method=jax_cfg.SolveConfig(
                method="RANSAC", iterations=30,
                ransac=jax_cfg.RANSACConfig(max_iterations=1000, distance_threshold=0.2,
                                            final_solve_method="DRPM"))),
        sensor=jax_cfg.SensorConfig(n_scans=64, azimuth_resolution=0.4))
    assert dataclasses.asdict(bench.headline_config()) == dataclasses.asdict(cfg)
    assert bench.N_FRAMES == 113 and bench.BATCH == 16 and bench.CAPACITY == 57600


def test_bench_scan_cache_reads_what_it_writes(tmp_path):
    """cached_sequence writes bench.py's format (n, gt, s0..) and reads it
    back; rendering in worker processes gives the same scans."""
    path = str(tmp_path / "scans.npz")
    kw = dict(n_scans=16, azimuth_steps=90, seed=5)
    one, gt = synthetic.synthetic_sequence(3, **kw)
    many, gt2 = synthetic.synthetic_sequence(3, workers=2, **kw)
    np.testing.assert_array_equal(gt, gt2)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
    np.savez(path, n=3, gt=gt, **{f"s{i}": s for i, s in enumerate(one)})
    read, gt3 = bench.cached_sequence(3, path=path)
    np.testing.assert_array_equal(gt3, gt)
    for a, b in zip(read, one):
        np.testing.assert_array_equal(a, b)


def test_bench_fails_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "plo_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert "scans_per_sec" not in proc.stdout
