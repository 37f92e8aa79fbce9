"""The planetary world in the port: tests/test_planetary.py's claims on
plo_tpu_torch, and its DRPM trajectory against plo_tpu's on the same frames
and draws. The claim that needs the Weighted LS run (DRPM bounds the
degenerate chain) is in tests/test_torch_planetary_chain.py: the two files
run on two test workers.

The world (SyntheticWorld.planetary) is flat ground with a few sub-meter
rocks: nearly every normal is +z, so point-to-plane constraints pin only z,
roll and pitch, the regime DRPM (solver.cpp:486-603) exists for. 8 frames
at 32 beams x 450, 0.5 m a frame, capacity 16384, IMLS + RANSAC-300.

Tolerances: the DRPM poses within 1e-4 m and 1e-4 rad of plo_tpu's (seen
0 m: DRPM zeroes the degenerate directions, which holds the chain still in
both); the claims' bounds are tests/test_planetary.py's."""
import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import (GeneratorDraws, Odometry, _flat_query_cap,
                                           match_once, prepare_target)
from plo_tpu_torch.models.pipeline import FrontEnd
from plo_tpu_torch.solvers.drpm import solve_drpm

N_SCANS, AZ_STEPS, CAPACITY, FRAMES = 32, 450, 16384, 8
PROBS = [f"drpm_prob_{i}" for i in range(6)]


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module (the suite runs on 6 pytest workers
    side by side), then one parallel sqrt on every thread (see
    tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def cfg(mod, final_solve):
    """tests/test_planetary.py::_cfg."""
    return mod.Config(
        scan_registration=mod.ScanRegistrationConfig(sample_method=mod.SampleConfig(
            method="random", random=mod.RandomSampleConfig(max_points=1500))),
        laser_odometry=mod.LaserOdometryConfig(
            matching_method=mod.MatchingConfig(method="IMLS"),
            solve_method=mod.SolveConfig(method="RANSAC", iterations=30, ransac=mod.RANSACConfig(
                max_iterations=300, distance_threshold=0.2, final_solve_method=final_solve))),
        sensor=mod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


@pytest.fixture(scope="module")
def planetary():
    world = synthetic.SyntheticWorld.planetary(seed=5, n_rocks=8, extent=50.0)
    scans, gt = synthetic.synthetic_sequence(FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.0, seed=3, world=world)
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def run(scans, final_solve):
    """The port frame by frame on plo_tpu's draws."""
    odo = Odometry(cfg(port_cfg, final_solve), capacity=CAPACITY, seed=0, device="cpu")
    for k, s in enumerate(scans):
        odo.process_scan(s, draws=JaxDraws(0, k))
    return odo


@pytest.fixture(scope="module")
def drpm(planetary):
    return run(planetary[0], "DRPM")


def test_planetary_world_matches_jax():
    from plo_tpu.io import synthetic as jax_synthetic
    a = synthetic.SyntheticWorld.planetary(seed=5, n_rocks=8, extent=50.0)
    b = jax_synthetic.SyntheticWorld.planetary(seed=5, n_rocks=8, extent=50.0)
    assert np.array_equal(a.boxes, b.boxes) and a.ground_z == b.ground_z


def test_drpm_trajectory_matches_jax(planetary, drpm):
    scans, _ = planetary
    odo = JaxOdometry(cfg(jax_cfg, "DRPM"), capacity=CAPACITY, seed=0)
    for s in scans:
        odo.process_scan(s)
    est, ref = drpm.poses(), odo.poses()
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(est[:, :3, :3], ref[:, :3, :3], rtol=0, atol=1e-4)


def test_drpm_probs_surface_in_driver_stats(planetary, drpm):
    """Each frame's stats carry the six DRPM probabilities: ones on frame 0
    (no solve), below the threshold on some frame, per frame and through
    process_scans (on the port's own draws)."""
    scans, _ = planetary
    thr = cfg(port_cfg, "DRPM").laser_odometry.solve_method.ransac.drpm_threshold
    traj = drpm.trajectory
    assert all(traj[0].stats[k] == 1.0 for k in PROBS)
    min_probs = [min(f.stats[k] for k in PROBS) for f in traj[1:]]
    assert min(min_probs) < thr, min_probs
    assert all(0.0 <= p <= 1.0 for p in min_probs)
    odo = Odometry(cfg(port_cfg, "DRPM"), capacity=CAPACITY, seed=0, device="cpu",
                   async_mode=True)
    odo.process_scans(scans, batch=4)
    min_probs_b = [min(f.stats[k] for k in PROBS) for f in odo.finalize()[1:]]
    assert min(min_probs_b) < thr, min_probs_b


def _min_prob(scans):
    """The least DRPM probability of a solve of frame 2's sample against
    frame 1 (tests/test_planetary.py's min_prob_on)."""
    c = cfg(port_cfg, "DRPM")
    r = c.laser_odometry.solve_method.ransac
    fe = FrontEnd(c, capacity=CAPACITY, device="cpu")
    draws = GeneratorDraws(torch.Generator().manual_seed(0), torch.device("cpu"))
    prev = fe.process(scans[0], draws.frontend(fe.n_draws(True), fe.filtered_capacity),
                      None, True)
    cur = fe.process(scans[1], draws.frontend(fe.n_draws(False), fe.filtered_capacity),
                     prev.filtered, False)
    assert _flat_query_cap(c) is None
    tgt_n, tgt_ok = prepare_target(c, prev.filtered, False)
    res = match_once(c, cur.flat, prev.filtered, tgt_n, tgt_ok)
    w = res.valid.to(torch.float32)
    w = w / w.sum().clamp_min(1.0)
    _, _, probs = solve_drpm(cur.flat.xyz, res.y, res.normal, res.valid, w, r.drpm_threshold,
                             r.drpm_stdev_points, r.drpm_stdev_normals)
    return float(probs.min())


def test_drpm_snr_branch_engages_on_real_frames(planetary):
    """The SNR branch is scene-driven: below the threshold on the planetary
    frames, above it on the structure-rich corridor."""
    corridor_world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    corridor, _ = synthetic.synthetic_sequence(2, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                               speed=0.5, yaw_rate=0.0, seed=3,
                                               world=corridor_world)
    thr = cfg(port_cfg, "DRPM").laser_odometry.solve_method.ransac.drpm_threshold
    p_flat, p_rich = _min_prob(planetary[0]), _min_prob(corridor)
    assert p_flat < thr, (p_flat, thr)
    assert p_rich > thr, (p_rich, thr)
    assert p_flat < p_rich
