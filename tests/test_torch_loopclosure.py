"""Loop closure in the port against plo_tpu's: revisit detection and the
pose-graph relaxation (host float64 in both, bit for bit) on
tests/test_loopclosure.py's unit cases, and close_loops on a short case:
the ground-truth poses of tests/test_loopclosure.py's rectangle loop
(136 frames at 1 m a frame, 32 beams x 450) with a drift added to every
relative pose, scans rendered only at the frames close_loops reads, its
headline-like config (range-image PCA, random 2,000, frozen IMLS,
RANSAC-1000 + DRPM) at capacity 14400, plo_tpu's draws fed in.

Tolerances: revisit pairs and the relaxed poses of the unit cases exactly;
close_loops' edges (i, j and correspondences) exactly, the loop edge's rel
within 1e-5 m and 1e-5 in each rotation entry (seen 1.3e-6 m and 1.8e-7: f32
ICP arithmetic in another order) and the corrected poses within 1e-4 m and
1e-5 (seen 2.2e-6 m and 1.3e-7: the loop edge, weight 10, spreads its rel's
difference over the chain)."""
import jax
import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.models import loopclosure as jax_lc
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models import loopclosure as lc

N_SCANS, AZ_STEPS, CAPACITY, MIN_GAP, RADIUS = 32, 450, 14400, 60, 4.0


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


def test_detect_revisits_matches_jax():
    """tests/test_loopclosure.py::test_detect_revisits_picks_closest_once."""
    t = np.linspace(0, 2 * np.pi, 80)
    pos = np.stack([20 * np.sin(t / 2), np.zeros_like(t), np.zeros_like(t)], 1)
    pairs = lc.detect_revisits(pos, min_gap=30, radius=2.0, min_spacing=15)
    assert pairs == jax_lc.detect_revisits(pos, min_gap=30, radius=2.0, min_spacing=15)
    i, j = pairs[0]
    assert j - i >= 30 and np.linalg.norm(pos[i] - pos[j]) < 2.0


def test_pose_graph_optimize_matches_jax():
    """tests/test_loopclosure.py::test_pose_graph_optimize_closes_synthetic_drift:
    a 30-pose chain whose rels carry a 2 cm bias, closed by a ground-truth
    edge between its ends."""
    n = 30
    gt = np.tile(np.eye(4), (n, 1, 1))
    for k in range(1, n):
        gt[k] = gt[k - 1].copy()
        gt[k][:3, 3] = gt[k - 1][:3, 3] + [1.0, 0, 0]
    est = np.tile(np.eye(4), (n, 1, 1))
    for k in range(1, n):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        rel[:3, 3] += [0, 0.02, 0]
        est[k] = est[k - 1] @ rel
    edges = [(k, k + 1, np.linalg.inv(est[k]) @ est[k + 1], 1.0) for k in range(n - 1)]
    edges.append((0, n - 1, np.linalg.inv(gt[0]) @ gt[-1], 50.0))
    fixed = lc.pose_graph_optimize(est, edges)
    assert np.array_equal(fixed, jax_lc.pose_graph_optimize(est, edges))
    before = np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])
    assert np.linalg.norm(fixed[-1, :3, 3] - gt[-1, :3, 3]) < before / 10


def loop_cfg(mod):
    """tests/test_loopclosure.py's config."""
    return mod.Config(
        scan_registration=mod.ScanRegistrationConfig(
            compute_normal_method=mod.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=mod.PresampleConfig(method="geometric_features"),
            sample_method=mod.SampleConfig(
                method="random", random=mod.RandomSampleConfig(max_points=2000))),
        laser_odometry=mod.LaserOdometryConfig(
            refresh_correspondences=False,
            matching_method=mod.MatchingConfig(method="IMLS"),
            solve_method=mod.SolveConfig(method="RANSAC", iterations=30, ransac=mod.RANSACConfig(
                max_iterations=1000, distance_threshold=0.2, final_solve_method="DRPM"))),
        sensor=mod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


class JaxLoopDraws(JaxDraws):
    """plo_tpu close_loops' draws: fold_in(PRNGKey(transfer_seed), idx) for
    the idx-th needed frame's front-end, fold_in(PRNGKey(transfer_seed),
    1000 + pi) for pair pi's ICP, folded with the iteration index."""

    def __init__(self, n, seed=0):
        self.fe_key = self.icp_key = jax.random.fold_in(jax.random.PRNGKey(seed), n)


@pytest.fixture(scope="module")
def drifted_loop():
    """The rectangle loop's ground truth (relative to frame 0), the same
    poses with every relative pose off by 2 mm sideways and 2e-4 rad of yaw,
    and the scans of the frames close_loops reads, rendered only there."""
    speeds, yaw_rates = synthetic.rectangle_loop_profile(n_straight=10, n_turn=24, speed=1.0)
    gt = synthetic.trajectory(len(speeds), speeds, yaw_rates)
    world = synthetic.SyntheticWorld.around_path(gt[:, :2, 3], seed=23)
    gtr = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    c, s = np.cos(2e-4), np.sin(2e-4)
    bias = np.array([[c, -s, 0, 0], [s, c, 0, 0.002], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    est = gtr.copy()
    for k in range(1, len(gtr)):
        est[k] = est[k - 1] @ np.linalg.inv(gtr[k - 1]) @ gtr[k] @ bias
    pairs = lc.detect_revisits(est[:, :3, 3], min_gap=MIN_GAP, radius=RADIUS)
    needed = sorted({f for p in pairs for f in p})
    scans = {f: synthetic.render_scan(world, gt[f], n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                      seed=23 + f) for f in needed}
    return gtr, est, scans, pairs


def test_close_loops_matches_jax(drifted_loop):
    gtr, est, scans, pairs = drifted_loop
    assert pairs and len(scans) == 2
    kw = dict(min_gap=MIN_GAP, radius=RADIUS, capacity=CAPACITY)
    fixed_j, edges_j = jax_lc.close_loops(loop_cfg(jax_cfg), scans, est, **kw)
    fixed, edges = lc.close_loops(loop_cfg(port_cfg), scans, est, device="cpu",
                                  frontend_draws=lambda idx: JaxLoopDraws(idx),
                                  icp_draws=lambda pi: JaxLoopDraws(1000 + pi), **kw)
    assert [(i, j, n) for i, j, _, n in edges] == [(i, j, n) for i, j, _, n in edges_j]
    for (_, _, rel, _), (_, _, rel_j, _) in zip(edges, edges_j):
        np.testing.assert_allclose(rel[:3, 3], rel_j[:3, 3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(rel[:3, :3], rel_j[:3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(fixed[:, :3, 3], fixed_j[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(fixed[:, :3, :3], fixed_j[:, :3, :3], rtol=0, atol=1e-5)
    # The closure pulls the drifted endpoint back; pose 0 stays.
    end = lambda p: np.linalg.norm(p[-1, :3, 3] - gtr[-1, :3, 3])
    assert end(fixed) < end(est) / 3, (end(est), end(fixed))
    np.testing.assert_array_equal(fixed[0], est[0])


def test_close_loops_without_revisits_returns_the_poses():
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5) * 10.0
    fixed, edges = lc.close_loops(loop_cfg(port_cfg), {}, poses, device="cpu")
    assert edges == [] and np.array_equal(fixed, poses) and fixed is not poses
