"""Windowed bundle adjustment in the port against plo_tpu's, on the same
inputs: the normal equations and the Gauss-Newton refine
(plo_tpu_torch/parallel/ba.py), the correspondence recorder on IMLS and
plane-ICP, and the drivers (per frame and batched, and a JAX BA run resumed
in the port through convert.py), on tests/test_ba.py's BA config and
corridor frames at 32 beams x 450, capacity 16384, with plo_tpu's draws
fed in.

Tolerances, measured on this CPU (torch on 2 threads, as this module sets):
recorder masks, order and counts exactly, its source rows bit for bit (they
are gathered), y and n within 1e-5 (IMLS heights are f32 arithmetic, XLA's
CPU fuses them into FMAs); H and g within 1e-5 of their largest entry (f32
sums of 512 products in another order; seen 3e-7), the refine within 1e-6 m
(seen 1.5e-7; 2.4e-7 on the JAX driver's own window inputs); trajectories
within 1e-4 m and 5e-5 rad a pose. Seen: batched 1.9e-6 m and 9.7e-7 rad,
resumed 6.8e-7 m and 3.4e-7 rad, per frame 6.2e-5 m and 1.36e-5 rad. The
per-frame path casts each skip rel from the refined float64 chain, which
after the first refine (frame 3) differs from JAX's by ~1e-5 m; at frame 5
that moves one correspondence across a gate, so the skip record's valid
prefix shifts from its row 119 on (393 of 512 rows differ) and the window's
optimum moves by ~1e-5 rad. With BA off the same frames part by 3.6e-6 m and
9.6e-7 rad (at 8 threads by 4.5e-5 m, one ICP iteration more at frame 1)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_odometry import JaxBatchDraws, JaxDraws, cloud_arrays

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.models.odometry import _make_record_corr
from plo_tpu.parallel import ba as jax_ba
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.convert import odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import GeneratorDraws, Odometry, record_corr
from plo_tpu_torch.models.pipeline import FrontEnd
from plo_tpu_torch.parallel import ba

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, RESUME_AFTER, BATCH = 32, 450, 16384, 6, 3, 4
POS_TOL_M, ROT_TOL_RAD = 1e-4, 5e-5


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


def ba_cfg(mod):
    """tests/test_ba.py::_ba_cfg: random 1200, IMLS, RANSAC-300 + DRPM, BA
    over a window of 4 with 512 correspondences a record."""
    return mod.Config(
        scan_registration=mod.ScanRegistrationConfig(sample_method=mod.SampleConfig(
            method="random", random=mod.RandomSampleConfig(max_points=1200))),
        laser_odometry=mod.LaserOdometryConfig(
            ba=mod.BAConfig(enabled=True, window=4, iterations=4, max_correspondences=512),
            matching_method=mod.MatchingConfig(method="IMLS"),
            solve_method=mod.SolveConfig(method="RANSAC", iterations=30, ransac=mod.RANSACConfig(
                max_iterations=300, distance_threshold=0.2, final_solve_method="DRPM"))),
        sensor=mod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


def plane_icp_cfg(mod):
    """configs/aloam_kitti00.json (plane-ICP, Gauss-Newton) with BA on."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "aloam_kitti00.json")
    cfg = mod.load(path, sensor=mod.SensorConfig(n_scans=N_SCANS,
                                                 azimuth_resolution=360.0 / AZ_STEPS))
    lo = cfg.laser_odometry
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        lo, ba=dataclasses.replace(lo.ba, enabled=True)))


@pytest.fixture(scope="module")
def world():
    w = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=w)
    return scans, gt


@pytest.fixture(scope="module")
def jax_per_frame(world):
    """plo_tpu's per-frame BA run: its final poses and its state after frame
    RESUME_AFTER (the BA records and clouds with the rest)."""
    scans, _ = world
    odo = JaxOdometry(ba_cfg(jax_cfg), capacity=CAPACITY, seed=0)
    state = None
    for i, s in enumerate(scans):
        odo.process_scan(s)
        if i == RESUME_AFTER:
            state = dict(
                last_filtered=cloud_arrays(odo.last_filtered),
                cloud_queue=[cloud_arrays(c) for c in odo.cloud_queue],
                frame_count=odo.frame_count, last_rel=np.array(odo._last_rel),
                trajectory=[dataclasses.asdict(f) for f in odo.trajectory],
                ba_clouds=[cloud_arrays(c) for c in odo._ba_clouds],
                ba_corr={k: tuple(None if r is None else tuple(np.array(a) for a in r)
                                  for r in recs) for k, recs in odo._ba_corr.items()})
    return odo.poses(), state


def assert_trajectories_close(est, ref):
    dt = np.linalg.norm(est[:, :3, 3] - ref[:, :3, 3], axis=1)
    d = np.einsum("nji,njk->nik", est[:, :3, :3], ref[:, :3, :3])
    angle = np.arctan2(np.linalg.norm(np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0],
                                                d[:, 1, 0] - d[:, 0, 1]], 1), axis=1) / 2,
                       (np.trace(d, axis1=1, axis2=2) - 1) / 2)
    print(f"positions within {dt.max():.3g} m, rotations within {angle.max():.3g} rad")
    assert dt.max() < POS_TOL_M, dt
    assert angle.max() < ROT_TOL_RAD, angle


def window_problem(seed=0):
    """tests/test_ba.py::test_refine_window_pairs_converges_to_gt's inputs:
    exact plane correspondences for the consecutive and skip pairs of a
    4-pose window, and the poses perturbed (f64 ground truth, f32 inputs)."""
    from plo_tpu import geometry as jgeo
    rng = np.random.default_rng(seed)
    K, N = 4, 400
    gt, x = [], np.eye(4)
    dR = np.asarray(jgeo.exp_so3(jnp.asarray(np.array([[0.0, 0.0, 0.05]]))))[0]
    for _ in range(K):
        gt.append(x.copy())
        d = np.eye(4)
        d[:3, :3] = dR
        d[:3, 3] = [0.5, 0.02, 0.0]
        x = x @ d
    gt = np.stack(gt)

    def make_pair(i, j):
        pw = rng.uniform(-10, 10, (N, 3))
        nw = rng.normal(size=(N, 3))
        nw /= np.linalg.norm(nw, axis=1, keepdims=True)
        s = (np.linalg.inv(gt[j]) @ np.c_[pw, np.ones(N)].T).T[:, :3]
        y = (np.linalg.inv(gt[i]) @ np.c_[pw, np.ones(N)].T).T[:, :3]
        n = (np.linalg.inv(gt[i])[:3, :3] @ nw.T).T
        return s.astype(np.float32), y.astype(np.float32), n.astype(np.float32)

    pairs = tuple((i, i + 1) for i in range(K - 1)) + tuple((i, i + 2) for i in range(K - 2))
    blocks = [make_pair(i, j) for i, j in pairs]
    src, ref, nrm = (np.stack([b[f] for b in blocks]) for f in range(3))
    noisy = gt.copy()
    for k in range(1, K):
        w = rng.normal(size=3) * 0.01
        noisy[k][:3, :3] = noisy[k][:3, :3] @ np.asarray(jgeo.exp_so3(jnp.asarray(w[None])))[0]
        noisy[k][:3, 3] += rng.normal(size=3) * 0.05
    return gt, noisy.astype(np.float32), src, ref, nrm, pairs


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_residual_jacobian_matches_jax():
    _, poses, src, ref, nrm, _ = window_problem()
    valid = np.random.default_rng(1).random(src.shape[1]) > 0.2
    T_rel = np.linalg.inv(poses[0].astype(np.float64)) @ poses[1]
    (jt, js, jr, jn, jv), (pt, ps, pr, pn, pv) = both(T_rel.astype(np.float32), src[0], ref[0],
                                                      nrm[0], valid)
    for a, b in zip(jax_ba._residual_jacobian(jt, js, jr, jn, jv),
                    ba._residual_jacobian(pt, ps, pr, pn, pv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)
    assert not ba._residual_jacobian(pt, ps, pr, pn, pv)[1][~pv].any()


@pytest.mark.parametrize("huber", [None, 0.05], ids=["plain", "huber"])
@pytest.mark.parametrize("skips", [False, True], ids=["chain", "skip-pairs"])
def test_assemble_matches_jax(huber, skips):
    """H and g of the window with and without the IRLS Huber weight and the
    skip pairs, some correspondences invalid."""
    _, poses, src, ref, nrm, pairs = window_problem()
    valid = np.random.default_rng(2).random(src.shape[:2]) > 0.15
    n = len(pairs) if skips else 3
    args_j, args_p = both(poses, src[:n], ref[:n], nrm[:n], valid[:n])
    pairs = pairs if skips else None
    for a, b in zip(jax_ba._assemble(*args_j, 4, pairs, huber),
                    ba._assemble(*args_p, 4, pairs, huber)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-5 * np.abs(a).max())


def test_refine_window_matches_jax_and_converges_to_gt():
    gt, poses, src, ref, nrm, pairs = window_problem()
    val = np.ones(src.shape[:2], bool)
    args_j, args_p = both(poses, src, ref, nrm, val)
    refined_j = np.asarray(jax_ba.refine_window(*args_j, 4, 6, 1e-6, pairs))
    refined = ba.refine_window(*args_p, 4, 6, 1e-6, pairs).numpy()
    np.testing.assert_allclose(refined, refined_j, rtol=0, atol=1e-6)
    assert np.array_equal(refined[0], poses[0])   # gauge-fixed
    err = [np.linalg.norm(refined[k][:3, 3] - gt[k][:3, 3]) for k in range(4)]
    assert max(np.linalg.norm(poses[k][:3, 3] - gt[k][:3, 3]) for k in range(4)) > 0.03
    assert max(err) < 1e-4, err


def test_refine_window_makes_no_host_sync(monkeypatch):
    """No SVD, no torch.linalg.solve (both wait for the host on CUDA), no
    tensor read back to the host and no Python number written into a tensor
    (on CUDA a host-to-device copy that waits for the host, seen on the H100
    in geometry.make_se3) inside refine_window."""
    _, poses, src, ref, nrm, pairs = window_problem()
    args = [torch.from_numpy(a) for a in (poses, src, ref, nrm, np.ones(src.shape[:2], bool))]

    def refuse(*a, **k):
        raise AssertionError("host sync in refine_window")
    setitem = torch.Tensor.__setitem__

    def tensor_setitem(self, key, value):
        if not isinstance(value, torch.Tensor):
            refuse()
        setitem(self, key, value)
    for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "numpy",
                 "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__setitem__", tensor_setitem)
    for name in ("svd", "solve", "eigh", "inv"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    ba.refine_window(*args, 4, 4, 1e-6, pairs, 0.05)


def _jax_cloud(cloud):
    return JaxCloud(**{k: jnp.asarray(v) for k, v in cloud_arrays(cloud).items()})


@pytest.mark.parametrize("method", ["IMLS", "plane_ICP"])
def test_record_corr_matches_jax(world, method):
    """The recorder on the same clouds and relative pose: the matched rows
    first in plo_tpu's order, masks and counts exactly. Its record holds as
    many rows as the sample (not the drivers' 512, which the matches fill),
    so the order of the unmatched rows is held too."""
    scans, gt = world

    def cfg(mod):
        c = (ba_cfg if method == "IMLS" else plane_icp_cfg)(mod)
        lo = c.laser_odometry
        n_out = c.scan_registration.sample_method.random.max_points
        return dataclasses.replace(c, laser_odometry=dataclasses.replace(
            lo, ba=dataclasses.replace(lo.ba, max_correspondences=n_out)))
    cfg_p, cfg_j = cfg(port_cfg), cfg(jax_cfg)
    fe = FrontEnd(cfg_p, capacity=CAPACITY, device="cpu")
    draws = GeneratorDraws(torch.Generator().manual_seed(0), torch.device("cpu"))
    out0 = fe.process(scans[0], draws.frontend(fe.n_draws(True), fe.filtered_capacity),
                      None, True)
    out1 = fe.process(scans[1], draws.frontend(fe.n_draws(False), fe.filtered_capacity),
                      out0.filtered, False)
    rel = (np.linalg.inv(gt[0]) @ gt[1]).astype(np.float32)
    s, y, n, valid = record_corr(cfg_p, out1.flat, out0.filtered, torch.from_numpy(rel))
    sj, yj, nj, vj = (np.asarray(a) for a in _make_record_corr(cfg_j)(
        _jax_cloud(out1.flat), _jax_cloud(out0.filtered), jnp.asarray(rel)))
    n_out = cfg_p.laser_odometry.ba.max_correspondences
    assert valid.shape == (n_out,) and 100 < int(valid.sum()) < n_out
    assert np.array_equal(valid.numpy(), vj)
    assert valid[:int(valid.sum())].all()   # the matched rows first
    assert np.array_equal(s.numpy(), sj)
    np.testing.assert_allclose(y.numpy()[vj], yj[vj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(n.numpy()[vj], nj[vj], rtol=0, atol=1e-5)


def test_per_frame_ba_matches_jax(world, jax_per_frame):
    scans, _ = world
    odo = Odometry(ba_cfg(port_cfg), capacity=CAPACITY, seed=0, device="cpu")
    for k, s in enumerate(scans):
        odo.process_scan(s, draws=JaxDraws(0, k))
    assert sorted(odo._ba_corr) == list(range(N_FRAMES - 4, N_FRAMES))   # the window's
    assert odo._ba_corr[N_FRAMES - 1][1] is not None
    assert_trajectories_close(odo.poses(), jax_per_frame[0])


def test_batched_ba_matches_jax(world):
    """process_scans(batch=4) in async mode: frame 0 alone, frames 1-4 as one
    batch recorded in the loop and refined at the drain, frame 5 alone."""
    scans, _ = world
    jax_odo = JaxOdometry(ba_cfg(jax_cfg), capacity=CAPACITY, seed=0, async_mode=True)
    jax_odo.process_scans(scans, batch=BATCH)
    jax_odo.finalize()
    draws = ([JaxDraws(0, 0)] + [JaxBatchDraws(0, f) for f in range(1, 1 + BATCH)]
             + [JaxDraws(0, 1 + i) for i in range(N_FRAMES - 1 - BATCH)])
    odo = Odometry(ba_cfg(port_cfg), capacity=CAPACITY, seed=0, device="cpu", async_mode=True)
    odo.process_scans(scans, batch=BATCH, draws=draws)
    odo.finalize()
    assert_trajectories_close(odo.poses(), jax_odo.poses())


def test_ba_resumed_from_jax_state_matches_jax(world, jax_per_frame):
    """plo_tpu's state after frame 3 (the first refined window) with its BA
    records and clouds, loaded through convert.py; the port's next frames
    on JAX's draws end at JAX's poses, the refined earlier ones too."""
    scans, _ = world
    jax_poses, state = jax_per_frame
    odo = Odometry(ba_cfg(port_cfg), capacity=CAPACITY, seed=0, device="cpu")
    odometry_state_from_numpy(odo, **state)
    assert sorted(odo._ba_corr) == sorted(state["ba_corr"]) and len(odo._ba_clouds) == 4
    for k in range(RESUME_AFTER + 1, N_FRAMES):
        odo.process_scan(scans[k], draws=JaxDraws(0, k))
    assert_trajectories_close(odo.poses(), jax_poses)


def test_ba_in_map_mode_raises():
    """As plo_tpu (tests/test_ba.py::test_ba_rejected_in_map_mode)."""
    cfg = port_cfg.Config(laser_odometry=port_cfg.LaserOdometryConfig(
        target_mode="map", ba=port_cfg.BAConfig(enabled=True)))
    with pytest.raises(ValueError, match="ba.enabled"):
        Odometry(cfg, capacity=4096, device="cpu")
