"""Per-module parity of the port's plane-ICP slice with plo_tpu — the
curvature presample, random sampling, plane-ICP matching in both modes and
the Gauss-Newton ("Ceres") solver — and the front-end of the shipped
configs/aloam_kitti00.json, on the same numpy inputs: the corridor scans of
tests/test_torch_ops.py at 32 beams x 450, capacity 16384. JAX runs on the
CPU; the port runs with device="cpu".

Tolerances: indices, masks and counters exactly; curvature within the f32
rounding bound of its sums (`curvature_bound`: it is a difference of
window sums that cancel, and XLA's fused loop rounds them in another order
than eager PyTorch); matched points to 1e-4 absolute and normals to
1e-6 (gathered, so exact up to the sum order of the projection); the
Gauss-Newton delta to 1e-5 (20 f32 solves of a 6x6 system, in another
summation order)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.models.pipeline import FrontEnd as JaxFrontEnd
from plo_tpu.ops import features as jax_features
from plo_tpu.ops import matching as jax_matching
from plo_tpu.ops import normals as jax_normals
from plo_tpu.ops import preprocess as jax_pre
from plo_tpu.ops import sampling as jax_sampling
from plo_tpu.solvers import solve_gauss_newton as jax_solve_gn
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.pipeline import FrontEnd
from plo_tpu_torch.ops import cuda_nn, features, matching, normals, preprocess, sampling
from plo_tpu_torch.solvers.gauss_newton import solve_gauss_newton

N_SCANS, AZ_STEPS, CAPACITY = 32, 450, 16384
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALOAM = os.path.join(REPO, "configs", "aloam_kitti00.json")


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """One parallel sqrt on every torch CPU thread before any comparison. In a
    process where JAX has run, the first vectorized sqrt a fresh torch worker
    thread computes can come back far off the last bit on that thread's rows
    (seen with torch 2.13+cpu); later calls are within an ulp. A defect of the
    CPU math library, not of the code under test."""
    torch.sqrt(torch.rand(4096, 512))


def t(a):
    return torch.from_numpy(np.array(a))


def sensor(mod):
    return mod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS)


def aloam(mod):
    """configs/aloam_kitti00.json as loaded by `mod.load`."""
    return mod.load(ALOAM, sensor=sensor(mod))


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    raw, _ = synthetic.synthetic_sequence(2, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                          speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return raw


def padded(s):
    pts = np.zeros((CAPACITY, 4), np.float32)
    pts[:len(s)] = s
    return pts, len(s)


@pytest.fixture(scope="module")
def frames(scans):
    """Both packages' preprocess + PCA normals of each scan."""
    res = []
    for s in scans:
        pts, n = padded(s)
        rc_j = jax_pre.preprocess(jnp.asarray(pts), n, sensor(jax_cfg))
        rc_p = preprocess.preprocess(t(pts), n, sensor(port_cfg))
        nr_j = jax_normals.compute_normals_pca(rc_j, jax_cfg.PCAConfig(), True)
        nr_p = normals.compute_normals_pca(rc_p, port_cfg.PCAConfig(), True)
        res.append((rc_j, rc_p, nr_j, nr_p))
    return res


def curvature_bound(xyz, total, w):
    """Per-point bound on the f32 rounding of |sum_k (x_{j+k} - x_j)|^2:
    each component of the difference sums 2w+2 terms of magnitude S_c =
    sum_k |x_{j+k,c}| + (2w+1)|x_{j,c}|, so its error is at most
    delta_c = (2w+1) eps S_c in either summation order, and the square's at
    most 2 |d_c| delta_c + delta_c^2."""
    cap = len(xyz)
    idx = np.arange(cap)
    s = np.zeros_like(xyz, dtype=np.float64)
    d = np.zeros_like(xyz, dtype=np.float64)
    n = np.zeros((cap, 1))
    for k in range(-w, w + 1):
        ok = ((idx + k >= 0) & (idx + k < total))[:, None]
        xk = xyz[np.clip(idx + k, 0, cap - 1)].astype(np.float64)
        s += np.where(ok, np.abs(xk), 0.0)
        d += np.where(ok, xk, 0.0)
        n += ok
    s += n * np.abs(xyz)
    d = np.abs(d - n * xyz)
    delta = (2 * w + 1) * np.finfo(np.float32).eps * s
    return (2 * d * delta + delta * delta).sum(1)


def test_ring_curvature_and_presample_match_jax(frames):
    rc_j, rc_p = frames[0][0], frames[0][1]
    cj = np.asarray(jax_features.ring_curvature(rc_j, 5))
    cp = features.ring_curvature(rc_p, 5).numpy()
    assert (cj > 0).sum() > 1000
    np.testing.assert_array_equal(cp > 0, cj > 0)
    bound = curvature_bound(rc_p.xyz.numpy(), int(rc_p.valid.sum()), 5)
    assert (np.abs(cp - cj) <= bound).all()
    candj = np.asarray(jax_features.presample_curvature(jnp.asarray(cj), rc_j.valid, 0.02))
    candp = features.presample_curvature(t(cp), rc_p.valid, 0.02).numpy()
    np.testing.assert_array_equal(candp, candj)
    assert 2000 < candj.sum() < rc_p.valid.sum()


@pytest.mark.parametrize("extra", [None, 100], ids=["2000", "candidates+100"])
def test_random_sampling_matches_jax(frames, extra):
    """Fed JAX's own draw; with room for 100 more than the candidates, valid
    ends early."""
    rc_j, rc_p = frames[0][0], frames[0][1]
    cand = np.asarray(jax_features.presample_curvature(
        jax_features.ring_curvature(rc_j, 5), rc_j.valid, 0.02))
    max_points = 2000 if extra is None else int(cand.sum()) + extra
    key = jax.random.PRNGKey(11)
    ij, vj = jax_sampling.random_sampling(jnp.asarray(cand), key, max_points)
    scores = t(jax.random.uniform(key, (CAPACITY,)))
    ip, vp = sampling.random_sampling(t(cand), scores, max_points)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vp.numpy(), vj)
    np.testing.assert_array_equal(ip.numpy()[vj], np.asarray(ij)[vj])
    assert cand[ip.numpy()[vj]].all() and (extra is None) == vj.all()


def _match_inputs(frames):
    """Target = frame 0's filtered cloud; source = 1,500 of frame 1's
    candidates, moved by a small motion (an ICP iteration's input), 100 of
    them 10 m up (no anchor within reach) and the last 100 invalid."""
    nr_t, nr_s = frames[0][2], frames[1][2]
    cand = np.asarray(jax_features.presample_geometric(nr_s.cloud.eigvals, nr_s.cloud.valid, 0.05))
    idx = np.flatnonzero(cand)[:1500]
    src = np.asarray(nr_s.cloud.xyz)[idx] + np.array([0.3, -0.05, 0.02], np.float32)
    src[1300:1400, 2] += 10.0
    fields = dict(xyz=src, normal=np.asarray(nr_s.cloud.normal)[idx],
                  intensity=np.zeros(len(idx), np.float32),
                  curvature=np.zeros(len(idx), np.float32),
                  eigvals=np.zeros((len(idx), 3), np.float32),
                  valid=np.arange(len(idx)) < 1400)
    tgt = {f.name: np.asarray(getattr(nr_t.cloud, f.name)) for f in dataclasses.fields(JaxCloud)}
    to_jax = lambda d: JaxCloud(**{k: jnp.asarray(v) for k, v in d.items()})
    to_port = lambda d: PointCloud(**{k: t(v) for k, v in d.items()})
    return to_jax(fields), to_jax(tgt), to_port(fields), to_port(tgt)


@pytest.mark.parametrize("projected", [False, True], ids=["euclidean", "projected"])
@pytest.mark.parametrize("angle", [True, False], ids=["angle-gate", "no-angle-gate"])
def test_plane_icp_project_matches_jax(frames, projected, angle):
    """y, normal, valid and the three counters, in both anchor modes, with
    the normal-angle gate on and off."""
    cfg_j, cfg_p = (dataclasses.replace(
        mod.PlaneICPConfig(),
        use_projected_distance=mod.ProjectedDistanceConfig(enabled=projected, r_proj=0.8),
        normal_angle_constraint=mod.NormalAngleConstraintConfig(enabled=angle))
        for mod in (jax_cfg, port_cfg))
    src_j, tgt_j, src_p, tgt_p = _match_inputs(frames)
    rj = jax_matching.plane_icp_project(src_j, tgt_j, cfg_j)
    cuda_nn.reset_launches()
    rp = matching.plane_icp_project(src_p, tgt_p, cfg_p)
    assert all(n == 0 for n in cuda_nn.LAUNCHES.values())  # CPU: plain versions
    vj = np.asarray(rj.valid)
    assert vj.sum() > 300
    np.testing.assert_array_equal(rp.valid.numpy(), vj)
    np.testing.assert_allclose(rp.y.numpy(), np.asarray(rj.y), atol=1e-4)
    np.testing.assert_allclose(rp.normal.numpy(), np.asarray(rj.normal), atol=1e-6)
    assert set(rp.counters) == set(rj.counters)
    for k, v in rj.counters.items():
        assert int(rp.counters[k]) == int(v), k
    assert int(rj.counters["too_far"]) > 0  # the anchor gate is exercised
    assert (int(rj.counters["normal_constraint"]) > 0) == angle


def planar_problem(rng, n=600):
    """Correspondences consistent with a known small motion, a few moved off
    their planes (the Huber weights act on them)."""
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.01
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    tr = rng.normal(size=3)
    tr = tr / np.linalg.norm(tr) * 0.05
    s = (rng.random((n, 3)) - 0.5) * 40
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = s @ R.T + tr
    out = rng.choice(n, 30, replace=False)
    d[out] += rng.normal(size=(30, 3))
    valid = rng.random(n) > 0.05
    return [a.astype(np.float32) for a in (s, d, nrm)] + [valid], R, tr


@pytest.mark.parametrize("n_valid", ["most", "two"])
def test_solve_gauss_newton_matches_jax(rng, n_valid):
    """The Huber Gauss-Newton delta and ok flag; with 2 valid rows ok is
    False and the delta is the identity."""
    arrays, R, tr = planar_problem(rng)
    if n_valid == "two":
        arrays[3] = np.arange(len(arrays[3])) < 2
    Tj, okj = jax_solve_gn(*[jnp.asarray(a) for a in arrays], 20)
    Tp, okp = solve_gauss_newton(*[t(a) for a in arrays], 20)
    assert bool(okp) == bool(okj) == (n_valid == "most")
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)
    if n_valid == "most":  # near the true motion (the outliers pull it a little)
        np.testing.assert_allclose(Tp.numpy()[:3, :3], R, atol=1e-3)
        np.testing.assert_allclose(Tp.numpy()[:3, 3], tr, atol=5e-3)
    else:
        np.testing.assert_array_equal(Tp.numpy(), np.eye(4))


@pytest.mark.parametrize("first", [True, False], ids=["frame0", "frame1"])
def test_aloam_front_end_matches_jax(scans, first):
    """The shipped aloam_kitti00.json front-end (curvature presample, random
    sampling of 2,000, use_all_points) on JAX's draw: the same sampled points
    and stats, and the stage-1 curvature kept in the model cloud."""
    fe_j = JaxFrontEnd(aloam(jax_cfg), capacity=CAPACITY)
    fe_p = FrontEnd(aloam(port_cfg), capacity=CAPACITY, device="cpu")
    assert fe_p.n_draws(first) == 1 and fe_p.sample_size == 2000
    last_j = last_p = None
    if not first:
        last_j = fe_j.process(scans[0], jax.random.PRNGKey(1), None, first_frame=True).filtered
        last_p = fe_p.process(scans[0], [t(jax.random.uniform(jax.random.PRNGKey(1),
                                                              (CAPACITY,)))],
                              None, first_frame=True).filtered
    s = scans[0] if first else scans[1]
    key = jax.random.PRNGKey(5)
    oj = fe_j.process(s, key, last_j, first_frame=first)
    op = fe_p.process(s, [t(jax.random.uniform(key, (CAPACITY,)))], last_p, first_frame=first)
    vj = np.asarray(oj.flat.valid)
    assert vj.sum() == 2000
    np.testing.assert_array_equal(op.flat.valid.numpy(), vj)
    np.testing.assert_array_equal(op.flat.xyz.numpy(), np.asarray(oj.flat.xyz))
    cp, cj = op.filtered.curvature.numpy(), np.asarray(oj.filtered.curvature)
    assert (cj > 0).sum() > 1000
    np.testing.assert_array_equal(cp > 0, cj > 0)
    bound = curvature_bound(op.filtered.xyz.numpy(), int(op.stats["n_preprocessed"]), 5)
    assert (np.abs(cp - cj) <= bound).all()
    for k, v in oj.stats.items():
        assert int(op.stats[k]) == int(v), k
