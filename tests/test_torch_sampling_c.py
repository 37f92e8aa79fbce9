"""Slice C's samplers and normal scans against plo_tpu on the same numpy
inputs: three-axis sampling (with engineered ties, and with fewer candidates
than a list holds), normal sampling with the FPS strategy, major-axis
sampling with random quotas, farthest-point sampling, the exact two-gather
kd form and the index scan of the PCA normals, and the hardened input of the
method matrix. Front-end arrays come from plo_tpu's preprocess and normals
of a 32-beam x 450 corridor scan at capacity 16384 (tests/test_torch_ops.py).

Tolerances: indices, masks and ranks exactly; the distorted scans bit for
bit; PCA eigen-data within the conditioning bound of
test_torch_ops.py::test_pca_normals_match_jax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import CAPACITY, _candidates, frames, scans, sensor, t  # noqa: F401

from plo_tpu import config as jax_cfg
from plo_tpu.io import synthetic as jax_synthetic
from plo_tpu.ops import normals as jax_normals
from plo_tpu.ops import preprocess as jax_pre
from plo_tpu.ops import sampling as jax_sampling
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.ops import normals, preprocess, sampling


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for the module, restored after it: the suite runs
    six pytest workers on the host's cores, and a worker's full OpenMP pool
    on these small tensors waits on the other workers' threads. Then one
    parallel sqrt on every thread (tests/test_torch_odometry.py::
    torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def _three_axis_inputs(frames):
    nr = frames[0][2]
    xyz, nrm, cand, _ = _candidates(nr)
    return xyz, nrm, np.asarray(nr.cloud.eigvals), cand


def _assert_three_axis_equal(xyz, nrm, ev, cand, k):
    ij, vj = jax_sampling.three_axis_sampling(jnp.asarray(xyz), jnp.asarray(nrm),
                                              jnp.asarray(ev), jnp.asarray(cand), k)
    ip, vp = sampling.three_axis_sampling(t(xyz), t(nrm), t(ev), t(cand), k)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    return ip.numpy(), vp.numpy()


@pytest.mark.parametrize("case", ["scan", "ties", "few-candidates"])
def test_three_axis_sampling_matches_jax(frames, case):
    """Every index exactly, padding included: lax.top_k takes the lowest
    index among equal scores (and +0 above -0), and so must the port. "ties"
    repeats 400 points (equal scores on every list) and zeroes normal
    components (scores of +0 and -0); "few-candidates" keeps 50 candidates
    for lists of 167, so each list's tail is -inf ties."""
    xyz, nrm, ev, cand = (a.copy() for a in _three_axis_inputs(frames))
    k = 167
    if case == "ties":
        src = np.flatnonzero(cand)[:400]
        dst = np.flatnonzero(cand)[-400:]
        xyz[dst], nrm[dst], ev[dst] = xyz[src], nrm[src], ev[src]
        zeroed = np.flatnonzero(cand)[400:700]
        nrm[zeroed, 0] = 0.0
        nrm[zeroed[:150], 1] = -0.0
        xyz[zeroed[150:], :] = 0.0
    if case == "few-candidates":
        keep = np.flatnonzero(cand)[::97][:50]
        cand = np.zeros_like(cand)
        cand[keep] = True
    idx, valid = _assert_three_axis_equal(xyz, nrm, ev, cand, k)
    assert idx.shape == (9 * k,)
    assert valid.sum() == 9 * min(k, cand.sum())
    if case == "ties":   # duplicated points do win places, so ties were decided
        assert np.isin(idx[valid], dst).any() and np.isin(idx[valid], src).any()


def test_normal_sampling_fps_matches_jax(frames):
    """Normal sampling with the FPS strategy (sampling.py:167-171): the
    within-bin slot order from the same uniform draw, farthest-first ranks
    to max_points_per_bin."""
    xyz, nrm, cand, _ = _candidates(frames[0][2])
    key = jax.random.PRNGKey(4)
    ij, vj = jax_sampling.normal_sampling(jnp.asarray(nrm), jnp.asarray(cand), key, 8, 8, 20,
                                          40, 2560, strategy="FPS", xyz=jnp.asarray(xyz))
    scores = t(jax.random.uniform(key, (CAPACITY,)))
    ip, vp = sampling.normal_sampling(t(nrm), t(cand), scores, 8, 8, 20, 40, 2560,
                                      strategy="FPS", xyz=t(xyz))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ip.numpy()[vp.numpy()], np.asarray(ij)[np.asarray(vj)])
    assert 300 < vp.sum() < cand.sum()


def test_major_axis_sampling_random_matches_jax(frames):
    """Major-axis sampling with random quotas (sampling.py:323-325): the
    second uniform draw of the split key ranks each bin's members."""
    xyz, nrm, cand, _ = _candidates(frames[1][2])
    last_xyz, _, _, last_valid = _candidates(frames[0][2])
    key = jax.random.PRNGKey(9)
    ij, vj = jax_sampling.major_axis_sampling(
        jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(cand), jnp.asarray(last_xyz),
        jnp.asarray(last_valid), key, 0.3, 1.0, 1500, 8, 8, 20, 200, 12800,
        strategy="random")
    sub, sel = (t(jax.random.uniform(k, (CAPACITY,))) for k in jax.random.split(key))
    ip, vp = sampling.major_axis_sampling(
        t(xyz), t(nrm), t(cand), t(last_xyz), t(last_valid), sub, sel, 0.3, 1.0, 1500, 8, 8,
        20, 200, 12800, strategy="random")
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ip.numpy()[vp.numpy()], np.asarray(ij)[np.asarray(vj)])
    assert 500 < vp.sum() <= 1500


@pytest.mark.parametrize("dup", [False, True], ids=["scan", "duplicates"])
def test_farthest_point_sampling_matches_jax(frames, dup):
    """Exact greedy FPS (sampling.py:478-504) from the same first draw;
    with duplicated points the farthest-point ties go to the lower index."""
    xyz, _, _, valid = (a.copy() for a in _candidates(frames[0][2]))
    if dup:
        v = np.flatnonzero(valid)
        xyz[v[-500:]] = xyz[v[:500]]
    key = jax.random.PRNGKey(3)
    ij = jax_sampling.farthest_point_sampling(jnp.asarray(xyz), jnp.asarray(valid), key, 64)
    first = jax.random.randint(key, (), 0, max(int(valid.sum()), 1))
    ip = sampling.farthest_point_sampling(t(xyz), t(valid), t(first).long(), 64)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    assert len(set(ip.tolist())) == 64


@pytest.mark.parametrize("form", ["exact_kd", "index", "fused_kd"])
def test_pca_normal_scans_match_jax(scans, form):
    """The PCA normals' other adjacent-ring forms (normals.py:57-206): the
    exact two-gather kd search (exact_kd, which the tensor-voting presample
    pins) and the same-position index scan. plo_tpu's opt-in fused kd
    layout (one arc gather, PLO_FUSED_KD) selects the same neighbors as the
    two-gather form, so the port's exact_kd is held against it as well.
    Masks exactly; eigen-data within test_pca_normals_match_jax's bound."""
    root_eps = np.sqrt(np.finfo(np.float32).eps)
    pts, n = scans[0]
    rc_j = jax_pre.preprocess(jnp.asarray(pts), n, sensor(jax_cfg))
    rc_p = preprocess.preprocess(t(pts), n, sensor(port_cfg))
    scan = "index" if form == "index" else "kdtree"
    pj = jax_cfg.PCAConfig(neighbor_scan=scan)
    if form == "fused_kd":
        c = pj.plane_constraint
        nr_j = jax_normals._pca_impl(rc_j, pj.window_size, pj.iter_step,
                                     pj.knn_distance_threshold, "kdtree", c.distance_threshold,
                                     c.valid_points_threshold, True, fused_kd=True,
                                     rolled_kd=False)
    else:
        nr_j = jax_normals.compute_normals_pca(rc_j, pj, True, exact_kd=form != "index")
    nr_p = normals.compute_normals_pca(rc_p, port_cfg.PCAConfig(neighbor_scan=scan), True,
                                       exact_kd=form != "index")
    v = np.asarray(nr_j.cloud.valid)
    assert v.sum() > 3000
    np.testing.assert_array_equal(nr_p.cloud.valid.numpy(), v)
    pf = np.asarray(nr_j.plane_fail)
    np.testing.assert_array_equal(nr_p.plane_fail.numpy(), pf)
    ev = np.asarray(nr_j.cloud.eigvals)
    assert (np.abs(nr_p.cloud.eigvals.numpy() - ev) <= 1e-6 + root_eps * np.abs(ev[:, :1])).all()
    m = v & ~pf
    cos = (nr_p.cloud.normal.numpy() * np.asarray(nr_j.cloud.normal)).sum(1)[m]
    cond = ev[m, 0] / np.maximum(ev[m, 1] - ev[m, 2], 1e-30)
    assert (np.arccos(np.clip(cos, -1.0, 1.0)) <= 1e-4 + 2 * root_eps * cond).all()


def test_index_scan_differs_from_kdtree(scans):
    """The index scan is its own neighbor selection, not the kd one."""
    pts, n = scans[0]
    rc = preprocess.preprocess(t(pts), n, sensor(port_cfg))
    a = normals.compute_normals_pca(rc, port_cfg.PCAConfig(neighbor_scan="index"), True)
    b = normals.compute_normals_pca(rc, port_cfg.PCAConfig(), True, exact_kd=True)
    assert not torch.equal(a.cloud.eigvals, b.cloud.eigvals)


def test_hardened_sequence_matches_the_method_matrix():
    """The method matrix's input (tools/method_matrix.py): render_scan
    patched to 2 cm noise, then distort_sequence and add_outliers with
    default_rng(5) — bit for bit, 3 frames."""
    orig = jax_synthetic.render_scan
    jax_synthetic.render_scan = lambda *a, **kw: orig(*a, **{**kw, "noise_std": 0.02})
    try:
        world = jax_synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
        raw, gt = jax_synthetic.synthetic_sequence(3, n_scans=32, azimuth_steps=450, speed=0.4,
                                                   yaw_rate=0.01, seed=3, world=world)
    finally:
        jax_synthetic.render_scan = orig
    ref = jax_synthetic.add_outliers(jax_synthetic.distort_sequence(raw, gt, 32),
                                     np.random.default_rng(5))
    scans_p, gt_p = synthetic.hardened_sequence(3)
    np.testing.assert_array_equal(gt_p, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt))
    for a, b in zip(scans_p, ref):
        np.testing.assert_array_equal(a, b)
    distorted = synthetic.distort_sequence(raw, gt, 32)
    for a, b in zip(distorted, jax_synthetic.distort_sequence(raw, gt, 32)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(distorted[1], raw[1])
