"""Per-module parity of the port's front-end and matching ops with plo_tpu, on
the same numpy inputs: a 32-beam x 450 synthetic scan pair at capacity 16384
(the tests/test_odometry.py CPU size). JAX runs on the CPU; the port runs
with device="cpu".

Tolerances: indices, masks, counts and ranks exactly; f32 values to about
1e-5 relative; eigen-data of covariances as derived in
test_pca_normals_match_jax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.io import synthetic as jax_synthetic
from plo_tpu.ops import eigh3 as jax_eigh3
from plo_tpu.ops import features as jax_features
from plo_tpu.ops import matching as jax_matching
from plo_tpu.ops import neighbors as jax_neighbors
from plo_tpu.ops import normals as jax_normals
from plo_tpu.ops import preprocess as jax_pre
from plo_tpu.ops import sampling as jax_sampling
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.ops import eigh3, features, matching, neighbors, normals, preprocess, sampling

N_SCANS, AZ_STEPS, CAPACITY = 32, 450, 16384


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


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    raw, _ = synthetic.synthetic_sequence(2, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                          speed=0.5, yaw_rate=0.01, seed=3, world=world)
    out = []
    for s in raw:
        pts = np.zeros((CAPACITY, 4), np.float32)
        pts[:len(s)] = s
        out.append((pts, len(s)))
    return out


@pytest.fixture(scope="module")
def frames(scans):
    """Both packages' preprocess + PCA normals of each scan."""
    res = []
    for pts, n in scans:
        rc_j = jax_pre.preprocess(jnp.asarray(pts), n, sensor(jax_cfg))
        rc_p = preprocess.preprocess(t(pts), n, sensor(port_cfg))
        nr_j = jax_normals.compute_normals_pca(rc_j, jax_cfg.PCAConfig(), True)
        nr_p = normals.compute_normals_pca(rc_p, port_cfg.PCAConfig(), True)
        res.append((rc_j, rc_p, nr_j, nr_p))
    return res


def test_synthetic_copy_matches_jax():
    a, ga = synthetic.synthetic_sequence(2, n_scans=16, azimuth_steps=180, seed=5)
    b, gb = jax_synthetic.synthetic_sequence(2, n_scans=16, azimuth_steps=180, seed=5)
    np.testing.assert_array_equal(ga, gb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_eigh3_matches_jax(rng):
    A = rng.normal(size=(512, 3, 3))
    A = (A + np.swapaxes(A, -1, -2)) / 2
    pts = rng.normal(size=(256, 40, 3)) * np.array([3.0, 1.0, 1e-2])
    c = pts - pts.mean(1, keepdims=True)
    planar = np.einsum("bni,bnj->bij", c, c) / 39
    iso = np.tile(np.eye(3) * 2.0, (4, 1, 1))
    for M in (A, planar, iso):
        M = M.astype(np.float32)
        wj, Vj = jax_eigh3.eigh3_descending(jnp.asarray(M))
        wp, Vp = eigh3.eigh3_descending(t(M))
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Vp.numpy(), np.asarray(Vj), atol=2e-4)


def test_preprocess_matches_jax(frames):
    for rc_j, rc_p, _, _ in frames:
        for f in ("ring", "valid", "ring_start", "ring_count", "pos_in_ring"):
            np.testing.assert_array_equal(getattr(rc_p, f).numpy(), np.asarray(getattr(rc_j, f)), f)
        np.testing.assert_array_equal(rc_p.xyz.numpy(), np.asarray(rc_j.xyz))
        np.testing.assert_allclose(rc_p.rel_time.numpy(), np.asarray(rc_j.rel_time), atol=1e-5)
        np.testing.assert_allclose(rc_p.intensity.numpy(), np.asarray(rc_j.intensity), atol=1e-5)


def test_ring_sort_keeps_valid_prefix(frames):
    """Every valid point lies below sum(ring_count): the cylinder_stats
    kernel's t_live bound relies on it."""
    for _, rc, _, _ in frames:
        live = int(rc.ring_count.sum())
        assert live > 0
        assert bool(rc.valid[:live].all()) and not bool(rc.valid[live:].any())


def test_assign_rings_vlp32_table_matches_jax(rng):
    xyz = rng.normal(size=(2000, 3)).astype(np.float32) * np.array([20, 20, 3], np.float32)
    valid = rng.random(2000) > 0.1
    for n_scans in (16, 32, 64):
        rj, vj = jax_pre.assign_rings(jnp.asarray(xyz), jnp.asarray(valid), n_scans)
        rp, vp = preprocess.assign_rings(t(xyz), t(valid), n_scans)
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))


def test_pca_normals_match_jax(frames):
    """Masks exactly. Eigen-data come from f32 covariances whose sums round
    differently in XLA and PyTorch, and the trigonometric closed form turns a
    rounding difference into an eigenvalue error of up to sqrt(eps) * lambda1
    near coincident eigenvalues (arccos near +-1). An eigenvector then moves
    by that error over the eigen-gap, so the normal's angle bound is
    2 sqrt(eps) lambda1 / (lambda2 - lambda3). Plane-fail points (kept in
    the model, barred from sampling) have no such gap and are held to masks
    and unit length only."""
    root_eps = np.sqrt(np.finfo(np.float32).eps)
    for _, _, nr_j, nr_p in frames:
        v = np.asarray(nr_j.cloud.valid)
        assert v.sum() > 3000
        np.testing.assert_array_equal(nr_p.cloud.valid.numpy(), v)
        pf = np.asarray(nr_j.plane_fail)
        np.testing.assert_array_equal(nr_p.plane_fail.numpy(), pf)
        a, b = nr_p.cloud.normal.numpy(), np.asarray(nr_j.cloud.normal)
        ev = np.asarray(nr_j.cloud.eigvals)
        tol = 1e-6 + root_eps * np.abs(ev[:, :1])
        assert (np.abs(nr_p.cloud.eigvals.numpy() - ev) <= tol).all()
        m = v & ~pf
        cos = (a * b).sum(1)[m]
        assert (cos > 0).all()  # same +z hemisphere choice
        cond = ev[m, 0] / np.maximum(ev[m, 1] - ev[m, 2], 1e-30)
        angle = np.arccos(np.clip(cos, -1.0, 1.0))
        assert (angle <= 1e-4 + 2 * root_eps * cond).all()
        np.testing.assert_allclose(np.linalg.norm(a[v], axis=1), 1.0, atol=1e-5)


def test_geometric_features_match_jax(frames):
    _, _, nr_j, _ = frames[0]
    ev = np.asarray(nr_j.cloud.eigvals)
    fj = jax_features.geometric_features(jnp.asarray(ev))
    fp = features.geometric_features(t(ev))
    np.testing.assert_allclose(fp.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)
    valid = np.asarray(nr_j.cloud.valid)
    cj = jax_features.presample_geometric(jnp.asarray(ev), jnp.asarray(valid), 0.05)
    cp = features.presample_geometric(t(ev), t(valid), 0.05)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


def _candidates(nr):
    cloud = nr.cloud
    cand = jax_features.presample_geometric(cloud.eigvals, cloud.valid, 0.05) & ~nr.plane_fail
    return (np.asarray(cloud.xyz), np.asarray(cloud.normal), np.asarray(cand),
            np.asarray(cloud.valid))


def test_normal_sampling_matches_jax(frames):
    xyz, nrm, cand, _ = _candidates(frames[0][2])
    key = jax.random.PRNGKey(11)
    ij, vj = jax_sampling.normal_sampling(jnp.asarray(nrm), jnp.asarray(cand), key,
                                          8, 8, 20, 100, 6400, strategy="random")
    scores = t(jax.random.uniform(key, (CAPACITY,)))
    ip, vp = sampling.normal_sampling(t(nrm), t(cand), scores, 8, 8, 20, 100, 6400)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ip.numpy()[vp.numpy()], np.asarray(ij)[np.asarray(vj)])
    assert vp.sum() > 500


def test_rank_within_bins_matches_jax(rng):
    p, n_bins = 5000, 64
    bins = rng.integers(0, n_bins, p)
    member = rng.random(p) < 0.7
    scores = rng.random(p).astype(np.float32)
    scores[:50] = scores[50:100]  # score ties resolve by index
    rj, cj = jax_sampling._rank_within_bins(jnp.asarray(bins, jnp.int32), jnp.asarray(member),
                                            jnp.asarray(scores), n_bins)
    rp, cp = sampling._rank_within_bins(t(bins), t(member), t(scores), n_bins)
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


def test_major_axis_sampling_matches_jax(frames):
    """Frames >= 2 of the slice: cylinder weights against the previous
    filtered cloud and FPS quotas (both kernels' plain versions on the port
    side; the XLA forms on the JAX side)."""
    _, _, _, nr_prev = frames[0]
    xyz, nrm, cand, _ = _candidates(frames[1][2])
    last_xyz = nr_prev.cloud.xyz.numpy()
    last_valid = nr_prev.cloud.valid.numpy()
    key = jnp.asarray([np.uint32(0), np.uint32(4)])
    ij, vj = jax_sampling.major_axis_sampling(
        jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(cand), jnp.asarray(last_xyz),
        jnp.asarray(last_valid), key, r=0.5, r_proj=1.5, max_total_points=2000,
        azimuth_bins=8, elevation_bins=8, min_points_per_bin=20, max_points_per_bin=200,
        out_size=6400, strategy="FPS")
    k_sub, k_sel = jax.random.split(key)
    ip, vp = sampling.major_axis_sampling(
        t(xyz), t(nrm), t(cand), t(last_xyz), t(last_valid),
        t(jax.random.uniform(k_sub, (CAPACITY,))), t(jax.random.uniform(k_sel, (CAPACITY,))),
        0.5, 1.5, 2000, 8, 8, 20, 200, 6400)
    vj = np.asarray(vj)
    assert 500 < vj.sum() <= 2000
    np.testing.assert_array_equal(vp.numpy(), vj)
    np.testing.assert_array_equal(ip.numpy()[vj], np.asarray(ij)[vj])


def test_knn_matches_jax(frames):
    _, _, nr_j, _ = frames[0]
    tgt = np.asarray(nr_j.cloud.xyz)
    tv = np.asarray(nr_j.cloud.valid)
    q = tgt[tv][::7][:600] + np.float32(0.05)
    dj, ij, vj = jax_neighbors.knn(jnp.asarray(q), jnp.asarray(tgt), jnp.asarray(tv), k=20,
                                   radius=3.0, chunk=4096)
    dp, ip, vp = neighbors.knn(t(q), t(tgt), t(tv), k=20, radius=3.0, chunk=4096)
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vp.numpy(), vj)
    np.testing.assert_array_equal(ip.numpy()[vj], np.asarray(ij)[vj])
    np.testing.assert_allclose(dp.numpy()[vj], np.asarray(dj)[vj], rtol=1e-6)


def test_ring_neighbor_search_matches_jax(frames):
    rc_j, rc_p, _, _ = frames[0]
    for off in (-1, 1):
        dj, fj, okj = jax_neighbors.ring_neighbor_search(
            rc_j.xyz, rc_j.ring, rc_j.pos_in_ring, rc_j.valid, rc_j.ring_start,
            rc_j.ring_count, off)
        dp, fp, okp = neighbors.ring_neighbor_search(
            rc_p.xyz, rc_p.ring, rc_p.pos_in_ring, rc_p.valid, rc_p.ring_start,
            rc_p.ring_count, off)
        okj = np.asarray(okj)
        np.testing.assert_array_equal(okp.numpy(), okj)
        np.testing.assert_array_equal(fp.numpy()[okj], np.asarray(fj)[okj])
        np.testing.assert_allclose(dp.numpy()[okj], np.asarray(dj)[okj], rtol=1e-6)


def _match_inputs(frames):
    """Target = frame 0's filtered cloud; source = frame 1's candidates,
    moved by a small motion (an ICP iteration's input)."""
    nr_t = frames[0][2]
    xyz, nrm, cand, _ = _candidates(frames[1][2])
    idx = np.flatnonzero(cand)[:1500]
    src = xyz[idx] + np.array([0.3, -0.05, 0.02], np.float32)
    fields = dict(xyz=src, normal=nrm[idx], intensity=np.zeros(len(idx), np.float32),
                  curvature=np.zeros(len(idx), np.float32),
                  eigvals=np.zeros((len(idx), 3), np.float32),
                  valid=np.ones(len(idx), bool))
    tgt = {f.name: np.asarray(getattr(nr_t.cloud, f.name)) for f in dataclasses.fields(JaxCloud)}
    from plo_tpu_torch.cloud import PointCloud
    to_jax = lambda d: JaxCloud(**{k: jnp.asarray(v) for k, v in d.items()})
    to_port = lambda d: PointCloud(**{k: t(v) for k, v in d.items()})
    return to_jax(fields), to_jax(tgt), to_port(fields), to_port(tgt)


def _assert_match_equal(rp, rj):
    vj = np.asarray(rj.valid)
    assert vj.sum() > 300
    np.testing.assert_array_equal(rp.valid.numpy(), vj)
    np.testing.assert_allclose(rp.y.numpy(), np.asarray(rj.y), atol=1e-4)
    np.testing.assert_allclose(rp.normal.numpy(), np.asarray(rj.normal), atol=1e-6)
    for k, v in rj.counters.items():
        assert int(rp.counters[k]) == int(v), k


def test_imls_project_matches_jax(frames):
    cfg_j, cfg_p = jax_cfg.IMLSConfig(), port_cfg.IMLSConfig()
    src_j, tgt_j, src_p, tgt_p = _match_inputs(frames)
    rj = jax_matching.imls_project(src_j, tgt_j, cfg_j, knn_select="exact")
    rp = matching.imls_project(src_p, tgt_p, cfg_p)
    _assert_match_equal(rp, rj)


def test_imls_cached_matches_jax(frames):
    """Hybrid refresh's cached evaluation, at the search pose and after a
    small pose change."""
    cfg_j, cfg_p = jax_cfg.IMLSConfig(), port_cfg.IMLSConfig()
    src_j, tgt_j, src_p, tgt_p = _match_inputs(frames)
    cache_j = jax_matching.imls_search(src_j, tgt_j, cfg_j, knn_select="exact")
    cache_p = matching.imls_search(src_p.xyz, tgt_p, cfg_p)
    np.testing.assert_array_equal(cache_p[1].numpy(), np.asarray(cache_j[1]))
    for shift in (0.0, 0.01):
        sj = dataclasses.replace(src_j, xyz=src_j.xyz + shift)
        sp = dataclasses.replace(src_p, xyz=src_p.xyz + shift)
        rj = jax_matching.imls_project_cached(sj, tgt_j, cfg_j, cache_j)
        rp = matching.imls_project_cached(sp, tgt_p, cfg_p, cache_p)
        _assert_match_equal(rp, rj)
    rp_full = matching.imls_project(src_p, tgt_p, cfg_p)
    rp_cached = matching.imls_project_cached(src_p, tgt_p, cfg_p, cache_p)
    np.testing.assert_array_equal(rp_cached.valid.numpy(), rp_full.valid.numpy())


def test_precompute_target_normals_matches_jax(frames):
    """Masks exactly; normals up to sign (this path has no hemisphere
    flip) within the bound of test_pca_normals_match_jax, with
    the eigenvalues taken from a float64 covariance of the same neighbors."""
    nr = frames[0][2]
    xyz, valid = np.asarray(nr.cloud.xyz)[:4000], np.asarray(nr.cloud.valid)[:4000]
    nj, okj = jax_matching.precompute_target_normals(jnp.asarray(xyz), jnp.asarray(valid), 1.0, 10)
    np_, okp = matching.precompute_target_normals(t(xyz), t(valid), 1.0, 10)
    okj = np.asarray(okj)
    assert okj.sum() > 1000
    np.testing.assert_array_equal(okp.numpy(), okj)
    _, idx, _ = jax_neighbors.knn(jnp.asarray(xyz), jnp.asarray(xyz), jnp.asarray(valid), k=10,
                                  radius=1.0)
    nb = xyz[np.asarray(idx)[okj]].astype(np.float64)
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("tki,tkj->tij", c, c) / 10)[:, ::-1]
    cond = ev[:, 0] / np.maximum(ev[:, 1] - ev[:, 2], 1e-30)
    cos = np.abs((np_.numpy()[okj] * np.asarray(nj)[okj]).sum(1))
    angle = np.arccos(np.clip(cos, -1.0, 1.0))
    assert (angle <= 1e-4 + 2 * np.sqrt(np.finfo(np.float32).eps) * cond).all()
