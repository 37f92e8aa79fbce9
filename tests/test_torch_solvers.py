"""The port's solvers (build, LS, DRPM, RANSAC) against plo_tpu.solvers on the
same correspondences and, for RANSAC, the same draws: the first-seed ranks
JAX draws with jax.random.randint(key, (max_iterations,), 0, n_valid).

Tolerances: transforms to 1e-5 absolute (f32 SVD solves of the same
system), DRPM probabilities to 1e-4, inlier decisions exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import geometry as jax_geo
from plo_tpu import solvers as jax_solvers
from plo_tpu_torch import geometry
from plo_tpu_torch.config import RANSACConfig
from plo_tpu_torch.solvers import build, drpm, ls, ransac


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """One parallel sqrt on every torch CPU thread before any comparison. In a
    process where JAX has run, the first vectorized sqrt a fresh torch worker
    thread computes can come back far off the last bit on that thread's rows
    (seen with torch 2.13+cpu); later calls are within an ulp. A defect of the
    CPU math library, not of the code under test."""
    torch.sqrt(torch.rand(4096, 512))


def planar_problem(rng, n=600, n_outliers=0):
    """Correspondences consistent with a known small motion; outliers moved
    off their planes."""
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.01
    R = np.asarray(jax_geo.exp_so3(jnp.asarray(w[None])))[0]
    t = rng.normal(size=3)
    t = t / np.linalg.norm(t) * 0.05
    s = (rng.random((n, 3)) - 0.5) * 40
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = s @ R.T + t
    if n_outliers:
        out = rng.choice(n, n_outliers, replace=False)
        d[out] += rng.normal(size=(n_outliers, 3)) * 5.0
    valid = rng.random(n) > 0.05
    return [a.astype(np.float32) for a in (s, d, nrm)] + [valid]


def both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def test_geometry_matches_jax(rng):
    w = (rng.normal(size=(16, 3)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(geometry.exp_so3(torch.from_numpy(w)).numpy(),
                               np.asarray(jax_geo.exp_so3(jnp.asarray(w))), atol=1e-6)
    R = np.array(jax_geo.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(
        geometry.rotation_from_axis_angle(torch.from_numpy(w[0])).numpy(),
        np.asarray(jax_geo.rotation_from_axis_angle(jnp.asarray(w[0]))), atol=1e-6)
    np.testing.assert_allclose(geometry.rotation_angle(torch.from_numpy(R)).numpy(),
                               np.asarray(jax_geo.rotation_angle(jnp.asarray(R))), atol=1e-5)


def test_build_system_and_lstsq_match_jax(rng):
    j, p = both(planar_problem(rng))
    Aj, bj = jax_solvers.build_system(*j)
    Ap, bp = build.build_system(*p)
    np.testing.assert_allclose(Ap.numpy(), np.asarray(Aj), atol=1e-6)
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), atol=1e-6)
    np.testing.assert_allclose(build.masked_lstsq(Ap, bp).numpy(),
                               np.asarray(jax_solvers.masked_lstsq(Aj, bj)), atol=1e-5)


@pytest.mark.parametrize("degenerate", [False, True])
def test_drpm_matches_jax(rng, degenerate):
    s, d, n, valid = planar_problem(rng, n=400)
    if degenerate:  # all normals +z: x/y translation unobservable
        n[:] = np.array([0.0, 0.0, 1.0], np.float32)
    w = (rng.random(len(s)) + 0.5).astype(np.float32)
    w /= w.sum()
    j, p = both([s, d, n, valid, w])
    Tj, okj, pj = jax_solvers.solve_drpm(*j, 0.05, 0.02, 0.05)
    Tp, okp, pp = drpm.solve_drpm(*p, 0.05, 0.02, 0.05)
    assert bool(okp) == bool(okj)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=1e-4)
    assert (pp.numpy().min() < 0.05) == degenerate
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)


def test_ls_solvers_match_jax(rng):
    s, d, n, valid = planar_problem(rng, n_outliers=30)
    w = rng.random(len(s)).astype(np.float32)
    j, p = both([s, d, n, valid])
    Tj, okj = jax_solvers.solve_ls_trimmed(*j, 0.02)
    Tp, okp = ls.solve_ls_trimmed(*p, 0.02)
    assert bool(okp) == bool(okj)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)
    Tj, _ = jax_solvers.solve_weighted_ls(*j, jnp.asarray(w))
    Tp, _ = ls.solve_weighted_ls(*p, torch.from_numpy(w))
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)


@pytest.mark.parametrize("n_out,min_pct,method", [
    (50, 0.6, "DRPM"),       # stage A finds the winner
    (260, 0.97, "DRPM"),     # no hypothesis reaches min_inliers: the full stream
    (50, 0.6, "LS"),
    (50, 0.6, "Weighted LS"),
])
def test_ransac_matches_jax_on_jax_draws(rng, n_out, min_pct, method):
    s, d, n, valid = planar_problem(rng, n=600, n_outliers=n_out)
    key = jax.random.PRNGKey(7)
    kw = dict(max_iterations=800, distance_threshold=0.1, min_inliers_percentage=min_pct,
              huber_threshold=0.648, final_solve_method=method, ls_threshold=0.02,
              drpm_threshold=0.05, drpm_stdev_points=0.02, drpm_stdev_normals=0.05)
    j, p = both([s, d, n, valid])
    Tj, okj, pj = jax_solvers.solve_ransac(*j, key, return_probs=True, **kw)
    draws = jax.random.randint(key, (800,), 0, int(valid.sum()))
    Tp, okp, pp = ransac.solve_ransac(*p, torch.from_numpy(np.array(draws)).long(),
                                      RANSACConfig(**kw))
    assert bool(okp) == bool(okj)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=1e-4)


def test_ransac_hypotheses_match_jax(rng):
    """Seeds (FPS-3), seed solves and inlier counts of every hypothesis."""
    s, d, n, valid = planar_problem(rng, n=500, n_outliers=40)
    j, p = both([s, d, n, valid])
    firsts = np.flatnonzero(valid)[rng.integers(0, valid.sum(), 300)]
    seeds_j = np.asarray(jax_solvers.ransac._fps23_from_firsts(j[0], j[3], jnp.asarray(firsts)))
    seeds_p = ransac._fps23_from_firsts(p[0], p[3], torch.from_numpy(firsts))
    np.testing.assert_array_equal(seeds_p.numpy(), seeds_j)
    A, b = build.build_system(*p)
    x_p = ransac._solve_seeds(A[seeds_p], b[seeds_p])
    Aj, bj = jax_solvers.build_system(*j)
    x_j = jax.vmap(jax_solvers.ransac._solve_seed)(Aj[seeds_j], bj[seeds_j])
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=1e-4, atol=1e-5)
    R, t = geometry.exp_so3(x_p[:, :3]), x_p[:, 3:6]
    cnt_p = ransac._score(*p, R, t, 0.1)
    cnt_j = jax_solvers.ransac._score_hypotheses(*j, jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
                                                 0.1, 300)
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_j))
