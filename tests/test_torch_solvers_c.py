"""Slice C's solvers and matching modes against plo_tpu: the closed-form
Umeyama alignment, point-to-point ICP, Teaser (TIM k-core, scale estimate,
GNC_TLS / FGR / QUATRO, the cost-threshold stop), the solver checks of the
odometry with plo_tpu's texts, projected-distance IMLS, and that projected
and tensor-voting IMLS search on every iteration (their end-to-end runs are
in tests/test_torch_matrix.py).

Tolerances:
  * Umeyama: R within 1e-5 and t within 1e-4 of jnp.linalg.svd's (f32 SVD
    error ~ eps s1 / (s2 - s3), up to ~3e-6 on these sets; the port's
    closed form works in float64); where the rotation is not unique (rank-1
    H) only a proper rotation that aligns the set is required.
  * ICP and Teaser solves: the 4x4 within 1e-5 (the alignments' f32
    differences through the loops).
  * k-core masks, scale-estimate pairs and projected-IMLS masks exactly."""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops import _assert_match_equal, _match_inputs, frames, scans, t  # noqa: F401
from test_torch_sampling_c import torch_cpu  # noqa: F401

from plo_tpu import config as jax_cfg
from plo_tpu import geometry as jax_geo
from plo_tpu.models.odometry import _build_match_solve
from plo_tpu.ops import matching as jax_matching
from plo_tpu.solvers import gnc as jax_gnc
from plo_tpu.solvers import icp_umeyama as jax_icp
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import matching, neighbors, tensor_voting
from plo_tpu_torch.solvers import gnc, icp_umeyama


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _rot(w):
    return np.asarray(jax_geo.exp_so3(jnp.asarray(np.asarray(w, np.float64)[None])))[0]


@pytest.mark.parametrize("case", ["general", "weighted", "coplanar", "mirror", "icp-like"])
def test_umeyama_matches_jax_svd(rng, case):
    n = 2000 if case == "icp-like" else 300
    s = (rng.random((n, 3)) * 20).astype(np.float32)
    w = np.ones(n, np.float32)
    d = s @ _rot([0.05, -0.03, 0.2]).T + np.array([1.0, -0.5, 0.2])
    if case == "weighted":
        w = rng.random(n).astype(np.float32)
        d = d + rng.normal(size=d.shape) * 0.05
    if case == "coplanar":
        s[:, 2] = 0.0
        d = s @ _rot([0.05, -0.03, 0.2]).T + 1.0
    if case == "mirror":   # the best proper rotation of a reflection: the det fix
        d = s.astype(np.float64).copy()
        d[:, 0] *= -1
    if case == "icp-like":
        s = s * 3 - 30
        d = s + rng.normal(size=s.shape) * 0.01
    d = d.astype(np.float32)
    Rj, tj = jax_icp.umeyama(jnp.asarray(s), jnp.asarray(d), jnp.asarray(w))
    Rp, tp = icp_umeyama.umeyama(t(s), t(d), t(w))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-4)
    assert abs(np.linalg.det(Rp.numpy().astype(np.float64)) - 1.0) < 1e-5


@pytest.mark.parametrize("case", ["collinear", "zero"])
def test_umeyama_degenerate_is_a_rotation(rng, case):
    """Rank-1 and zero cross-covariances have no unique rotation (plo_tpu's
    SVD returns whichever its LAPACK finds): the port returns a proper
    rotation that still aligns the set, and the identity for H = 0."""
    if case == "zero":
        R = icp_umeyama.kabsch_rotation(torch.zeros(3, 3))
        np.testing.assert_array_equal(R.numpy(), np.eye(3, dtype=np.float32))
        return
    s = np.zeros((300, 3), np.float32)
    s[:, 0] = rng.random(300) * 10
    d = (s @ _rot([0.1, 0.2, 0.3]).T).astype(np.float32)
    R, tr = icp_umeyama.umeyama(t(s), t(d), torch.ones(300))
    R = R.numpy().astype(np.float64)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert abs(np.linalg.det(R) - 1.0) < 1e-6
    np.testing.assert_allclose(s @ R.T + tr.numpy(), d, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_icp_point_to_point_matches_jax(rng, masked):
    s = (rng.random((300, 3)) * 20).astype(np.float32)
    d = (s @ _rot([0.0, 0.0, 0.02]).T + np.array([0.1, -0.05, 0.02])).astype(np.float32)
    valid = rng.random(300) > 0.3 if masked else np.ones(300, bool)
    Tj, okj = jax_icp.solve_icp_point_to_point(jnp.asarray(s), jnp.asarray(d),
                                               jnp.asarray(valid), max_iterations=10)
    Tp, okp = icp_umeyama.solve_icp_point_to_point(t(s), t(d), t(valid), max_iterations=10)
    assert bool(okp) == bool(okj) and bool(okp)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)


def _structured(seed=0, n=220):
    """tests/test_solvers.py's k-core problem: 45 % coherently shifted
    outliers."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    ref = (src @ _rot([0.03, -0.02, 0.3]).T + np.array([0.8, -0.4, 0.2])
           + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    ref[:n * 45 // 100] += np.array([3.0, 1.5, -2.0], np.float32)
    return src, ref


def test_kcore_matches_jax():
    src, ref = _structured()
    valid = np.ones(len(src), bool)
    valid[::17] = False
    cj = jax_gnc._consistency_kcore(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(valid), 0.05)
    cp = gnc._consistency_kcore(t(src), t(ref), t(valid), 0.05)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    assert 50 < cp.sum() < valid.sum()


def test_torch_sort_puts_nans_last():
    """_estimate_scale takes a masked median by sorting NaNs to the end, as
    jnp.sort does."""
    x = torch.tensor([3.0, math.nan, -1.0, math.nan, 2.0])
    out = torch.sort(x).values
    assert out[:3].tolist() == [-1.0, 2.0, 3.0] and torch.isnan(out[3:]).all()


def _scale_pairs(key, n):
    ka, kb = jax.random.split(key)
    return tuple(t(jax.random.randint(k, (1024,), 0, n)).long() for k in (ka, kb))


def test_estimate_scale_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    ref = (1.35 * src @ _rot([0, 0, 0.2]).T + 0.5).astype(np.float32)
    valid = rng.random(300) > 0.2
    key = jax.random.PRNGKey(4)
    sj = jax_gnc._estimate_scale(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(valid), key)
    sp = gnc._estimate_scale(t(src), t(ref), t(valid), _scale_pairs(key, 300))
    np.testing.assert_allclose(float(sp), float(sj), rtol=1e-6)
    assert abs(float(sp) - 1.35) < 1e-3


def test_umeyama_yaw_matches_jax(rng):
    s = rng.uniform(-10, 10, (400, 3)).astype(np.float32)
    r = (s @ _rot([0, 0, 0.25]).T + np.array([0.6, -0.3, 0.15])).astype(np.float32)
    w = rng.random(400).astype(np.float32)
    Rj, tj = jax_gnc._umeyama_yaw(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w))
    Rp, tp = gnc._umeyama_yaw(t(s), t(r), t(w))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-5)


@pytest.mark.parametrize("algorithm", ["GNC_TLS", "FGR", "QUATRO"])
@pytest.mark.parametrize("cost_threshold", [0.0, 0.005])
def test_teaser_matches_jax(algorithm, cost_threshold):
    """The whole Teaser solve on the structured-outlier problem with the
    k-core on, and (GNC_TLS) the scale estimate on JAX's pairs."""
    src, ref = _structured()
    scaling = algorithm == "GNC_TLS"
    if scaling:
        ref = ref * np.float32(1.2)
    kw = dict(noise_bound=0.05, max_iterations=64, use_max_clique=True,
              kcore_min_fraction=0.3, estimate_scaling=scaling, algorithm=algorithm,
              cost_threshold=cost_threshold)
    key = jax.random.PRNGKey(2)
    valid = np.ones(len(src), bool)
    Tj, okj = jax_gnc.solve_gnc_tls(jnp.asarray(src), jnp.asarray(ref), jnp.asarray(valid),
                                    key=key, **kw)
    Tp, okp = gnc.solve_gnc_tls(t(src), t(ref), t(valid),
                                pairs=_scale_pairs(key, len(src)) if scaling else None, **kw)
    assert bool(okp) and bool(okj)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-5)


def test_solvers_make_no_host_sync(monkeypatch):
    """The ICP and Teaser solves run without a host sync: no SVD (which
    synchronizes on CUDA; Umeyama's rotation is a closed form) and no tensor
    read back to the host — Teaser's cost-threshold stop is predicated, not a
    Python break on a synced flag. Every read-back raises here."""
    def refuse(*a, **k):
        raise AssertionError("host sync in a solver")
    for name in ("__bool__", "item", "tolist", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.linalg, "svd", refuse)
    src, ref = _structured()
    args = (t(src), t(ref), torch.ones(len(src), dtype=torch.bool))
    icp_umeyama.solve_icp_point_to_point(*args, 5)
    pairs = tuple(torch.randint(0, len(src), (1024,)) for _ in range(2))
    for algorithm in ("GNC_TLS", "FGR", "QUATRO"):
        gnc.solve_gnc_tls(*args, noise_bound=0.05, use_max_clique=True,
                          kcore_min_fraction=0.3, estimate_scaling=True, pairs=pairs,
                          algorithm=algorithm, cost_threshold=0.005)


def test_teaser_cost_threshold_freezes_the_state():
    """The cost-threshold stop is a predicated fixed-count loop: once the
    cost converges at iteration k*, the result is that of k* iterations
    without the threshold, bit for bit, and later iterations change
    nothing."""
    src, ref = _structured(3)
    kw = dict(noise_bound=0.05, use_max_clique=False)
    args = (t(src), t(ref), torch.ones(len(src), dtype=torch.bool))
    full, _ = gnc.solve_gnc_tls(*args, max_iterations=64, cost_threshold=0.005, **kw)
    k_star = next(k for k in range(1, 65) if torch.equal(
        gnc.solve_gnc_tls(*args, max_iterations=k, cost_threshold=0.005, **kw)[0], full))
    assert k_star < 64
    fixed, _ = gnc.solve_gnc_tls(*args, max_iterations=k_star, cost_threshold=0.0, **kw)
    assert torch.equal(fixed, full)
    longer, _ = gnc.solve_gnc_tls(*args, max_iterations=k_star + 1, cost_threshold=0.0, **kw)
    assert not torch.equal(longer, full)


def _solve_cfg(mod, sv):
    return mod.Config(laser_odometry=mod.LaserOdometryConfig(solve_method=sv))


@pytest.mark.parametrize("case", ["icp-cap", "teaser-cap", "teaser-threshold", "bad-algorithm"])
def test_solver_checks_match_jax(case):
    """The iteration-cap warnings and Teaser's algorithm check, with
    plo_tpu's texts (tests/test_solvers.py::test_iteration_cap_warnings)."""
    def sv(mod):
        return {"icp-cap": lambda: mod.SolveConfig(
                    method="ICP", icp=mod.ICPSolverConfig(max_iterations=1000)),
                "teaser-cap": lambda: mod.SolveConfig(method="Teaser", teaser=mod.TeaserConfig(
                    rotation_max_iterations=1000, rotation_cost_threshold=0.0)),
                "teaser-threshold": lambda: mod.SolveConfig(
                    method="Teaser", teaser=mod.TeaserConfig(
                        rotation_max_iterations=1000, rotation_cost_threshold=0.005)),
                "bad-algorithm": lambda: mod.SolveConfig(method="Teaser", teaser=mod.TeaserConfig(
                    rotation_estimation_algorithm="NOPE"))}[case]()

    if case == "bad-algorithm":
        with pytest.raises(ValueError) as ej:
            _build_match_solve(_solve_cfg(jax_cfg, sv(jax_cfg)))
        with pytest.raises(ValueError) as ep:
            Odometry(_solve_cfg(port_cfg, sv(port_cfg)), capacity=1024, device="cpu")
        assert str(ep.value) == str(ej.value) and "rotation_estimation_algorithm" in str(ep.value)
        return
    texts = []
    for build in (lambda: _build_match_solve(_solve_cfg(jax_cfg, sv(jax_cfg))),
                  lambda: Odometry(_solve_cfg(port_cfg, sv(port_cfg)), capacity=1024,
                                   device="cpu")):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            build()
        texts.append(sorted(str(r.message) for r in rec if r.category is RuntimeWarning
                            and "capped" in str(r.message)))
    assert texts[0] == texts[1]
    assert len(texts[1]) == (0 if case == "teaser-threshold" else 1)


def test_projected_imls_matches_jax(frames):
    """Projected-distance IMLS (matching.py:163-170): the anchor from
    projected_argmin, the neighborhood from projected_knn, both under
    |d| < r_proj and proj < r, the squared projected distances as the
    bandwidth's sorted distances."""
    src_j, tgt_j, src_p, tgt_p = _match_inputs(frames)
    cfg_j, cfg_p = (mod.IMLSConfig(use_projected_distance=mod.ProjectedDistanceConfig(
        enabled=True)) for mod in (jax_cfg, port_cfg))
    rj = jax_matching.imls_project(src_j, tgt_j, cfg_j)
    rp = matching.imls_project(src_p, tgt_p, cfg_p)
    _assert_match_equal(rp, rj)


def test_projected_and_voting_imls_search_every_iteration(monkeypatch):
    """Projected and tensor-voting IMLS re-search the target on every ICP
    iteration, whatever refresh_correspondences says (plo_tpu/models/
    odometry.py:73-76, 236-243): no frozen or cached correspondences."""
    calls = {"imls_search": 0, "imls_project_cached": 0, "projected_knn": 0, "vote_for_any": 0}
    for mod, name in ((matching, "imls_search"), (matching, "imls_project_cached"),
                      (neighbors, "projected_knn"), (tensor_voting, "vote_for_any")):
        def counted(*a, _f=getattr(mod, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(2, n_scans=16, azimuth_steps=300, speed=0.4,
                                            seed=3, world=world)
    c = port_cfg
    sensor = c.SensorConfig(n_scans=16, azimuth_resolution=360.0 / 300)
    for refresh in (False, True):
        for imls in (c.IMLSConfig(use_projected_distance=c.ProjectedDistanceConfig(enabled=True)),
                     c.IMLSConfig(get_normals=c.GetNormalsConfig(enabled=False),
                                  use_tensor_voting=c.IMLSTensorVotingConfig(
                                      enabled=True, k=10, distance_threshold=10.0))):
            for k in calls:
                calls[k] = 0
            cfg = c.Config(sensor=sensor, laser_odometry=c.LaserOdometryConfig(
                motion_prior=False, refresh_correspondences=refresh,
                matching_method=c.MatchingConfig(imls=imls),
                solve_method=c.SolveConfig(method="LS", iterations=2)))
            odo = Odometry(cfg, capacity=8192, device="cpu")
            iters = [odo.process_scan(s).iterations for s in scans][1]
            assert iters >= 1
            assert calls["imls_search"] == 0 and calls["imls_project_cached"] == 0
            voting = imls.use_tensor_voting.enabled
            assert calls["vote_for_any"] == (iters if voting else 0)
            assert calls["projected_knn"] == (0 if voting else iters)
