"""Tensor voting against plo_tpu/ops/tensor_voting.py on the same numpy
inputs: the aware-tensor encoding, the ball removal, the vote kernel,
cast_votes, the decomposition, the saliency presample (with its descriptor
block), VoteForAny and the anchor-normal override of IMLS; then the
tensor-voting pipeline end to end against plo_tpu's, at the setting of
tests/test_tensor_voting.py::test_tensor_voting_pipeline_e2e (32 beams x 360,
k = 20, 2 frames).

Tolerances: tensors to 1e-5 of their scale (3x3 products and sums that XLA
contracts into FMAs). Eigenvalues of the closed-form eigh within the bound
of tests/test_torch_ops.py::test_pca_normals_match_jax, sqrt(eps) l1 (its
arccos turns a rounding difference into up to that much near coincident
eigenvalues): the ball removal's diagonal, and the saliencies at two or
four times the bound (one or two eigh's on the way); voted normals within
that bound over their gap. Validity exactly; labels and candidates exactly
except where two saliencies lie within the bound of each other (there the
label follows the rounding): < 1 % of points, and in the pipeline test a
candidate count within 0.1 % of JAX's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws
from test_torch_ops import _match_inputs, frames, scans, t  # noqa: F401
from test_torch_sampling_c import torch_cpu  # noqa: F401

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.ops import matching as jax_matching
from plo_tpu.ops import tensor_voting as jax_tv
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import matching
from plo_tpu_torch.ops import tensor_voting as tv

ROOT_EPS = float(np.sqrt(np.finfo(np.float32).eps))


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module: the suite runs on 6 pytest workers
    side by side (tests/test_torch_headline.py says what a full pool a
    worker costs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _to_port(cloud):
    return PointCloud(**{f.name: t(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)})


@pytest.fixture(scope="module")
def pca(frames):
    """plo_tpu's exact-kd PCA of the first corridor scan (the tensor-voting
    presample's input), as both packages' clouds."""
    from plo_tpu.ops import normals as jax_normals
    nr = jax_normals.compute_normals_pca(frames[0][0], jax_cfg.PCAConfig(), True, exact_kd=True)
    return nr.cloud, nr.eigvecs, _to_port(nr.cloud), t(nr.eigvecs)


def _rel_close(a, b, rtol=1e-5):
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, atol=rtol * scale)


def _eig_bound(lam1):
    """The closed-form eigh's rounding bound (test_pca_normals_match_jax):
    an eigenvalue moves by up to sqrt(eps) l1 near coincident eigenvalues."""
    return 1e-6 + ROOT_EPS * np.abs(lam1)


def test_encode_and_remove_ball_match_jax(pca):
    """The encoding to 1e-5 of its scale; the ball removal subtracts the
    smallest eigenvalue from the diagonal, so its diagonal is held to the
    eigenvalue bound and the rest exactly as the encoding."""
    cj, ej, cp, ep = pca
    ev = np.array(cj.eigvals)
    ev[:5] = np.nan   # non-finite eigen-data: the unit-ball fallback
    tj = np.asarray(jax_tv.encode_aware_tensors(jnp.asarray(ev), ej, 20.0))
    tp = tv.encode_aware_tensors(t(ev), ep, 20.0)
    _rel_close(tp.numpy(), tj)
    np.testing.assert_array_equal(tp[:5].numpy(), np.tile(np.eye(3, dtype=np.float32), (5, 1, 1)))
    bj = np.asarray(jax_tv.remove_ball_component(jnp.asarray(tj)))
    bp = tv.remove_ball_component(t(tj)).numpy()
    off = ~np.eye(3, dtype=bool)
    np.testing.assert_array_equal(bp[:, off], bj[:, off])
    lam1 = np.abs(np.linalg.eigvalsh(tj.astype(np.float64))).max(1)
    diag = np.abs(np.diagonal(bp, axis1=1, axis2=2) - np.diagonal(bj, axis1=1, axis2=2))
    assert (diag <= _eig_bound(lam1)[:, None]).all()


def test_vote_kernel_matches_jax(rng):
    r = rng.normal(size=(64, 20, 3)).astype(np.float32) * 0.2
    r[0, 0] = 0.0    # a zero offset: the normalization's clamp
    n = rng.normal(size=(64, 20, 3)).astype(np.float32)
    T = np.einsum("...i,...j->...ij", n, n).astype(np.float32)
    vj = jax_tv._vote_kernel(jnp.asarray(r), jnp.asarray(T), 0.2)
    vp = tv._vote_kernel(t(r), t(T), 0.2)
    _rel_close(vp.numpy(), np.asarray(vj))


def _near_tie(coeff_j, bound):
    """Points whose two largest of (pointness, curveness, surfaceness) lie
    within `bound` of each other: there the label follows the rounding."""
    srt = np.sort(coeff_j, axis=0)
    return srt[2] - srt[1] <= bound


def test_cast_votes_and_decompose_match_jax(pca):
    """The votes from the same tensors to 1e-5 of each point's largest
    eigenvalue, and their decomposition: saliencies within twice the
    eigenvalue bound, labels exactly away from near-ties."""
    cj, _, cp, _ = pca
    T = jax_tv.remove_ball_component(jax_tv.encode_aware_tensors(cj.eigvals, pca[1], 20.0))
    vj, rj = jax_tv.cast_votes(cj.xyz, cj.valid, cj.xyz, cj.valid, T, 20, 0.2)
    vp, rp = tv.cast_votes(cp.xyz, cp.valid, cp.xyz, cp.valid, t(T), 20, 0.2)
    v = np.asarray(rj)
    np.testing.assert_array_equal(rp.numpy(), v)
    vj = np.asarray(vj)
    lam1 = np.abs(np.linalg.eigvalsh(vj.astype(np.float64))).max(1)
    assert (np.abs(vp.numpy() - vj).max((1, 2)) <= 1e-5 * lam1 + 1e-9)[v].all()
    dj = jax_tv.decompose(jnp.asarray(vj))
    dp = tv.decompose(t(vj))
    bound = 2 * _eig_bound(lam1)
    for a, b in zip(dp[:3], dj[:3]):
        assert (np.abs(a.numpy() - np.asarray(b)) <= bound)[v].all()
    tie = _near_tie(np.stack([np.asarray(x) for x in (dj[2], dj[1], dj[0])]), 2 * bound)
    np.testing.assert_array_equal(dp[4].numpy()[v & ~tie], np.asarray(dj[4])[v & ~tie])
    assert (v & ~tie).sum() > 3000


def test_saliency_presample_matches_jax(pca):
    """The presample on a PCA'd corridor scan: validity exactly; labels and
    candidates exactly away from near-ties (the saliencies carry the
    eigenvalue bound of both the ball removal and the decomposition); the
    voted +z normals within the conditioning bound; curvature
    (= surfaceness) and the 22-row descriptor block."""
    cj, ej, cp, ep = pca
    rj = jax_tv.saliency_presample(cj, ej, jax_cfg.TensorVotingConfig(k=20, sigma=0.2))
    rp = tv.saliency_presample(cp, ep, port_cfg.TensorVotingConfig(k=20, sigma=0.2))
    v = np.asarray(rj.cloud.valid)
    assert v.sum() > 3000
    np.testing.assert_array_equal(rp.cloud.valid.numpy(), v)
    s, c, p = (np.asarray(x) for x in (rj.surfaceness, rj.curveness, rj.pointness))
    lam1 = np.abs(s + c + p)
    bound = 4 * _eig_bound(lam1)
    for a, b in zip((rp.surfaceness, rp.curveness, rp.pointness), (s, c, p)):
        assert (np.abs(a.numpy() - b) <= bound)[v].all()
    ok = v & ~_near_tie(np.stack([p, c, s]), 2 * bound)
    assert ok.sum() > 0.99 * v.sum()
    np.testing.assert_array_equal(rp.labels.numpy()[ok], np.asarray(rj.labels)[ok])
    np.testing.assert_array_equal(rp.candidates.numpy()[ok], np.asarray(rj.candidates)[ok])
    assert not rp.candidates.numpy()[~v].any()
    # The voted normal is the max eigenvector: its error is the bound over
    # the gap l1 - l2 (= surfaceness).
    cos = (rp.cloud.normal.numpy() * np.asarray(rj.cloud.normal)).sum(1)[v]
    angle = np.arccos(np.clip(np.abs(cos), 0.0, 1.0))
    assert (angle <= 1e-4 + 2 * bound[v] / np.maximum(s[v], 1e-30)).all()
    assert (cos > 0).mean() > 0.999   # the same +z hemisphere (n_z ~ 0 aside)
    assert (np.abs(rp.cloud.curvature.numpy() - np.asarray(rj.cloud.curvature)) <= bound).all()
    dp, dj = rp.descriptors().numpy(), np.asarray(rj.descriptors())
    assert dp.shape == dj.shape == (22, v.shape[0])
    np.testing.assert_array_equal(dp[9], rp.labels.numpy().astype(np.float32))
    assert (np.abs(dp[:3] - dj[:3]) <= bound).all()


def test_cast_votes_blocks_match_one_pass(pca, monkeypatch):
    """cast_votes searches and votes in blocks of at most VOTE_BLOCK queries
    (its [Q, k, 3, 3] tensors stay small on a capacity-sized cloud), and the
    blocks give what one pass gives."""
    _, _, cp, ep = pca
    T = tv.remove_ball_component(tv.encode_aware_tensors(cp.eigvals, ep, 20.0))
    q, qv = cp.xyz[:3500], cp.valid[:3500]
    one = tv.cast_votes(q, qv, cp.xyz, cp.valid, T, 20, 0.2)
    monkeypatch.setattr(tv, "VOTE_BLOCK", 1000)
    sizes = []
    knn = tv.neighbors.knn
    monkeypatch.setattr(tv.neighbors, "knn",
                        lambda query, *a, **k: sizes.append(len(query)) or knn(query, *a, **k))
    blocks = tv.cast_votes(q, qv, cp.xyz, cp.valid, T, 20, 0.2)
    assert sizes == [1000, 1000, 1000, 500]
    for a, b in zip(one, blocks):
        assert torch.equal(a, b)


def test_vote_for_any_and_anchor_override_match_jax(frames):
    """VoteForAny from a target onto moved source points, and IMLS with the
    source point's voted normal as the anchor normal (matching.py:175-181)."""
    src_j, tgt_j, src_p, tgt_p = _match_inputs(frames)
    cfg_j = jax_cfg.IMLSTensorVotingConfig(enabled=True, k=20, sigma=0.2,
                                           distance_threshold=10.0)
    cfg_p = port_cfg.IMLSTensorVotingConfig(enabled=True, k=20, sigma=0.2,
                                            distance_threshold=10.0)
    nj, okj = jax_tv.vote_for_any(tgt_j.xyz, tgt_j.valid, tgt_j.normal, src_j.xyz,
                                  src_j.valid, cfg_j)
    np_, okp = tv.vote_for_any(tgt_p.xyz, tgt_p.valid, tgt_p.normal, src_p.xyz,
                               src_p.valid, cfg_p)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert okp.sum() > 1000
    cos = (np_.numpy() * np.asarray(nj)).sum(1)[okp.numpy()]
    assert (cos > 1 - 1e-4).mean() > 0.99 and (cos > 0.9).all()
    # The override itself on the same anchor normals (JAX's).
    anchor = np.asarray(nj)
    icfg_j = jax_cfg.IMLSConfig(get_normals=jax_cfg.GetNormalsConfig(enabled=False),
                                use_tensor_voting=cfg_j)
    icfg_p = port_cfg.IMLSConfig(get_normals=port_cfg.GetNormalsConfig(enabled=False),
                                 use_tensor_voting=cfg_p)
    rj = jax_matching.imls_project(src_j, tgt_j, icfg_j, anchor_normal_src=jnp.asarray(anchor),
                                   anchor_ok_src=okj, knn_select="exact")
    rp = matching.imls_project(src_p, tgt_p, icfg_p, anchor_normal_src=t(anchor),
                               anchor_ok_src=t(okj))
    np.testing.assert_array_equal(rp.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_allclose(rp.y.numpy(), np.asarray(rj.y), atol=1e-4)
    np.testing.assert_array_equal(rp.normal.numpy(), np.asarray(rj.normal))
    for k, v in rj.counters.items():
        assert int(rp.counters[k]) == int(v), k
    assert int(rp.valid.sum()) > 100


def _tv_config(mod):
    """tests/test_tensor_voting.py::test_tensor_voting_pipeline_e2e's config."""
    return mod.Config(
        scan_registration=mod.ScanRegistrationConfig(
            presample_method=mod.PresampleConfig(
                method="tensor_voting", tensor_voting=mod.TensorVotingConfig(k=20, sigma=0.2)),
            sample_method=mod.SampleConfig(
                method="random", random=mod.RandomSampleConfig(max_points=1500))),
        laser_odometry=mod.LaserOdometryConfig(
            matching_method=mod.MatchingConfig(method="IMLS", imls=mod.IMLSConfig(
                get_normals=mod.GetNormalsConfig(enabled=False),
                use_tensor_voting=mod.IMLSTensorVotingConfig(
                    enabled=True, k=20, sigma=0.2, distance_threshold=10.0))),
            solve_method=mod.SolveConfig(method="LS", iterations=20)),
        sensor=mod.SensorConfig(n_scans=32, azimuth_resolution=1.0))


def test_tensor_voting_pipeline_matches_jax():
    """The tensor-voting pipeline (exact-kd PCA, saliency presample, random
    sampling, IMLS with VoteForAny anchors, LS) end to end on JAX's draws,
    2 frames: the front-end's counts exactly (candidates within 0.1 %:
    near-tie labels), the same correspondences, the pose within 2 mm /
    1e-4 rad. One ICP iteration a frame: this path keeps ~8 correspondences
    (the reference's voted anchor is the stick, a tangent, so the 30-degree
    gate against the neighbors' normals rejects most points; the reference
    marks the path broken), and an LS solve on 8 points amplifies f32
    rounding about a thousandfold an iteration — at 2 iterations the two
    trajectories part by 1 cm, at 3 by metres, both far from the ground truth.
    (chip_smoke.py's phase C3 runs the shipped configs/tensor_voting_vlp32.json
    at full width on the card, held to finite poses and correspondences > 0,
    as tests/test_tensor_voting.py::test_tensor_voting_pipeline_e2e holds
    plo_tpu.)"""
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(2, n_scans=32, azimuth_steps=360, speed=0.4,
                                            seed=5, world=world)
    cfg = _tv_config(jax_cfg)
    one = dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, solve_method=dataclasses.replace(cfg.laser_odometry.solve_method,
                                                             iterations=1)))
    jo = JaxOdometry(one, capacity=12288, seed=0, transfer="float32")
    po = Odometry(config_from_dict(dataclasses.asdict(one)), capacity=12288, device="cpu")
    for k, s in enumerate(scans):
        fj, fp = jo.process_scan(s), po.process_scan(s, draws=JaxDraws(0, k))
        for key in ("n_preprocessed", "n_filtered", "n_sampled"):
            assert fp.stats[key] == fj.stats[key], key
        assert abs(fp.stats["n_candidates"] - fj.stats["n_candidates"]) <= max(
            2, 1e-3 * fj.stats["n_candidates"])
        assert fp.n_correspondences == fj.n_correspondences
        np.testing.assert_allclose(fp.pose[:3, 3], fj.pose[:3, 3], atol=2e-3)
        np.testing.assert_allclose(fp.pose[:3, :3], fj.pose[:3, :3], atol=1e-4)
    assert fp.n_correspondences > 0
