"""The cross-product normals and the range-image methods (FALS, SRI, the
curvature map) against plo_tpu's on the same numpy inputs, and the
FrontEnd on configs that use them; at 32 beams x 450 (capacity 16384).

Tolerances:
  * masks exactly (border rows and columns, empty pixels, degenerate M);
  * cross_product's normals within 1e-6 (the same f32 operations);
  * SRI's normals within 1e-6: Prewitt sums of ±1 times ranges add the
    same terms in the same order (rows outer, columns inner), and only the
    f32 cos of the vertical angles and the 3x3 product round differently;
  * FALS's normals to the line of plo_tpu's (the sign may flip where the
    normal lies in the horizontal plane) within 2 kappa eps, kappa the
    pixel's condition number of M (up to ~22,000 here) and eps f32's: n = M^-1 b,
    and M^-1 amplifies the f32 rounding of b and of the 3x3 product by
    kappa; plo_tpu's and the port's normals each lie that far from a
    float64 evaluation (up to 4e-4 at ws = 1);
  * the curvature map within 1e-6 of its largest value: |sum of neighbor
    differences|^2 from points rebuilt with each package's f32 cos / sin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.models import pipeline as jax_pipeline
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.ops import normals as jax_normals
from plo_tpu.ops import preprocess as jax_pre
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models import pipeline
from plo_tpu_torch.ops import normals, preprocess

from test_torch_odometry import JaxDraws
from test_torch_plane_icp import curvature_bound

N_SCANS, AZ_STEPS, CAPACITY = 32, 450, 16384
WIDTH = 450
EPS32 = float(np.finfo(np.float32).eps)
FALS_KAPPA = 2.5e4  # above the largest condition number of M on kept pixels at 32 x 450


def assert_same_lines(a, b, bound):
    """The unit vectors a and b (rows) span lines within `bound` radians."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    cos = np.abs((a * b).sum(-1)) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert (np.arccos(np.clip(cos, 0.0, 1.0)) <= bound).all()


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for this module (see tests/test_torch_headline.py),
    then one parallel sqrt on every thread (tests/test_torch_odometry.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def sensor(m):
    return m.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS)


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(2, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                            speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return scans


@pytest.fixture(scope="module")
def rings(scans):
    pts = np.zeros((CAPACITY, 4), np.float32)
    pts[:len(scans[0])] = scans[0]
    n = len(scans[0])
    rc_j = jax_pre.preprocess(jnp.asarray(pts), n, sensor(jax_cfg))
    rc_p = preprocess.preprocess(torch.from_numpy(pts), n, sensor(port_cfg))
    rng_img = np.array(jax_pre.rasterize_range_image(rc_j, N_SCANS, WIDTH)[0])
    return rc_j, rc_p, rng_img


@pytest.mark.parametrize("scan", ["kdtree", "index"])
def test_cross_product_matches_jax(rings, scan):
    rc_j, rc_p, _ = rings
    ref = jax_normals.compute_normals_cross_product(
        rc_j, jax_cfg.CrossProductConfig(neighbor_scan=scan))
    out = normals.compute_normals_cross_product(
        rc_p, port_cfg.CrossProductConfig(neighbor_scan=scan))
    valid = np.asarray(ref.cloud.valid)
    assert valid.sum() > 5000
    np.testing.assert_array_equal(out.cloud.valid.numpy(), valid)
    np.testing.assert_allclose(out.cloud.normal.numpy(), np.asarray(ref.cloud.normal), atol=1e-6)
    assert (out.cloud.normal.numpy()[valid][:, 2] >= 0).all()
    for f in ("curvature", "eigvals"):
        assert not getattr(out.cloud, f).any()
    assert not out.plane_fail.any() and not out.eigvecs.any()


def _engines(ws):
    fov_up, fov_down = pipeline._FOV[N_SCANS]
    assert pipeline._FOV == jax_pipeline._FOV
    return (jax_normals.RangeImageNormals(N_SCANS, WIDTH, fov_up, fov_down, ws),
            normals.RangeImageNormals(N_SCANS, WIDTH, fov_up, fov_down, ws, device="cpu"))


def _holes(rng_img, rng):
    """The range image with extra empty pixels, a whole empty row and
    column besides the scan's own holes."""
    img = rng_img.copy()
    img[rng.random(img.shape) < 0.1] = np.inf
    img[5] = np.inf
    img[:, 100] = np.inf
    return img


@pytest.mark.parametrize("ws", [3, 1])
def test_range_image_constants_match_jax(ws):
    ej, ep = _engines(ws)
    for f in ("azimuth", "vertical", "v", "m_inv", "rhat"):
        np.testing.assert_array_equal(getattr(ep, f).numpy(), np.asarray(getattr(ej, f)), f)


@pytest.mark.parametrize("ws", [3, 1])
@pytest.mark.parametrize("holes", [False, True], ids=["scan", "holes"])
def test_fals_matches_jax(rings, rng, ws, holes):
    img = _holes(rings[2], rng) if holes else rings[2]
    ej, ep = _engines(ws)
    n_j, ok_j = (np.asarray(x) for x in ej.fals(jnp.asarray(img)))
    n_p, ok_p = (x.numpy() for x in ep.fals(torch.from_numpy(img)))
    np.testing.assert_array_equal(ok_p, ok_j)
    assert ok_j.sum() > 8000 and not ok_j[np.isinf(img)].any()
    assert np.linalg.cond(ep.m_inv.numpy().astype(np.float64)[ok_j]).max() <= FALS_KAPPA
    kappa = np.linalg.cond(ep.m_inv.numpy().astype(np.float64)[ok_j])
    assert_same_lines(n_p[ok_j], n_j[ok_j], 2 * kappa * EPS32)


@pytest.mark.parametrize("ws", [3, 1])
@pytest.mark.parametrize("holes", [False, True], ids=["scan", "holes"])
def test_sri_matches_jax(rings, rng, ws, holes):
    img = _holes(rings[2], rng) if holes else rings[2]
    ej, ep = _engines(ws)
    n_j, ok_j = (np.asarray(x) for x in ej.sri(jnp.asarray(img)))
    n_p, ok_p = (x.numpy() for x in ep.sri(torch.from_numpy(img)))
    np.testing.assert_array_equal(ok_p, ok_j)
    assert ok_j.sum() > 8000 and not ok_j[np.isinf(img)].any()
    assert not ok_p[:ws].any() and not ok_p[-ws:].any()
    assert not ok_p[:, :ws].any() and not ok_p[:, -ws:].any()
    np.testing.assert_allclose(n_p[ok_j], n_j[ok_j], atol=1e-6)


@pytest.mark.parametrize("ws", [3, 1])
@pytest.mark.parametrize("holes", [False, True], ids=["scan", "holes"])
def test_curvature_map_matches_jax(rings, rng, ws, holes):
    img = _holes(rings[2], rng) if holes else rings[2]
    ej, ep = _engines(ws)
    c_j = np.asarray(ej.curvature_map(jnp.asarray(img)))
    c_p = ep.curvature_map(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(c_p == 0, c_j == 0)
    assert not c_p[:ws].any() and not c_p[:, -ws:].any() and not c_p[np.isinf(img)].any()
    assert (np.abs(c_p - c_j) <= 1e-6 * c_j.max()).all()
    c2_j = np.asarray(ej.curvature_map(jnp.asarray(img), window_size=2))
    c2_p = ep.curvature_map(torch.from_numpy(img), window_size=2).numpy()
    assert (np.abs(c2_p - c2_j) <= 1e-6 * c2_j.max()).all()


def frontend_config(m, name):
    """The shipped FALS config and its SRI and cross-product variants, in
    package `m`'s classes, at the test size; "grid16" runs FALS through the
    grid16 raster."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if name == "cross_product":
        cfg = m.load(os.path.join(root, "configs/aloam_kitti00.json"), sensor=sensor(m))
    else:
        cfg = m.load(os.path.join(root, "configs/drpm_range_image.json"), sensor=sensor(m))
    sr = cfg.scan_registration
    method = {"FALS": "FALS", "FALS-grid16": "FALS", "SRI": "SRI",
              "cross_product": "cross_product"}[name]
    if name == "FALS-grid16":   # grid16 cannot carry the ring curvature presample
        sr = dataclasses.replace(sr, presample_method=m.PresampleConfig(
            method="geometric_features"))
    return dataclasses.replace(cfg, scan_registration=dataclasses.replace(
        sr, compute_normal_method=dataclasses.replace(sr.compute_normal_method, method=method)))


def curvature_tolerance(scan, fe):
    """curvature_bound of each model-cloud point: per ring point, or on the
    range image per cell through the rasterizer's winning point."""
    if fe.presample_method != "curvature":
        return 0.0
    pts = np.zeros((CAPACITY, 4), np.float32)
    pts[:len(scan)] = scan
    rc = preprocess.preprocess(torch.from_numpy(pts), len(scan), sensor(port_cfg))
    bound = curvature_bound(rc.xyz.numpy(), int(rc.valid.sum()), 5)
    if fe.format == "range_image":
        src = preprocess.rasterize_range_image(rc, N_SCANS, WIDTH)[4]
        bound = bound[src.reshape(-1).numpy()]
    return bound


@pytest.mark.parametrize("name", ["FALS", "SRI", "cross_product", "FALS-grid16"])
def test_frontend_matches_jax(scans, name):
    """The FrontEnd on two frames with JAX's draws: stats, masks and the
    sampled points exactly; xyz and intensity within 1e-5 (grid16: plus two
    ulps of the unit ray times the range, as tests/test_torch_grid_frontend.
    py allows for the packages' f32 cos and sin of the beam table); normals
    as above (FALS to the line, with kappa its largest), but SRI's within
    1e-5: inside plo_tpu's front-end program the vertical angles are
    constants whose cos XLA folds at compile time; the model cloud's stage-1
    ring curvature within its f32 rounding bound (tests/test_torch_plane_icp.
    py::curvature_bound; the sampled cloud's is the same values at the
    sampled points)."""
    cfg_j = frontend_config(jax_cfg, name)
    cfg_p = config_from_dict(dataclasses.asdict(cfg_j))
    assert cfg_p == frontend_config(port_cfg, name)
    fe_j = jax_pipeline.FrontEnd(cfg_j, capacity=CAPACITY)
    fe_p = pipeline.FrontEnd(cfg_p, capacity=CAPACITY, device="cpu")
    packer = JaxOdometry(cfg_j, capacity=CAPACITY, transfer="grid16") if "grid16" in name else None
    ray_ulps = 2.5e-7 if packer is not None else 0.0
    last_j = last_p = None
    for i, scan in enumerate(scans):
        draws = JaxDraws(0, i)
        scores = draws.frontend(fe_p.n_draws(i == 0), fe_p.filtered_capacity)
        if packer is not None:
            grid = packer._pack_grid(scan)
            out_j = fe_j.process_grid(grid, draws.fe_key, first_frame=i == 0, last_filtered=last_j)
            out_p = fe_p.process_grid(grid, scores, last_p, first_frame=i == 0)
        else:
            out_j = fe_j.process(scan, draws.fe_key, last_j, first_frame=i == 0)
            out_p = fe_p.process(scan, scores, last_p, first_frame=i == 0)
        for k in pipeline.STATS_KEYS:
            assert int(out_p.stats[k]) == int(out_j.stats[k]), k
        # FALS leaves no eigenvalues, so grid16's geometric presample finds no
        # candidate (in plo_tpu too): that entry holds the filtered cloud only.
        assert int(out_j.stats["n_sampled"]) > (-1 if packer is not None else 500)
        for cj, cp in ((out_j.filtered, out_p.filtered), (out_j.flat, out_p.flat)):
            valid = np.asarray(cj.valid)
            np.testing.assert_array_equal(cp.valid.numpy(), valid)
            xyz_j = np.asarray(cj.xyz)
            tol = 1e-5 + ray_ulps * np.linalg.norm(xyz_j, axis=1, keepdims=True)
            assert (np.abs(cp.xyz.numpy() - xyz_j) <= tol).all()
            np.testing.assert_allclose(cp.intensity.numpy(), np.asarray(cj.intensity), atol=1e-5)
            n_p, n_j = cp.normal.numpy()[valid], np.asarray(cj.normal)[valid]
            if name.startswith("FALS"):
                assert_same_lines(n_p, n_j, 2 * FALS_KAPPA * EPS32)
            else:
                np.testing.assert_allclose(n_p, n_j, atol=1e-5 if name == "SRI" else 1e-6)
        assert (np.abs(out_p.filtered.curvature.numpy() - np.asarray(out_j.filtered.curvature))
                <= curvature_tolerance(scan, fe_p)).all()
        last_j, last_p = out_j.filtered, out_p.filtered


@pytest.mark.parametrize("method", ["FALS", "SRI", "cross_product"])
def test_tensor_voting_needs_pca_normals(method):
    """The guard of plo_tpu/models/pipeline.py:64-73, with its text."""
    fmt = "pointcloud" if method == "cross_product" else "range_image"

    def cfg(m):
        return m.Config(scan_registration=m.ScanRegistrationConfig(
            compute_normal_method=m.ComputeNormalConfig(format=fmt, method=method),
            presample_method=m.PresampleConfig(method="tensor_voting")), sensor=sensor(m))

    with pytest.raises(ValueError) as ref:
        jax_pipeline.FrontEnd(cfg(jax_cfg), capacity=CAPACITY)
    with pytest.raises(ValueError) as err:
        pipeline.FrontEnd(cfg(port_cfg), capacity=CAPACITY, device="cpu")
    assert str(err.value) == str(ref.value)
