"""The range-image front-end of the port against plo_tpu's, on the same
inputs: the ring elevation table, the arrival-order preprocess and the
rasterizer, the host packers of the int16 and grid16 transfers, the
grid-stencil PCA, the front-end's grid paths, and the frozen-IMLS ICP loop.

Sizes: synthetic 32-beam x 450 scans of the corridor world (capacity 16384).
Tolerances: masks, indices, counts and the rasterized grids exactly. The
grid PCA's eigen-data are held as tests/test_torch_ops.py's pointcloud PCA
test holds them: the f32 moment sums are added in the JAX package's order,
but XLA contracts products and sums into FMAs inside its fused kernels, and
the closed-form eigh turns such a rounding difference into an eigenvalue
error of up to sqrt(eps) * lambda1 and an eigenvector error of that over the
eigen-gap (normals differ by up to ~1e-4 in cells whose gap is ~500x below
lambda1). Other floats within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu import native as jax_native
from plo_tpu.models import pipeline as jax_pipeline
from plo_tpu.models.odometry import Odometry as JaxOdometry, _make_icp_step
from plo_tpu.ops import normals as jax_normals, preprocess as jax_pre
from plo_tpu_torch import config as port_cfg, native
from plo_tpu_torch.convert import cloud_from_numpy, config_from_dict
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models import pipeline
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import normals, preprocess

from test_torch_odometry import JaxDraws, cloud_arrays

N_SCANS, AZ_STEPS, CAPACITY = 32, 450, 16384
ROOT_EPS = np.sqrt(np.finfo(np.float32).eps)


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    """Two torch threads for this module, restored after it: the suite runs
    six pytest workers on the host's cores, and a worker's full set of
    OpenMP threads on these small tensors spends its time waiting for the
    other workers' threads. Then one parallel sqrt on every thread (see
    tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def headline(m, **lo):
    """bench.py's config at the test size, in package `m`'s classes."""
    return m.Config(
        scan_registration=m.ScanRegistrationConfig(
            compute_normal_method=m.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=m.PresampleConfig(method="geometric_features"),
            sample_method=m.SampleConfig(method="random",
                                         random=m.RandomSampleConfig(max_points=2000))),
        laser_odometry=m.LaserOdometryConfig(
            refresh_correspondences=False, matching_method=m.MatchingConfig(method="IMLS"),
            solve_method=m.SolveConfig(method="RANSAC", iterations=30, ransac=m.RANSACConfig(
                max_iterations=1000, distance_threshold=0.2, final_solve_method="DRPM")),
            **lo),
        sensor=m.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


@pytest.fixture(scope="module")
def scans():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(2, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                            speed=0.5, yaw_rate=0.01, seed=3, world=world)
    return scans


def padded(scan, quantized):
    """[CAPACITY, 4] f32 scan; quantized: xyz through the int16 transfer."""
    pts = np.zeros((CAPACITY, 4), np.float32)
    pts[:len(scan)] = scan
    if quantized:
        q = np.zeros((CAPACITY, 3), np.int16)
        native.quantize_pack(scan, 1.0 / Odometry.TRANSFER_QUANT_SCALE, q)
        pts[:, :3] = q.astype(np.float32) * np.float32(Odometry.TRANSFER_QUANT_SCALE)
    return pts, len(scan)


def ring_cloud_to_torch(rc):
    arrays = {f.name: np.array(getattr(rc, f.name)) for f in dataclasses.fields(rc)}
    return preprocess.RingCloud(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                                       else v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def grids(scans):
    """JAX's arrival-order preprocess and raster of each scan, raw and
    int16-quantized, with the port's of the same inputs."""
    out = []
    for scan in scans:
        for quantized in (False, True):
            pts, n = padded(scan, quantized)
            rc_j = jax_pre.preprocess(jnp.asarray(pts), n, jax_cfg.SensorConfig(
                n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS), sort=False)
            rc_p = preprocess.preprocess(torch.from_numpy(pts), n, port_cfg.SensorConfig(
                n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS), sort=False)
            out.append((rc_j, rc_p, jax_pre.rasterize_range_image(rc_j, N_SCANS, AZ_STEPS)))
    return out


@pytest.mark.parametrize("n_scans", [16, 32, 64])
def test_ring_elevation_table_matches_jax(n_scans):
    np.testing.assert_array_equal(preprocess.ring_elevation_table(n_scans),
                                  jax_pre.ring_elevation_table(n_scans))


def test_arrival_order_preprocess_matches_jax(grids):
    for rc_j, rc_p, _ in grids:
        for f in ("ring", "valid", "ring_start", "ring_count", "pos_in_ring", "xyz", "rel_time"):
            np.testing.assert_array_equal(getattr(rc_p, f).numpy(), np.asarray(getattr(rc_j, f)), f)
        assert not rc_p.pos_in_ring.any()
        # ring + 0.1 * rel_time: XLA fuses it into an FMA (as test_torch_ops.py's
        # preprocess test, within 1e-5)
        np.testing.assert_allclose(rc_p.intensity.numpy(), np.asarray(rc_j.intensity), atol=1e-5)


def test_rasterize_range_image_matches_jax(grids):
    """On JAX's ring cloud and on the port's own, raw and quantized: range,
    xyz, rel_time, occupancy and the winning point exactly. Quantized scans
    tie at a cell's minimum more often; both keep the last tied point."""
    names = ("range", "xyz", "rel_time", "occupied", "src_idx")
    for rc_j, rc_p, ref in grids:
        for rc in (ring_cloud_to_torch(rc_j), rc_p):
            out = preprocess.rasterize_range_image(rc, N_SCANS, AZ_STEPS)
            for a, b, name in zip(out, ref, names):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        assert np.asarray(ref[3]).sum() > 5000


def test_rasterizer_keeps_the_last_of_tied_points():
    """Three points at one cell's minimum range and one farther: the winner
    is the tied point with the largest index, in both packages."""
    xyz = np.array([[10, 0, 0], [20, 0, 0], [10, 0, 0], [10, 0, 0], [0, 15, 0]], np.float32)
    xyz[:, 2] = -1.0
    rc = jax_pre.RingCloud(
        xyz=jnp.asarray(xyz), ring=jnp.asarray([3, 3, 3, 3, 5], jnp.int32),
        rel_time=jnp.asarray([0.5, 0.5, 0.5, 0.5, 0.25], jnp.float32),
        intensity=jnp.zeros(5), valid=jnp.asarray([True] * 5),
        ring_start=jnp.zeros(8, jnp.int32), ring_count=jnp.zeros(8, jnp.int32),
        pos_in_ring=jnp.zeros(5, jnp.int32))
    ref = jax_pre.rasterize_range_image(rc, 8, 16)
    out = preprocess.rasterize_range_image(ring_cloud_to_torch(rc), 8, 16)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(np.asarray(ref[4])[3, 8]) == 3


@pytest.mark.parametrize("n_scans", [16, 32, 64])
def test_grid16_packer_matches_jax_numpy_and_native(n_scans):
    """The port's rasterizer bit for bit against plo_tpu.native's NumPy form,
    on a scan with a NaN and a too-near return; and against its C++ form at
    32 beams, where plo_tpu's own test holds the two equal. (At 16 and 64
    beams plo_tpu's two forms differ: in f32 the C++ form keeps beams at the
    fan's edge that the NumPy form's f64 angle drops.)"""
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=40, extent=60.0)
    scan = synthetic.render_scan(world, np.eye(4), n_scans=n_scans, azimuth_steps=300, seed=1)
    scan = np.concatenate([scan, [[np.nan, 0, 0, 0], [0.5, 0, 0, 0]]]).astype(np.float32)
    args = (n_scans, 300, 1.0 / pipeline.GRID16_SCALE, 2.0, 150.0)
    grids = [np.zeros((n_scans, 300), np.uint16) for _ in range(3)]
    with np.errstate(invalid="ignore"):
        n_port = native.rasterize_grid16_numpy(scan, *args, grids[0])
        n_jax = jax_native.rasterize_grid16_numpy(scan, *args, grids[1])
    assert n_port == n_jax > 1000
    np.testing.assert_array_equal(grids[0], grids[1])
    if n_scans == 32 and jax_native.rasterize_grid16(scan, *args, grids[2]) is not None:
        np.testing.assert_array_equal(grids[0], grids[2])


def test_int16_quantizer_matches_jax_numpy_and_native(scans):
    """The port's quantizer bit for bit against plo_tpu's NumPy form
    (process_scans' fallback), on a scan with NaN, inf and out-of-range xyz
    and on one longer than the capacity; and against plo_tpu's C++
    quantize_pack everywhere but at exact half steps, which NumPy's rint
    rounds to even and the C++ form away from zero."""
    inv = 1.0 / Odometry.TRANSFER_QUANT_SCALE
    bad = np.array([[np.nan, 1, 2, 0], [np.inf, -np.inf, 0, 0], [200, -200, 1e9, 0]], np.float32)
    for raw in (np.concatenate([scans[0], bad]).astype(np.float32), scans[1]):
        cap = min(len(raw), 12000)
        out = np.zeros((cap, 3), np.int16)
        assert native.quantize_pack(raw, inv, out) == cap
        q = np.clip(np.rint(raw[:cap, :3].astype(np.float32) * np.float32(inv)), -32767.0, 32767.0)
        np.testing.assert_array_equal(out, np.nan_to_num(q, nan=32767.0).astype(np.int16))
        cpp = np.zeros((cap, 3), np.int16)
        if jax_native.quantize_pack(raw, inv, cpp) is not None:
            scaled = raw[:cap, :3].astype(np.float32) * np.float32(inv)
            half = np.abs(scaled - np.trunc(scaled)) == 0.5
            np.testing.assert_array_equal(out[~half], cpp[~half])
            assert (np.abs(out[half].astype(int) - cpp[half]) <= 1).all()


def assert_eigen_close(ev_p, ev_j, n_p, n_j, mask, plane_fail, max_other=0):
    """Eigenvalues within 1e-6 + sqrt(eps) lambda1; normals of non-plane-fail
    cells within the angle 1e-4 + 2 sqrt(eps) lambda1 / (lambda2 - lambda3)
    and in the same hemisphere; unit length. Up to `max_other` cells may
    differ beyond that (a neighbor chosen otherwise)."""
    tol = 1e-6 + ROOT_EPS * np.abs(ev_j[mask][:, :1])
    ok = (np.abs(ev_p[mask] - ev_j[mask]) <= tol).all(1)
    assert ok.sum() >= len(ok) - max_other
    m = mask & ~plane_fail
    cos = (n_p[m] * n_j[m]).sum(1)
    cond = ev_j[m, 0] / np.maximum(ev_j[m, 1] - ev_j[m, 2], 1e-30)
    ok = (cos > 0) & (np.arccos(np.clip(cos, -1.0, 1.0)) <= 1e-4 + 2 * ROOT_EPS * cond)
    assert ok.sum() >= len(ok) - max_other
    np.testing.assert_allclose(np.linalg.norm(n_p[mask], axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("use_all_points", [True, False])
def test_pca_grid_matches_jax(grids, use_all_points):
    """keep and plane_fail exactly; eigen-data as the module docstring says,
    every eigenvector of a kept, plane-passing cell too."""
    for _, _, (_, xyzg, _, occ, _) in grids:
        ref = [np.asarray(a) for a in jax_normals.compute_normals_pca_grid(
            xyzg, occ, jax_cfg.PCAConfig(), use_all_points)]
        out = [a.numpy() for a in normals.compute_normals_pca_grid(
            torch.from_numpy(np.array(xyzg)), torch.from_numpy(np.array(occ)),
            port_cfg.PCAConfig(), use_all_points)]
        keep, pfail = ref[3], ref[4]
        assert keep.sum() > 5000 and pfail.sum() > 100
        np.testing.assert_array_equal(out[3], keep)
        np.testing.assert_array_equal(out[4], pfail)
        assert_eigen_close(out[1].reshape(-1, 3), ref[1].reshape(-1, 3), out[0].reshape(-1, 3),
                           ref[0].reshape(-1, 3), keep.reshape(-1), pfail.reshape(-1))
        # Each eigenvector within the angle its eigen-gap allows (up to sign).
        m = (keep & ~pfail).reshape(-1)
        ev = ref[1].reshape(-1, 3)[m]
        vp, vj = out[2].reshape(-1, 3, 3)[m], ref[2].reshape(-1, 3, 3)[m]
        gaps = (ev[:, 0] - ev[:, 1], np.minimum(ev[:, 0] - ev[:, 1], ev[:, 1] - ev[:, 2]),
                ev[:, 1] - ev[:, 2])
        for col, gap in enumerate(gaps):
            cos = np.abs((vp[:, :, col] * vj[:, :, col]).sum(1))
            bound = 1e-4 + 2 * ROOT_EPS * ev[:, 0] / np.maximum(gap, 1e-30)
            assert (np.arccos(np.clip(cos, -1.0, 1.0)) <= bound).all(), col


def port_cloud(cloud):
    return cloud_from_numpy(cloud_arrays(cloud), "cpu")


@pytest.fixture(scope="module")
def jax_frontend():
    """plo_tpu's headline config and FrontEnd (one compile for the tests
    that share it)."""
    cfg_j = headline(jax_cfg)
    return cfg_j, jax_pipeline.FrontEnd(cfg_j, capacity=CAPACITY)


@pytest.mark.parametrize("entry", ["process", "process_grid"])
def test_frontend_grid_paths_match_jax(jax_frontend, scans, entry):
    """FrontEnd.process (range_image/pca) and process_grid (the grid16 raster)
    on two frames with JAX's draws: masks, sampled indices and stats
    exactly; xyz and intensity within 1e-5; eigen-data as above. The grid16
    raster's xyz is r * dir(ring, col), and the packages' f32 cos and sin of
    the beam table differ by an ulp now and then (26 of 450 columns): xyz
    within 1e-5 + 2.5e-7 r there (two ulps of the unit ray times its range)."""
    ray_ulps = 2.5e-7 if entry == "process_grid" else 0.0
    # Those ulps can also move a cell's nearest point on the ring above or
    # below to another column, and with it the cell's window: up to 0.2 % of
    # the kept cells may then differ beyond rounding. The rays themselves:
    cfg_j, fe_j = jax_frontend
    fe_p = pipeline.FrontEnd(config_from_dict(dataclasses.asdict(cfg_j)), capacity=CAPACITY,
                             device="cpu")
    odo = JaxOdometry(cfg_j, capacity=CAPACITY, transfer="grid16")
    np.testing.assert_allclose(fe_p._grid_dirs("cpu").numpy(), np.asarray(fe_j._grid_dirs()[0]),
                               rtol=0, atol=1.2e-7)
    last_j = last_p = None
    for i, scan in enumerate(scans):
        draws = JaxDraws(0, i)
        scores = draws.frontend(1, fe_p.filtered_capacity)
        if entry == "process":
            out_j = fe_j.process(scan, draws.fe_key, last_j, first_frame=i == 0)
            out_p = fe_p.process(scan, scores, last_p, first_frame=i == 0)
        else:
            grid = odo._pack_grid(scan)
            out_j = fe_j.process_grid(grid, draws.fe_key, first_frame=i == 0, last_filtered=last_j)
            out_p = fe_p.process_grid(grid, scores, last_p, first_frame=i == 0)
        assert set(out_p.stats) == set(pipeline.STATS_KEYS) == set(jax_pipeline.STATS_KEYS)
        for k in pipeline.STATS_KEYS:
            assert int(out_p.stats[k]) == int(out_j.stats[k]), k
        for cj, cp in ((out_j.filtered, out_p.filtered), (out_j.flat, out_p.flat)):
            valid = np.asarray(cj.valid)
            np.testing.assert_array_equal(cp.valid.numpy(), valid)
            xyz_j = np.asarray(cj.xyz)
            tol = 1e-5 + ray_ulps * np.linalg.norm(xyz_j, axis=1, keepdims=True)
            assert (np.abs(cp.xyz.numpy() - xyz_j) <= tol).all()
            for f in ("intensity", "curvature"):
                np.testing.assert_allclose(getattr(cp, f).numpy(), np.asarray(getattr(cj, f)),
                                           atol=1e-5, err_msg=f)
        ev_j = np.asarray(out_j.filtered.eigvals)
        valid = np.asarray(out_j.filtered.valid)
        assert_eigen_close(out_p.filtered.eigvals.numpy(), ev_j, out_p.filtered.normal.numpy(),
                           np.asarray(out_j.filtered.normal), valid, ev_j[:, 0] == -1.0,
                           max_other=valid.sum() // 500 if entry == "process_grid" else 0)
        last_j, last_p = out_j.filtered, out_p.filtered


def test_frozen_imls_icp_matches_jax(jax_frontend, scans):
    """The port's ICP loop with frozen correspondences against plo_tpu's
    _make_icp_step(jit=False) on one flat/target pair (JAX's front-end of two
    frames) and JAX's draws, from the identity: the pose within 2 mm / 1e-4
    rad, iterations and correspondences equal."""
    cfg_j, fe_j = jax_frontend
    target = fe_j.process(scans[0], JaxDraws(0, 0).fe_key, None, first_frame=True).filtered
    flat = fe_j.process(scans[1], JaxDraws(0, 1).fe_key, target, first_frame=False).flat
    draws = JaxDraws(0, 1)
    rpose_j, it_j, nc_j, _, _ = _make_icp_step(cfg_j, jit=False)(flat, target, draws.icp_key)
    odo = Odometry(config_from_dict(dataclasses.asdict(cfg_j)), capacity=CAPACITY, device="cpu")
    rpose_p, it_p, nc_p, _ = odo._icp(port_cloud(flat), port_cloud(target), draws, None)
    assert it_p == int(it_j) >= 2
    assert int(nc_p) == int(nc_j) > 500
    np.testing.assert_allclose(rpose_p[:3, 3].numpy(), np.asarray(rpose_j)[:3, 3], atol=2e-3)
    np.testing.assert_allclose(rpose_p[:3, :3].numpy(), np.asarray(rpose_j)[:3, :3], atol=1e-4)


def test_frozen_imls_searches_once_a_frame(scans, monkeypatch):
    """Frozen correspondences search the target once a frame whatever the
    motion: the hybrid refresh (threshold 0.02 m by default) must stay off."""
    from plo_tpu_torch.ops import matching
    calls = []
    search = matching.imls_search
    monkeypatch.setattr(matching, "imls_search", lambda *a: calls.append(1) or search(*a))
    odo = Odometry(headline(port_cfg, motion_prior=False), capacity=CAPACITY, device="cpu")
    frames = [odo.process_scan(s) for s in scans]
    assert frames[1].iterations >= 2 and len(calls) == 1
