"""Each CUDA kernel of the port against its plain PyTorch version on the card.

These tests need a CUDA card and skip without one. This file imports neither
JAX nor plo_tpu, so it also runs on a GPU host without JAX, where
tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: counts, ranks, indices and masks exactly; nearest's d2 and
projected_argmin's proj bit-equal (the kernels round as the plain versions
do); dist_sum to rtol 2e-5 / atol 1e-4 (f32 sums in another order); knn's d2
exactly (the same elementwise f32 operations on both devices); a default
frame's poses on the card within 2 mm / 1e-4 rad of the CPU's (f32
reductions and transcendental functions round differently on the two
devices; the bound of the resume test in tests/test_torch_odometry.py)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from plo_tpu_torch.ops import cuda_nn, neighbors


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.mark.gpu
@pytest.mark.parametrize("live", [None, 3000])
def test_gpu_cylinder_stats_kernel_matches_plain(gen, cuda, live):
    q = ((gen.random((700, 3)) - 0.5) * 20.0).astype(np.float32)
    n = gen.normal(size=(700, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = ((gen.random((5000, 3)) - 0.5) * 20.0).astype(np.float32)
    tv = gen.random(5000) > 0.15 if live is None else np.arange(5000) < live
    args = [torch.from_numpy(a).to(cuda) for a in (q, n, t, tv)]
    t_live = None if live is None else torch.tensor(live, dtype=torch.int32, device=cuda)
    cuda_nn.reset_launches()
    c, s = cuda_nn.cylinder_stats(*args, 1.5, 0.5, t_live=t_live)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["cylinder_stats"] == 1
    c0, s0 = cuda_nn.cylinder_stats_plain(*args, 1.5, 0.5)
    assert int(c0.sum()) > 200
    assert torch.equal(c, c0)
    torch.testing.assert_close(s, s0, rtol=2e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 40, 200])
def test_gpu_fps_ranks_kernel_matches_plain(gen, cuda, steps):
    b, c = 64, 1024
    xyz = torch.from_numpy(gen.uniform(-20, 20, (b, c, 3)).astype(np.float32)).to(cuda)
    occ = torch.from_numpy((gen.random((b, c)) < gen.random((b, 1))).astype(np.float32)).to(cuda)
    occ[0] = 0.0  # an empty bin
    s = torch.tensor(steps, dtype=torch.int32, device=cuda)
    cuda_nn.reset_launches()
    r = cuda_nn.fps_ranks(xyz, occ, s, 200)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["fps_ranks"] == 1
    assert torch.equal(r, cuda_nn.fps_ranks_plain(xyz, occ, s, 200))


# fps_ranks at the edges of its design: slots in registers (up to 6 a
# thread of 512), ties to the lowest slot within a thread, a warp and the block, the
# seed, and the early exit when a bin has no candidate left.
FPS_EDGES = {
    "every point of a bin identical": dict(identical=True),
    "pairs of duplicated points": dict(pairs=True),
    "steps = 0": dict(steps=0),
    "steps = 1": dict(steps=1),
    "steps above a bin's occupancy": dict(fill=50),
    "one occupied slot": dict(one=True),
    "an empty bin": dict(empty=True),
    "C = 33": dict(c=33),
    "C = 1000": dict(c=1000),
    "C = 3072": dict(c=3072),
    "B = 1": dict(b=1),
}


def _fps_inputs(gen, cuda, b=8, c=1024, steps=200, identical=False, pairs=False, fill=None,
                one=False, empty=False):
    xyz = gen.uniform(-20, 20, (b, c, 3)).astype(np.float32)
    occ = (gen.random((b, c)) < 0.8).astype(np.float32)
    if identical:
        xyz[0] = xyz[0, 0]
        occ[0] = 1.0
    if pairs:
        xyz[:, c // 2:2 * (c // 2)] = xyz[:, :c // 2]
    if fill is not None:
        occ[:] = np.arange(c) < fill
    if one:
        occ[0] = 0.0
        occ[0, c - 1] = 1.0
    if empty:
        occ[0] = 0.0
    return (torch.from_numpy(xyz).to(cuda), torch.from_numpy(occ).to(cuda),
            torch.tensor(steps, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(FPS_EDGES))
def test_gpu_fps_ranks_edges(gen, cuda, edge):
    xyz, occ, s = _fps_inputs(gen, cuda, **FPS_EDGES[edge])
    cuda_nn.reset_launches()
    r = cuda_nn.fps_ranks(xyz, occ, s, 200)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["fps_ranks"] == 1
    ref = cuda_nn.fps_ranks_plain(xyz, occ, s, 200)
    assert torch.equal(r, ref)
    ref = ref.cpu()
    if edge == "every point of a bin identical":   # every step ties at 0: slot order
        assert torch.equal(ref[0, :200], torch.arange(200, dtype=torch.int32))
    if edge == "steps = 0":
        assert int((ref < 200).sum()) == int((occ.sum(1) > 0).sum())
    if edge == "steps above a bin's occupancy":
        assert bool((ref[:, :50] < 50).all()) and bool((ref[:, 50:] == 200).all())
    if edge == "one occupied slot":
        assert int(ref[0, -1]) == 0 and bool((ref[0, :-1] == 200).all())
    if edge == "an empty bin":
        assert bool((ref[0] == 200).all())


def _anchor_inputs(gen, cuda, q=2000, t=20000, live=9000):
    """Queries near a valid prefix of the target, each of the first 300
    target points repeated at the end of the prefix (exact ties), some
    queries on target points (d2 = 0 ties) and some far from any."""
    tgt = np.zeros((t, 3), np.float32)
    tgt[:live] = gen.uniform(-15, 15, (live, 3)).astype(np.float32)
    tgt[live - 300:live] = tgt[:300]
    query = (tgt[gen.integers(0, live, q)] + gen.normal(0, 0.3, (q, 3))).astype(np.float32)
    query[:200] = tgt[gen.integers(0, 300, 200)]
    query[-100:, 2] += 40.0  # far above the target: no anchor
    normal = gen.normal(size=(q, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    valid = np.arange(t) < live
    valid[gen.integers(300, live - 300, 500)] = False  # never a tied copy
    return [torch.from_numpy(a).to(cuda) for a in (query, normal, tgt, valid)]


def _assert_same(out, ref):
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["prefix", "all-invalid", "no-queries"])
def test_gpu_nearest_kernel_matches_plain(gen, cuda, case):
    query, _, tgt, valid = _anchor_inputs(gen, cuda)
    if case == "all-invalid":
        valid[:] = False
    if case == "no-queries":
        query = query[:0]
    cuda_nn.reset_launches()
    out = cuda_nn.nearest(query, tgt, valid, 1.5)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["nearest"] == (case != "no-queries")
    ref = cuda_nn.nearest_plain(query, tgt, valid, 1.5)
    _assert_same(out, ref)
    if case == "prefix":
        assert (out[1][:200] < 300).all() and 0 < int(out[2].sum()) < query.shape[0]
    if case == "all-invalid":
        assert (out[1] == -1).all() and torch.isinf(out[0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["prefix", "all-invalid"])
def test_gpu_projected_argmin_kernel_matches_plain(gen, cuda, case):
    query, normal, tgt, valid = _anchor_inputs(gen, cuda)
    if case == "all-invalid":
        valid[:] = False
    cuda_nn.reset_launches()
    out = cuda_nn.projected_argmin(query, normal, tgt, valid, 2.25, 0.8)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["projected_argmin"] == 1
    _assert_same(out, cuda_nn.projected_argmin_plain(query, normal, tgt, valid, 2.25, 0.8))
    if case == "prefix":
        assert 0 < int(out[2].sum()) < query.shape[0]
    else:
        assert (out[1] == -1).all() and torch.isinf(out[0]).all()


# The tile kernels (cylinder_stats, projected_argmin) at the edges of their
# design: 512 queries a block, 128-point tiles dealt round-robin to slices.
EDGES = {
    "Q not a multiple of 512": dict(q=700),
    "Q = 1": dict(q=1),
    "t_live = 0": dict(t_live=0),
    "t_live = 1": dict(t_live=1),
    "t_live one short of a tile": dict(t_live=127),
    "targets end inside a slice": dict(live=2999),
    "all-invalid targets": dict(all_invalid=True),
    "12 duplicated targets": dict(t=12, live=12, dup=True),
    "queries on targets": dict(on_target=True),
}


def _edge_inputs(gen, cuda, q=600, t=5000, live=4000, t_live=None, all_invalid=False,
                 dup=False, on_target=False, repeat=0):
    tgt = np.zeros((t, 3), np.float32)
    tgt[:live] = gen.uniform(-6, 6, (live, 3)).astype(np.float32)
    tgt[live - repeat:live] = tgt[:repeat]
    if dup:
        tgt[:] = tgt[0]
    tv = np.arange(t) < live
    if t_live is not None:
        tv &= np.arange(t) < t_live
    if all_invalid:
        tv[:] = False
    pick = gen.integers(0, max(live, 1), q)
    query = (tgt[pick] + gen.normal(0, 0.3, (q, 3))).astype(np.float32)
    if on_target or dup:
        query[: (q + 1) // 2] = tgt[pick[: (q + 1) // 2]]   # d2 = 0
    normal = gen.normal(size=(q, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    args = [torch.from_numpy(a).to(cuda) for a in (query, normal, tgt, tv)]
    tl = None if t_live is None else torch.tensor(t_live, dtype=torch.int32, device=cuda)
    return args, tl


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(EDGES))
def test_gpu_cylinder_stats_edges(gen, cuda, edge):
    args, tl = _edge_inputs(gen, cuda, **EDGES[edge])
    cuda_nn.reset_launches()
    c, s = cuda_nn.cylinder_stats(*args, 1.5, 0.5, t_live=tl)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["cylinder_stats"] == 1
    c0, s0 = cuda_nn.cylinder_stats(*[a.cpu() for a in args], 1.5, 0.5,
                                    t_live=None if tl is None else tl.cpu())
    assert torch.equal(c.cpu(), c0)
    torch.testing.assert_close(s.cpu(), s0, rtol=2e-5, atol=1e-4)
    if edge == "12 duplicated targets":
        assert bool((c0[: 300] == 12).all())


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [e for e in EDGES if not e.startswith("t_live")])
def test_gpu_projected_argmin_edges(gen, cuda, edge):
    args, _ = _edge_inputs(gen, cuda, **EDGES[edge])
    cuda_nn.reset_launches()
    for _ in range(2):   # the second launch finds the merge state the first left
        out = cuda_nn.projected_argmin(*args, 2.25, 0.8)
        torch.cuda.synchronize()
        _assert_same(out, cuda_nn.projected_argmin_plain(*args, 2.25, 0.8))
    assert cuda_nn.LAUNCHES["projected_argmin"] == 2
    if edge == "12 duplicated targets":   # the half of the queries on the target
        assert bool((out[1][:300] == 0).all())
    if edge == "all-invalid targets":
        assert bool((out[1] == -1).all())


# nearest beyond EDGES: the radius at inf and at 0, a target that is a view 12
# bytes past its allocation (the wrapper copies it to a 16-byte boundary),
# and so many queries that each block streams several windows of tiles, with
# the first 3,000 targets repeated at the end of the valid prefix (ties
# across windows and slices).
NEAREST_EDGES = {**EDGES, "radius inf": dict(on_target=True), "radius 0": dict(on_target=True),
                 "unaligned target": dict(on_target=True),
                 "many windows a block": dict(q=20000, t=131072, live=100000, repeat=3000,
                                              on_target=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(NEAREST_EDGES))
def test_gpu_nearest_edges(gen, cuda, edge):
    (query, _, tgt, tv), _ = _edge_inputs(gen, cuda, **NEAREST_EDGES[edge])
    radius = {"radius inf": math.inf, "radius 0": 0.0}.get(edge, 1.5)
    if edge == "unaligned target":
        tgt, tv = tgt[1:], tv[1:]
        assert tgt.data_ptr() % 16 != 0
    cuda_nn.reset_launches()
    for _ in range(2):   # the second launch finds the merge state the first left
        out = cuda_nn.nearest(query, tgt, tv, radius)
        torch.cuda.synchronize()
        _assert_same(out, cuda_nn.nearest_plain(query, tgt, tv, radius))
    assert cuda_nn.LAUNCHES["nearest"] == 2
    if edge == "12 duplicated targets":
        assert bool((out[1] == 0).all())
    if edge == "all-invalid targets":
        assert bool((out[1] == -1).all())
    if edge == "radius inf":
        assert bool(out[2].all())
    if edge == "radius 0":   # exactly the queries on a target
        assert bool(torch.equal(out[2], out[0] == 0)) and 0 < int(out[2].sum()) < query.shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 1000, 4096])
def test_gpu_knn_ties_match_the_cpu(gen, cuda, chunk):
    """knn on the card against knn on the CPU: exact ties inside a chunk
    (40 copies of one point, more than k) and across chunk boundaries, and
    queries on tied points; indices, d2 and masks equal, ties to the lowest
    index."""
    t, live = 20000, 15000
    tgt = np.zeros((t, 3), np.float32)
    tgt[:live] = gen.uniform(-10, 10, (live, 3)).astype(np.float32)
    tgt[live - 3000:live] = tgt[:3000]
    tgt[5000:5040] = tgt[5040]
    tv = np.arange(t) < live
    query = (tgt[gen.integers(0, live, 1500)] + gen.normal(0, 0.3, (1500, 3))).astype(np.float32)
    query[:200] = tgt[gen.integers(0, 3000, 200)]
    query[200:250] = tgt[5040]
    args = [torch.from_numpy(a) for a in (query, tgt, tv)]
    out = neighbors.knn(*[a.to(cuda) for a in args], k=20, radius=3.0, chunk=chunk)
    ref = neighbors.knn(*args, k=20, radius=3.0, chunk=chunk)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    assert bool((ref[1][200:250] < 5040).all())


class _SharedDraws:
    """The same random numbers on any device: numpy draws seeded by frame and
    ICP iteration, moved to the device (GeneratorDraws' protocol)."""

    def __init__(self, frame, device):
        self.frame, self.device = frame, device

    def frontend(self, n, p):
        rng = np.random.default_rng([self.frame, 0])
        return [torch.from_numpy(rng.random(p, dtype=np.float32)).to(self.device)
                for _ in range(n)]

    def ransac(self, iteration, n_valid, m):
        u = np.random.default_rng([self.frame, 1, iteration]).random(m, dtype=np.float32)
        n = n_valid.clamp_min(1)
        return torch.minimum((torch.from_numpy(u).to(self.device) * n.to(torch.float32)).long(),
                             n - 1)


@pytest.mark.gpu
def test_gpu_default_frames_match_the_cpu(cuda):
    """Three default-path frames (32 beams x 450, capacity 16384, the
    corridor world) on the card and on the CPU with the same draws: the
    filtered masks and the front-end's counts equal, poses within 2 mm /
    1e-4 rad; the card went through cylinder_stats and fps_ranks. The ICP
    iteration counts may differ: the solver's f32 reductions round otherwise
    on the card, and a delta near the 1 mm convergence threshold then stops
    the loop one or two iterations earlier or later."""
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.io import synthetic
    from plo_tpu_torch.models.odometry import Odometry

    cfg = cfgmod.Config(laser_odometry=cfgmod.LaserOdometryConfig(motion_prior=False),
                        sensor=cfgmod.SensorConfig(n_scans=32, azimuth_resolution=360.0 / 450))
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(3, n_scans=32, azimuth_steps=450, speed=0.5,
                                            yaw_rate=0.01, seed=3, world=world)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        odo = Odometry(cfg, capacity=16384, seed=0, device=dev)
        cuda_nn.reset_launches()
        frames, masks = [], []
        for i, s in enumerate(scans):
            frames.append(odo.process_scan(s, draws=_SharedDraws(i, dev)))
            masks.append(odo.last_filtered.valid.cpu())
        runs[dev.type] = frames, masks, dict(cuda_nn.LAUNCHES)
    (fc, mc, _), (fg, mg, launches) = runs["cpu"], runs["cuda"]
    assert launches["cylinder_stats"] == 2 and launches["fps_ranks"] == 2
    for a, b, ma, mb in zip(fc, fg, mc, mg):
        assert torch.equal(ma, mb)
        for key in ("n_preprocessed", "n_filtered", "n_candidates", "n_sampled"):
            assert a.stats[key] == b.stats[key], key
        np.testing.assert_allclose(b.pose[:3, 3], a.pose[:3, 3], atol=2e-3)
        np.testing.assert_allclose(b.pose[:3, :3], a.pose[:3, :3], atol=1e-4)


def _grid_ring_clouds():
    """The arrival-order preprocess (CPU) of two 32-beam x 450 corridor
    scans, raw and int16-quantized: the rasterizer's inputs on the headline
    path at the test size."""
    from plo_tpu_torch import config as cfgmod, native
    from plo_tpu_torch.io import synthetic
    from plo_tpu_torch.ops import preprocess

    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(2, n_scans=32, azimuth_steps=450, speed=0.5,
                                            yaw_rate=0.01, seed=3, world=world)
    sensor = cfgmod.SensorConfig(n_scans=32, azimuth_resolution=360.0 / 450)
    clouds = []
    for s in scans:
        for quantized in (False, True):
            pts = np.zeros((16384, 4), np.float32)
            pts[:len(s)] = s
            if quantized:
                q = np.zeros((16384, 3), np.int16)
                native.quantize_pack(s, 200.0, q)
                pts[:, :3] = q.astype(np.float32) * np.float32(0.005)
            clouds.append(preprocess.preprocess(torch.from_numpy(pts), len(s), sensor, sort=False))
    return clouds


def _to(rc, dev):
    import dataclasses
    return dataclasses.replace(rc, **{f.name: getattr(rc, f.name).to(dev)
                                      for f in dataclasses.fields(rc)})


@pytest.mark.gpu
def test_gpu_rasterizer_matches_the_cpu(cuda):
    """The range-image rasterizer on the card against the CPU on the same
    ring clouds, raw and quantized: every output exactly (the winner of a
    cell is unique, the range is a correctly rounded root)."""
    from plo_tpu_torch.ops import preprocess
    for rc in _grid_ring_clouds():
        ref = preprocess.rasterize_range_image(rc, 32, 450)
        out = preprocess.rasterize_range_image(_to(rc, cuda), 32, 450)
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("use_all_points", [True, False])
def test_gpu_pca_grid_matches_the_cpu(cuda, use_all_points):
    """The grid-stencil PCA on the card against the CPU on the same grids:
    keep and plane_fail exactly; the moment sums add in the same order on
    both, but the closed-form eigh's sqrt, arccos and cos round otherwise on
    the card, so eigenvalues within 1e-6 + sqrt(eps) lambda1 and normals
    within 1e-4 + 2 sqrt(eps) lambda1 / (lambda2 - lambda3) rad, as
    tests/test_torch_grid_frontend.py holds them against JAX."""
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.ops import normals, preprocess
    root_eps = float(np.sqrt(np.finfo(np.float32).eps))
    for rc in _grid_ring_clouds():
        _, xyzg, _, occ, _ = preprocess.rasterize_range_image(rc, 32, 450)
        ref = normals.compute_normals_pca_grid(xyzg, occ, cfgmod.PCAConfig(), use_all_points)
        out = [a.cpu() for a in normals.compute_normals_pca_grid(
            xyzg.to(cuda), occ.to(cuda), cfgmod.PCAConfig(), use_all_points)]
        assert torch.equal(out[3], ref[3]) and torch.equal(out[4], ref[4])
        keep, pfail = ref[3].numpy(), ref[4].numpy()
        ev = ref[1].numpy()[keep]
        assert (np.abs(out[1].numpy()[keep] - ev) <= 1e-6 + root_eps * np.abs(ev[:, :1])).all()
        m = keep & ~pfail
        cos = (out[0].numpy()[m] * ref[0].numpy()[m]).sum(-1)
        ev = ref[1].numpy()[m]
        cond = ev[:, 0] / np.maximum(ev[:, 1] - ev[:, 2], 1e-30)
        assert (cos > 0).all()
        assert (np.arccos(np.clip(cos, -1.0, 1.0)) <= 1e-4 + 2 * root_eps * cond).all()


@pytest.mark.gpu
@pytest.mark.parametrize("async_mode", [False, True])
def test_gpu_headline_batches_bit_identical_to_frames(cuda, async_mode):
    """bench.py's config at 32 beams x 450 on the card: process_scans at
    float32 (frame 0, then frames 1-3 as one batch) gives the poses,
    iterations and stats of a process_scan loop bit for bit, and launches no
    kernel (the headline path reaches none)."""
    from plo_tpu_torch import bench
    from plo_tpu_torch.io import synthetic
    from plo_tpu_torch.models.odometry import Odometry

    cfg = bench.headline_config(32, 360.0 / 450)
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(4, n_scans=32, azimuth_steps=450, speed=0.5,
                                            yaw_rate=0.01, seed=3, world=world)
    cuda_nn.reset_launches()
    loop = Odometry(cfg, capacity=16384, seed=0, device=cuda, transfer="float32")
    for s in scans:
        loop.process_scan(s)
    batched = Odometry(cfg, capacity=16384, seed=0, device=cuda, transfer="float32",
                       async_mode=async_mode)
    batched.process_scans(scans, batch=3)
    np.testing.assert_array_equal(batched.poses(), loop.poses())
    for a, b in zip(batched.trajectory, loop.trajectory):
        assert (a.iterations, a.n_correspondences, a.stats) == \
            (b.iterations, b.n_correspondences, b.stats)
    assert not any(cuda_nn.LAUNCHES.values())


def _corridor_pca(exact_kd):
    """The CPU preprocess and PCA normals of one 32-beam x 450 corridor scan
    (use_all_points), the input of the slice-C front-end stages."""
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.io import synthetic
    from plo_tpu_torch.ops import normals, preprocess

    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(1, n_scans=32, azimuth_steps=450, seed=3, world=world)
    pts = np.zeros((16384, 4), np.float32)
    pts[:len(scans[0])] = scans[0]
    rc = preprocess.preprocess(torch.from_numpy(pts), len(scans[0]),
                               cfgmod.SensorConfig(n_scans=32, azimuth_resolution=360.0 / 450))
    return normals.compute_normals_pca(rc, cfgmod.PCAConfig(), True, exact_kd=exact_kd)


@pytest.mark.gpu
def test_gpu_three_axis_matches_the_cpu(cuda):
    """Three-axis sampling on the card against the CPU on the same cloud,
    with 300 repeated points (ties on every list): every index and mask
    exactly (the selection runs on distinct int64 keys)."""
    from plo_tpu_torch.ops import features, sampling
    nr = _corridor_pca(False)
    c = nr.cloud
    cand = features.presample_geometric(c.eigvals, c.valid, 0.05) & ~nr.plane_fail
    xyz, nrm, ev = c.xyz.clone(), c.normal.clone(), c.eigvals.clone()
    idx = torch.nonzero(cand)[:, 0]
    for a in (xyz, nrm, ev):
        a[idx[-300:]] = a[idx[:300]]
    ref = sampling.three_axis_sampling(xyz, nrm, ev, cand, 167)
    out = sampling.three_axis_sampling(xyz.to(cuda), nrm.to(cuda), ev.to(cuda), cand.to(cuda), 167)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b)
    assert bool(ref[1].all())


@pytest.mark.gpu
def test_gpu_tensor_voting_presample_matches_the_cpu(cuda):
    """The saliency presample on the card against the CPU on the same
    exact-kd PCA cloud: validity exactly; the closed-form eigh's sqrt, arccos
    and cos round otherwise on the card, so saliencies within 4 (1e-6 +
    sqrt(eps) l1) and labels exactly away from near-ties of two saliencies,
    as tests/test_torch_tensor_voting.py holds them against JAX."""
    import dataclasses
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.ops import tensor_voting as tv
    root_eps = float(np.sqrt(np.finfo(np.float32).eps))
    nr = _corridor_pca(True)
    cfg = cfgmod.TensorVotingConfig(k=20, sigma=0.2)
    ref = tv.saliency_presample(nr.cloud, nr.eigvecs, cfg)
    moved = dataclasses.replace(nr.cloud, **{f.name: getattr(nr.cloud, f.name).to(cuda)
                                             for f in dataclasses.fields(nr.cloud)})
    out = tv.saliency_presample(moved, nr.eigvecs.to(cuda), cfg)
    v = ref.cloud.valid.numpy()
    assert v.sum() > 3000 and np.array_equal(out.cloud.valid.cpu().numpy(), v)
    s, c, p = (x.numpy() for x in (ref.surfaceness, ref.curveness, ref.pointness))
    bound = 4 * (1e-6 + root_eps * np.abs(s + c + p))
    for a, b in zip((out.surfaceness, out.curveness, out.pointness), (s, c, p)):
        assert (np.abs(a.cpu().numpy() - b) <= bound)[v].all()
    srt = np.sort(np.stack([p, c, s]), axis=0)
    ok = v & (srt[2] - srt[1] > 2 * bound)
    assert ok.sum() > 0.99 * v.sum()
    assert np.array_equal(out.labels.cpu().numpy()[ok], ref.labels.numpy()[ok])


@pytest.mark.gpu
def test_gpu_vote_for_any_and_anchor_override_match_the_cpu(cuda):
    """VoteForAny and tensor-voting IMLS (configs/tensor_voting_vlp32.json's
    IMLS stage) on the card against the CPU, as
    tests/test_torch_tensor_voting.py holds them against JAX: the exact-kd
    PCA cloud votes onto itself moved by 0.3 m and 0.01 rad. Received
    exactly; voted normals within 1e-4 in cosine on 99 % of points and 0.9
    on all (the closed-form eigh rounds otherwise on the card); then IMLS
    with the CPU's voted normals as the anchors on both devices: validity,
    normals and counters exactly, y within 1e-4 m."""
    import dataclasses
    import os
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.ops import matching
    from plo_tpu_torch.ops import tensor_voting as tv
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    icfg = cfgmod.load(os.path.join(root, "configs", "tensor_voting_vlp32.json")
                       ).laser_odometry.matching_method.imls
    tgt = _corridor_pca(True).cloud
    c, s = math.cos(0.01), math.sin(0.01)
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = dataclasses.replace(tgt, xyz=tgt.xyz @ rot.T + torch.tensor([0.3, 0.05, 0.0]),
                              normal=tgt.normal @ rot.T)
    on_card = lambda cl: dataclasses.replace(
        cl, **{f.name: getattr(cl, f.name).to(cuda) for f in dataclasses.fields(cl)})
    src_c, tgt_c = on_card(src), on_card(tgt)
    ref_n, ref_ok = tv.vote_for_any(tgt.xyz, tgt.valid, tgt.normal, src.xyz, src.valid,
                                    icfg.use_tensor_voting)
    out_n, out_ok = tv.vote_for_any(tgt_c.xyz, tgt_c.valid, tgt_c.normal, src_c.xyz,
                                    src_c.valid, icfg.use_tensor_voting)
    ok = ref_ok.numpy()
    assert ok.sum() > 3000 and np.array_equal(out_ok.cpu().numpy(), ok)
    cos = (out_n.cpu().numpy() * ref_n.numpy()).sum(1)[ok]
    assert (cos > 1 - 1e-4).mean() > 0.99 and (cos > 0.9).all()
    ref = matching.imls_project(src, tgt, icfg, anchor_normal_src=ref_n, anchor_ok_src=ref_ok)
    out = matching.imls_project(src_c, tgt_c, icfg, anchor_normal_src=ref_n.to(cuda),
                                anchor_ok_src=ref_ok.to(cuda))
    assert int(ref.valid.sum()) > 100
    assert torch.equal(out.valid.cpu(), ref.valid)
    assert torch.equal(out.normal.cpu(), ref.normal)
    torch.testing.assert_close(out.y.cpu(), ref.y, rtol=0.0, atol=1e-4)
    for k, v in ref.counters.items():
        assert int(out.counters[k]) == int(v), k


@pytest.mark.gpu
def test_gpu_nearest_at_icp_solve_shapes(gen, cuda):
    """nearest as the point-to-point ICP solve calls it: 2,000 moved source
    points against their 2,000 matches, radius infinite, half the targets
    masked; bit-equal to the plain version, one launch."""
    tgt = gen.uniform(-30, 30, (2000, 3)).astype(np.float32)
    query = (tgt + gen.normal(0, 0.05, (2000, 3))).astype(np.float32)
    valid = gen.random(2000) < 0.5
    q, t, v = (torch.from_numpy(a).to(cuda) for a in (query, tgt, valid))
    cuda_nn.reset_launches()
    out = cuda_nn.nearest(q, t, v)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["nearest"] == 1
    _assert_same(out, cuda_nn.nearest_plain(q, t, v))
    assert bool(v[out[1].long()].all()) and bool(out[2].all())


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["GNC_TLS", "FGR", "QUATRO"])
def test_gpu_teaser_and_icp_match_the_cpu(gen, cuda, algorithm):
    """Teaser (k-core on, cost threshold on) and the point-to-point ICP solve
    on the card against the CPU on the same pairs: the 4x4s within 1e-5 (f32
    reductions in another order); the ICP solve launches nearest once an
    iteration."""
    from plo_tpu_torch.solvers import gnc, icp_umeyama
    src = gen.uniform(-10, 10, (220, 3)).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    ref = (src @ rot.T + np.array([0.8, -0.4, 0.2]) + gen.normal(0, 0.005, (220, 3)))
    ref = ref.astype(np.float32)
    ref[:99] += np.array([3.0, 1.5, -2.0], np.float32)
    valid = np.ones(220, bool)
    kw = dict(noise_bound=0.05, use_max_clique=True, kcore_min_fraction=0.3,
              algorithm=algorithm, cost_threshold=0.005)
    args = [torch.from_numpy(a) for a in (src, ref, valid)]
    T_cpu, ok_cpu = gnc.solve_gnc_tls(*args, **kw)
    T_gpu, ok_gpu = gnc.solve_gnc_tls(*(a.to(cuda) for a in args), **kw)
    assert bool(ok_cpu) and bool(ok_gpu)
    np.testing.assert_allclose(T_gpu.cpu().numpy(), T_cpu.numpy(), atol=1e-5)
    cuda_nn.reset_launches()
    I_gpu, _ = icp_umeyama.solve_icp_point_to_point(*(a.to(cuda) for a in args), 30)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["nearest"] == 30
    I_cpu, _ = icp_umeyama.solve_icp_point_to_point(*args, 30)
    np.testing.assert_allclose(I_gpu.cpu().numpy(), I_cpu.numpy(), atol=1e-5)


@pytest.mark.gpu
def test_gpu_nearest_at_the_map_shape(gen, cuda):
    """nearest as map-mode plane-ICP calls it: 2,000 queries against a
    65,536-slot voxel map whose valid points are a prefix in order of
    distance from the sensor (voxel_map_insert's order), radius 1.5 m;
    bit-equal to the plain version, one launch, no match past the prefix."""
    cells = gen.integers(-100, 101, (65536, 3))
    cells[:, 2] = cells[:, 2] % 12 - 6
    pts = (cells * 0.3 + 0.15).astype(np.float32)
    pts = pts[np.argsort((pts.astype(np.float64) ** 2).sum(1), kind="stable")]
    valid = np.arange(65536) < 50000
    query = (pts[gen.integers(0, 50000, 2000)] + gen.normal(0, 0.2, (2000, 3))).astype(np.float32)
    q, t, v = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (query, pts, valid))
    cuda_nn.reset_launches()
    out = cuda_nn.nearest(q, t, v, 1.5)
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["nearest"] == 1
    _assert_same(out, cuda_nn.nearest_plain(q, t, v, 1.5))
    assert int(out[2].sum()) > 1000 and bool((out[1][out[2]] < 50000).all())


@pytest.mark.gpu
def test_gpu_voxel_map_and_grid_hash_match_the_cpu(gen, cuda):
    """The map's integer and ordering work on the card equals the CPU's
    exactly: voxel_map_insert (first arrival, occupied voxels, eviction by
    distance) and the grid-hash build and kNN (distances as the f64-emulated
    fma, so bit for bit)."""
    from plo_tpu_torch.cloud import PointCloud
    from plo_tpu_torch.ops import grid_hash, voxel

    def cloud(n, scale, frac):
        return PointCloud(
            xyz=torch.from_numpy((gen.normal(size=(n, 3)) * scale).astype(np.float32)),
            normal=torch.from_numpy(gen.normal(size=(n, 3)).astype(np.float32)),
            intensity=torch.from_numpy(gen.random(n).astype(np.float32)),
            curvature=torch.zeros(n), eigvals=torch.zeros(n, 3),
            valid=torch.from_numpy(gen.random(n) < frac))

    def to(c, dev):
        return PointCloud(**{k: getattr(c, k).to(dev) for k in
                             ("xyz", "normal", "intensity", "curvature", "eigvals", "valid")})

    old, new = cloud(8192, 6.0, 0.6), cloud(6000, 7.0, 0.95)
    center = torch.tensor([0.4, -0.3, 0.1])
    ref = voxel.voxel_map_insert(old, new, 0.3, center)
    out = voxel.voxel_map_insert(to(old, cuda), to(new, cuda), 0.3, center.to(cuda))
    assert int(ref.valid.sum()) == 8192
    for k in ("xyz", "normal", "intensity", "valid"):
        assert torch.equal(getattr(out, k).cpu(), getattr(ref, k)), k
    query = ref.xyz[:1500] + 0.05
    gh_ref = grid_hash.build(ref.xyz, ref.valid, 1.0, 1 << 15)
    gh_out = grid_hash.build(ref.xyz.to(cuda), ref.valid.to(cuda), 1.0, 1 << 15)
    a = grid_hash.knn(gh_ref, query, 20, 1.0, m=64)
    b = grid_hash.knn(gh_out, query.to(cuda), 20, 1.0, m=64)
    assert int(a[2].sum()) > 10000
    for x, y in zip(a, b):
        assert torch.equal(y.cpu(), x)


def _small_frames():
    from plo_tpu_torch.io import synthetic
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(4, n_scans=32, azimuth_steps=450, speed=0.5,
                                             yaw_rate=0.01, seed=3, world=world)
    return scans, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def _slice_d_config(name):
    import dataclasses as dc
    import os
    from plo_tpu_torch import config as cfgmod
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sensor = cfgmod.SensorConfig(n_scans=32, azimuth_resolution=0.8)
    b1 = cfgmod.load(os.path.join(root, "configs/aloam_kitti00.json"), sensor=sensor)
    fals = cfgmod.load(os.path.join(root, "configs/drpm_range_image.json"), sensor=sensor)
    lo = lambda c, **kw: dc.replace(c, laser_odometry=dc.replace(c.laser_odometry, **kw))
    normals = lambda c, m: dc.replace(c, scan_registration=dc.replace(
        c.scan_registration, compute_normal_method=dc.replace(
            c.scan_registration.compute_normal_method, method=m)))
    return {"map plane-ICP": lo(b1, target_mode="map"),
            "undistort": lo(b1, motion_prior=True, undistort=True),
            "FALS": fals, "SRI": normals(fals, "SRI"),
            "cross_product": normals(b1, "cross_product")}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["map plane-ICP", "undistort", "FALS", "SRI", "cross_product"])
def test_gpu_slice_d_paths_launch_nearest_once_an_iteration(cuda, name):
    """Map-mode plane-ICP, undistortion and the range-image and cross-product
    normals on the card: nearest once an ICP iteration, no other kernel,
    every pose finite."""
    from plo_tpu_torch.models.odometry import Odometry
    scans, _ = _small_frames()
    odo = Odometry(_slice_d_config(name), capacity=16384, seed=0, device=cuda)
    cuda_nn.reset_launches()
    frames = [odo.process_scan(s) for s in scans]
    its = sum(f.iterations for f in frames[1:])
    assert its > 0
    assert dict(cuda_nn.LAUNCHES) == {"nearest": its, "projected_argmin": 0,
                                      "cylinder_stats": 0, "fps_ranks": 0}
    assert np.isfinite(odo.poses()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("search", ["dense", "grid_hash"])
def test_gpu_map_mode_batched_launches_nothing(cuda, search):
    """bench --map's config at 32 x 450 through process_scans(batch=3) with
    grid16 on the card: no kernel launch (its searches are knn and the grid
    hash, plain in both packages), poses finite and within 0.1 m of the
    ground truth, the world pose a rotation to 1e-5."""
    from plo_tpu_torch import bench
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.utils import evaluate
    scans, gt = _small_frames()
    odo = Odometry(bench.map_config(search, 32, 0.8), capacity=16384, seed=0, device=cuda,
                   async_mode=True, transfer="grid16")
    cuda_nn.reset_launches()
    odo.process_scans(scans, batch=3)
    est = odo.poses()
    assert not any(cuda_nn.LAUNCHES.values())
    assert np.isfinite(est).all()
    assert evaluate.ate_rmse(est, gt, align=False) < 0.1
    assert abs(float(torch.linalg.det(odo._world_dev[:3, :3].double())) - 1.0) < 1e-5


@pytest.mark.gpu
def test_gpu_refine_window_matches_the_cpu(gen, cuda):
    """BA's Gauss-Newton window refine on the card against the CPU on the
    same exact plane correspondences (consecutive and skip pairs of a
    4-pose window, some invalid) and perturbed poses: within 1e-5 (f32
    reductions in another order), with torch's sync debug mode raising on
    any synchronizing call inside it."""
    from plo_tpu_torch import geometry as geo
    from plo_tpu_torch.parallel import ba
    K, N = 4, 512
    step = geo.make_se3(geo.exp_so3(torch.tensor([0.0, 0.0, 0.05], dtype=torch.float64)),
                        torch.tensor([0.5, 0.02, 0.0], dtype=torch.float64)).numpy()
    gt = [np.eye(4)]
    for _ in range(K - 1):
        gt.append(gt[-1] @ step)
    pairs = ((0, 1), (1, 2), (2, 3), (0, 2), (1, 3))
    blocks = []
    for i, j in pairs:
        pw = np.c_[gen.uniform(-10, 10, (N, 3)), np.ones(N)]
        nw = gen.normal(size=(N, 3))
        nw /= np.linalg.norm(nw, axis=1, keepdims=True)
        blocks.append(((np.linalg.inv(gt[j]) @ pw.T).T[:, :3],
                       (np.linalg.inv(gt[i]) @ pw.T).T[:, :3],
                       (np.linalg.inv(gt[i])[:3, :3] @ nw.T).T))
    src, ref, nrm = (np.stack([b[f] for b in blocks]).astype(np.float32) for f in range(3))
    valid = gen.random((len(pairs), N)) > 0.1
    poses = np.stack(gt).copy()
    for k in range(1, K):
        poses[k, :3, 3] += gen.normal(size=3) * 0.05
    args = [torch.from_numpy(a) for a in (poses.astype(np.float32), src, ref, nrm, valid)]
    cpu = ba.refine_window(*args, K, 4, 1e-6, pairs, 0.05)
    dev_args = [a.to(cuda) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ba.refine_window(*dev_args, K, 4, 1e-6, pairs, 0.05)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-5)
    assert np.abs(cpu.numpy()[1:, :3, 3] - np.stack(gt)[1:, :3, 3]).max() < 1e-3


@pytest.mark.gpu
def test_gpu_record_corr_with_nearest_matches_the_cpu(cuda):
    """BA's correspondence recorder on configs/aloam_kitti00.json
    (plane-ICP) on the card: one nearest launch, and the record against the
    CPU's. The relative pose is the identity, so the moved source is exact
    on both devices (at another pose the card's matmul rounds otherwise and
    a correspondence at the radius gate can flip, reordering the record):
    mask, order, source rows and target normals exactly, the projected
    targets within 1e-5 m ((x - p) . n sums in another order)."""
    import dataclasses as dc
    import os
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.models.odometry import GeneratorDraws, record_corr
    from plo_tpu_torch.models.pipeline import FrontEnd
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = cfgmod.load(os.path.join(root, "configs/aloam_kitti00.json"),
                      sensor=cfgmod.SensorConfig(n_scans=32, azimuth_resolution=0.8))
    cfg = dc.replace(cfg, laser_odometry=dc.replace(cfg.laser_odometry, ba=dc.replace(
        cfg.laser_odometry.ba, enabled=True, max_correspondences=2000)))
    scans, _ = _small_frames()
    fe = FrontEnd(cfg, capacity=16384, device="cpu")
    draws = GeneratorDraws(torch.Generator().manual_seed(0), torch.device("cpu"))
    prev = fe.process(scans[0], draws.frontend(1, fe.filtered_capacity), None, True)
    cur = fe.process(scans[1], draws.frontend(1, fe.filtered_capacity), prev.filtered, False)
    rel = torch.eye(4)
    ref = record_corr(cfg, cur.flat, prev.filtered, rel)
    cuda_nn.reset_launches()
    out = [a.cpu() for a in record_corr(cfg, _to(cur.flat, cuda), _to(prev.filtered, cuda),
                                        rel.to(cuda))]
    assert cuda_nn.LAUNCHES["nearest"] == 1
    assert 300 < int(ref[3].sum()) < 2000
    assert torch.equal(out[3], ref[3]) and torch.equal(out[0], ref[0])
    assert torch.equal(out[2], ref[2])
    torch.testing.assert_close(out[1], ref[1], rtol=0.0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_cli_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """python -m plo_tpu_torch.cli on the card against --platform cpu:
    tests/test_cli.py's light config (plane-ICP + LS), 3 synthetic frames at
    32 x 450, with artifacts, a checkpoint and the evaluation. Both runs draw
    from one CPU generator seeded alike (the card's generator makes other
    numbers), so they sample the same points: poses within 2 mm / 1e-4 rad
    and the same output file set."""
    import json
    import os
    from plo_tpu_torch import cli
    from plo_tpu_torch.models import odometry

    class CpuDraws(odometry.GeneratorDraws):
        def __init__(self, generator, device):
            super().__init__(torch.Generator().manual_seed(generator.initial_seed()),
                             torch.device("cpu"))
            self.target = device

        def frontend(self, n, p):
            return [t.to(self.target) for t in super().frontend(n, p)]

        def ransac(self, iteration, n_valid, m):
            return super().ransac(iteration, n_valid.cpu(), m).to(self.target)

    monkeypatch.setattr(odometry, "GeneratorDraws", CpuDraws)
    cfg = tmp_path / "light.json"
    cfg.write_text(json.dumps({
        "scan_registration": {
            "compute_normal_method": {"format": "pointcloud", "method": "pca"},
            "presample_method": {"method": "geometric_features"},
            "sample_method": {"method": "random", "random": {"max_points": 1500}},
        },
        "laser_odometry": {
            "matching_method": {"method": "plane_ICP"},
            "solve_method": {"method": "LS", "iterations": 20},
        },
    }))
    common = ["--dataset", "synthetic", "--frames", "3", "--capacity", "16384",
              "--scan-lines", "32", "--azimuth-steps", "450", "--azimuth-resolution", "0.8",
              "--config", str(cfg), "--eval-gt", "--save-artifacts", "--checkpoint-every", "2"]
    cuda_nn.reset_launches()
    assert cli.main(common + ["--output", str(tmp_path / "gpu")]) == 0
    assert cuda_nn.LAUNCHES["nearest"] > 0
    assert cli.main(common + ["--output", str(tmp_path / "cpu"), "--platform", "cpu"]) == 0

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)

    assert files(tmp_path / "gpu") == files(tmp_path / "cpu")
    gpu, cpu = (np.loadtxt(tmp_path / d / "trajectory_tum.txt") for d in ("gpu", "cpu"))
    assert gpu.shape == cpu.shape == (3, 8)
    np.testing.assert_allclose(gpu[:, 1:4], cpu[:, 1:4], rtol=0, atol=2e-3)
    # Quaternions (q and -q are one rotation) within 1e-4 rad: |dq| ~ angle / 2.
    dq = np.minimum(np.abs(gpu[:, 4:] - cpu[:, 4:]), np.abs(gpu[:, 4:] + cpu[:, 4:]))
    assert dq.max() < 5e-5, dq


@pytest.mark.gpu
def test_gpu_sharded_map_odometry_matches_the_cpu(cuda):
    """The sharded map odometry with 8 shards on cuda:0 against the same
    run on 8 CPU shards, both on the same draws (_SharedDraws: a CUDA
    generator draws other numbers than the CPU's), on the worker's scans and
    config solved by LS, as tests/test_torch_sharded_odometry.py's parity run
    is (5 frames): poses within 2 mm / 1e-4 rad, and batched on the card
    equal to per frame."""
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.parallel import get_mesh
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
    from plo_tpu_torch.parallel.worker import dist_config, dist_scans
    cfg = dist_config()
    cfg = dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, solve_method=cfgmod.SolveConfig(method="LS", iterations=20)))
    scans, _ = dist_scans(5)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        sodo = ShardedMapOdometry(cfg, get_mesh(8, device=dev), capacity=16384, seed=0)
        for i, s in enumerate(scans):
            sodo.process_scan(s, draws=_SharedDraws(i, dev))
        runs[dev.type] = sodo.poses()
    np.testing.assert_allclose(runs["cuda"][:, :3, 3], runs["cpu"][:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(runs["cuda"][:, :3, :3], runs["cpu"][:, :3, :3], atol=1e-4)
    b = ShardedMapOdometry(cfg, get_mesh(8, device=cuda), capacity=16384, seed=0,
                           defer_fetch=True)
    b.process_scans(scans, batch=4, draws=[_SharedDraws(i, cuda) for i in range(len(scans))])
    np.testing.assert_array_equal(b.poses(), runs["cuda"])


@pytest.mark.gpu
def test_gpu_knn_gather_matches_the_cpu(gen, cuda):
    """The sharded map store's search on 8 shards on cuda:0 against the CPU:
    candidates, masks and d2 exactly, ties between shards included."""
    from plo_tpu_torch.cloud import PointCloud
    from plo_tpu_torch.parallel import get_mesh
    from plo_tpu_torch.parallel.map_store import ShardedMapStore
    xyz = ((gen.random((8192, 3)) - 0.5) * 100).astype(np.float32)
    xyz[:6] = np.float32([10, 10, 1]) + 2 * np.concatenate([np.eye(3), -np.eye(3)])
    normal = gen.normal(size=xyz.shape).astype(np.float32)
    normal[::5] = 0.0
    q = ((gen.random((2000, 3)) - 0.5) * 100).astype(np.float32)
    q[0] = [10, 10, 1]
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
        cloud = dataclasses.replace(PointCloud.zeros(len(xyz), dev),
                                    xyz=torch.from_numpy(xyz).to(dev),
                                    normal=torch.from_numpy(normal).to(dev),
                                    valid=torch.ones(len(xyz), dtype=torch.bool, device=dev))
        store = ShardedMapStore(get_mesh(8, device=dev), per_shard=2048)
        store.set_model(cloud)
        out[name] = [t.cpu() for t in store.knn_gather(torch.from_numpy(q).to(dev), 20, 5.0)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert int(out["cpu"][4].sum()) > 1000


@pytest.mark.gpu
def test_gpu_cuda_tensor_on_a_gloo_group_raises(cuda):
    """The collectives never stage a CUDA tensor through the host for gloo."""
    import socket
    import torch.distributed as dist
    from plo_tpu_torch.parallel import sharding
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = sharding.get_mesh(2, device=cuda, group=dist.group.WORLD)
        with pytest.raises(RuntimeError, match="gloo"):
            sharding.all_gather(mesh, [torch.ones(3, device=cuda)] * 2)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_gpu_sharded_icp_step_launches_nearest_once_a_shard(cuda):
    """configs/aloam_kitti00.json's plane-ICP through the sharded step with
    8 shards on cuda:0: nearest launched 8 times an iteration, the pose
    equal to the single-device loop's."""
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.cloud import PointCloud
    from plo_tpu_torch.models.odometry import GeneratorDraws, icp_loop
    from plo_tpu_torch.parallel import sharding
    cfg = cfgmod.Config(laser_odometry=cfgmod.LaserOdometryConfig(
        matching_method=cfgmod.MatchingConfig(method="plane_ICP"),
        solve_method=cfgmod.SolveConfig(method="LS", iterations=5)))
    clouds = []
    for n, h in ((2000, 0.05), (16384, 0.0)):
        xyz = np.full((n, 3), h, np.float32)
        xyz[:, :2] = (np.random.default_rng(n).random((n, 2)) - 0.5) * 30
        normal = np.tile(np.float32([0, 0, 1]), (n, 1))
        clouds.append(dataclasses.replace(
            PointCloud.zeros(n, cuda), xyz=torch.from_numpy(xyz).to(cuda),
            normal=torch.from_numpy(normal).to(cuda),
            valid=torch.ones(n, dtype=torch.bool, device=cuda)))
    draws = lambda: GeneratorDraws(torch.Generator(device=cuda).manual_seed(0), cuda)
    one = icp_loop(cfg, *clouds, draws(), None, cuda, False)
    cuda_nn.reset_launches()
    step = sharding.make_sharded_icp_step(cfg, sharding.get_mesh(8, device=cuda))
    r8, i8, c8, _, _ = step(*clouds, draws())
    torch.cuda.synchronize()
    assert cuda_nn.LAUNCHES["nearest"] == 8 * i8
    assert torch.equal(r8, one[0]) and int(c8) == int(one[2])


@pytest.mark.gpu
def test_gpu_two_nccl_ranks_match_one_process(cuda, tmp_path):
    """Two processes of `python -m plo_tpu_torch.parallel.worker`, one card
    each, 4 shards each, joined over NCCL, against the same 8 shards driven
    by one process on cuda:0: equal poses. Needs two cards."""
    import os
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one NCCL rank a card")
    from plo_tpu_torch.parallel import get_mesh
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
    from plo_tpu_torch.parallel.worker import dist_config, dist_scans
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "poses.npy")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plo_tpu_torch.parallel.worker", "--process-id", str(pid),
         "--num-processes", "2", "--port", str(port), "--local-devices", "4", "--frames", "8",
         "--out", out], cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert "(cuda:0)" in logs[0] and "(cuda:1)" in logs[1], logs
    scans, _ = dist_scans(8)
    one = ShardedMapOdometry(dist_config(), get_mesh(8, device=torch.device("cuda", 0)),
                             capacity=8192, seed=0)
    for s in scans:
        one.process_scan(s)
    np.testing.assert_array_equal(np.load(out), one.poses())
