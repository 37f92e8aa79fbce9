"""The port's meshes, collectives, sharded ICP step and distributed BA refine
(plo_tpu_torch/parallel/sharding.py, ba.py) against the single-device port
and against plo_tpu's on the same inputs, at tests/test_parallel.py's sizes:
8 CPU shards (plo_tpu: 8 virtual CPU devices) and a 2 x 4 mesh.

Tolerances: the sharded ICP step within 1e-4 of the single-device loop and
of plo_tpu's, correspondence counts exactly (tests/test_parallel.py:41-56;
the port's step sees the single-device rows, so it is seen bit-equal to the
port's loop); the distributed refine within 1e-4 of refine_window
(tests/test_parallel.py:112) and within 1e-5 of plo_tpu's (f32 sums of the
shards' H and g in another order than XLA's).
"""
import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.models.odometry import _make_icp_step
from plo_tpu.parallel import ba as jax_ba
from plo_tpu.parallel import sharding as jax_sharding
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.models.odometry import GeneratorDraws, icp_loop
from plo_tpu_torch.ops import cuda_nn
from plo_tpu_torch.parallel import ba, sharding

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def torch_two_threads():
    """Two torch threads for the module (the suite runs on 6 pytest workers
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    return jax_cfg.Config(laser_odometry=jax_cfg.LaserOdometryConfig(
        matching_method=jax_cfg.MatchingConfig(method="plane_ICP"),
        solve_method=jax_cfg.SolveConfig(method="LS", iterations=5)))


def _cloud_arrays(rng, n, h):
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, :2] = (rng.random((n, 2)) - 0.5) * 30
    xyz[:, 2] = h
    return xyz, np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))


def _clouds():
    """tests/test_parallel.py::_clouds: a 256-point source 5 cm above a
    2048-point target plane, both with +z normals; as (plo_tpu, port)."""
    rng = np.random.default_rng(0)
    out = []
    for n, h in ((256, 0.05), (2048, 0.0)):
        xyz, nrm = _cloud_arrays(rng, n, h)
        jc = dataclasses.replace(JaxCloud.from_xyz(jnp.asarray(xyz)), normal=jnp.asarray(nrm))
        pc = dataclasses.replace(PointCloud.zeros(n), xyz=torch.from_numpy(xyz),
                                 normal=torch.from_numpy(nrm),
                                 valid=torch.ones(n, dtype=torch.bool))
        out.append((jc, pc))
    return out


@pytest.fixture(scope="module")
def icp_case():
    (jflat, pflat), (jtgt, ptgt) = _clouds()
    cfg = config_from_dict(dataclasses.asdict(_cfg()))
    draws = GeneratorDraws(torch.Generator().manual_seed(0), CPU)
    r1, i1, c1, _, _ = icp_loop(cfg, pflat, ptgt, draws, None, CPU, False)
    return jflat, pflat, jtgt, ptgt, cfg, (r1, i1, int(c1))


def test_cpu_mesh_has_8_shards():
    mesh = sharding.get_mesh(device="cpu")
    assert mesh.size == mesh.n_local == 8 and mesh.first_shard == 0
    assert set(mesh.devices) == {CPU} and mesh.axis_names == ("points",)
    assert sharding.get_mesh(4, device="cpu").size == 4
    m2 = sharding.get_mesh_2d(2, 4, device="cpu")
    assert m2.size == 8 and m2.axis_names == ("hosts", "chips")


def test_mesh_without_a_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.get_mesh(8)


def test_collectives_run_in_shard_order():
    mesh = sharding.get_mesh(4, device="cpu")
    parts = [torch.full((2, 3), float(j)) + torch.arange(3.0) for j in range(4)]
    np.testing.assert_array_equal(sharding.all_gather(mesh, parts).numpy(),
                                  torch.cat(parts).numpy())
    vals = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
            torch.tensor([-1e8]), torch.tensor([1.0])]
    # ((1e8 + 1) - 1e8) + 1 in f32 is 1: the shard order, not a tree's 2.
    assert float(sharding.psum(mesh, vals)) == 1.0
    rows = sharding.shard_rows(mesh, torch.arange(10))
    assert [r.tolist() for r in rows] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 0, 0]]
    clouds = sharding.shard_cloud(PointCloud.zeros(10), mesh)
    assert [c.capacity for c in clouds] == [3] * 4


@pytest.mark.parametrize("layout", ["8", "2x4"])
def test_sharded_icp_matches_single_device_and_jax(icp_case, layout, monkeypatch):
    """The sharded step against the port's own loop and against plo_tpu's
    sharded step (tests/test_parallel.py:41-56 and :130-146); on plane-ICP
    every shard calls `nearest` once an iteration."""
    jflat, pflat, jtgt, ptgt, cfg, (r1, i1, c1) = icp_case
    calls = []
    real = cuda_nn.nearest
    monkeypatch.setattr(cuda_nn, "nearest", lambda q, *a: calls.append(q.shape[0]) or real(q, *a))
    if layout == "8":
        mesh = sharding.get_mesh(8, device="cpu")
        step = sharding.make_sharded_icp_step(cfg, mesh)
        jstep = jax_sharding.make_sharded_icp_step(_cfg(), jax_sharding.get_mesh(8))
    else:
        mesh = sharding.get_mesh_2d(2, 4, device="cpu")
        step = sharding.make_sharded_icp_step_2d(cfg, mesh)
        jstep = jax_sharding.make_sharded_icp_step_2d(_cfg(), jax_sharding.get_mesh_2d(2, 4))
    draws = GeneratorDraws(torch.Generator().manual_seed(0), CPU)
    r8, i8, c8, _, _ = step(pflat, ptgt, draws)
    assert calls == [256 // 8] * (8 * i8)
    np.testing.assert_allclose(r8.numpy(), r1.numpy(), atol=1e-4)
    assert int(c8) == c1 and i8 == i1
    rj, ij, cj, _, _ = jstep(jflat, jtgt, jax.random.PRNGKey(0))
    np.testing.assert_allclose(r8.numpy(), np.asarray(rj), atol=1e-4)
    assert int(c8) == int(cj)


def _ba_problem(rng, k=4, n=512, noise=0.02):
    """tests/test_parallel.py::_ba_problem: K poses along a line, consecutive
    correspondences from a random surfel field, the initial poses perturbed."""
    from plo_tpu import geometry as jax_geo
    gt = np.stack([np.eye(4, dtype=np.float32) for _ in range(k)])
    for i in range(k):
        gt[i, :3, 3] = [0.5 * i, 0.01 * i, 0.0]
    src = np.zeros((k - 1, n, 3), np.float32)
    ref = np.zeros((k - 1, n, 3), np.float32)
    nrm = np.zeros((k - 1, n, 3), np.float32)
    val = np.ones((k - 1, n), bool)
    for i in range(k - 1):
        pts_w = (rng.random((n, 3)).astype(np.float32) - 0.5) * 20
        normals_w = rng.normal(size=(n, 3)).astype(np.float32)
        normals_w /= np.linalg.norm(normals_w, axis=1, keepdims=True)
        Ti, Tj = gt[i], gt[i + 1]
        ref[i] = (pts_w - Ti[:3, 3]) @ Ti[:3, :3]
        src[i] = (pts_w - Tj[:3, 3]) @ Tj[:3, :3]
        nrm[i] = normals_w @ Ti[:3, :3]
    init = gt.copy()
    for i in range(1, k):
        w = rng.normal(size=3).astype(np.float32) * noise
        t = rng.normal(size=3).astype(np.float32) * noise
        dR = np.asarray(jax_geo.exp_so3(jnp.asarray(w[None])))[0]
        init[i] = init[i] @ np.asarray(jax_geo.make_se3(jnp.asarray(dR), jnp.asarray(t)))
    val[1, ::7] = False   # a few invalid rows, so shards differ in counts
    return init.astype(np.float32), src, ref, nrm, val


@pytest.mark.parametrize("n_shards", [8, 3])
def test_distributed_refine_matches_single_and_jax(n_shards):
    args = _ba_problem(np.random.default_rng(0))
    t = [torch.from_numpy(a) for a in args]
    single = ba.refine_window(*t, k_window=4, iterations=5)
    refine = ba.make_distributed_refine(sharding.get_mesh(n_shards, device="cpu"), k_window=4,
                                        iterations=5)
    dist_p = refine(*t)
    np.testing.assert_allclose(dist_p.numpy(), single.numpy(), atol=1e-4)
    if n_shards == 8:
        jrefine = jax_ba.make_distributed_refine(jax_sharding.get_mesh(8), k_window=4,
                                                 iterations=5)
        dist_j = np.asarray(jrefine(*(jnp.asarray(a) for a in args)))
        np.testing.assert_allclose(dist_p.numpy(), dist_j, atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_group_of_one_process_matches_the_local_mesh():
    """A mesh joined to a 1-rank gloo group gathers and sums as the local
    mesh does (the group path of both collectives, bool masks included)."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        local = sharding.get_mesh(4, device="cpu")
        grouped = sharding.get_mesh(4, device="cpu", group=dist.group.WORLD)
        parts = [torch.rand(5, 2) for _ in range(4)]
        masks = [torch.rand(5) > 0.5 for _ in range(4)]
        assert torch.equal(sharding.all_gather(grouped, parts), sharding.all_gather(local, parts))
        assert torch.equal(sharding.all_gather(grouped, masks), torch.cat(masks))
        assert torch.equal(sharding.psum(grouped, parts), sharding.psum(local, parts))
        assert grouped.is_writer and grouped.size == 4
    finally:
        dist.destroy_process_group()
