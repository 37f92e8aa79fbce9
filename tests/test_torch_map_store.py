"""The port's sharded map store and sharded checkpoints
(plo_tpu_torch/parallel/map_store.py, utils/checkpoint.py save_sharded /
load_sharded) against plo_tpu's on the same inputs, at
tests/test_map_store.py's sizes: 8 CPU shards (plo_tpu: 8 virtual CPU
devices).

Tolerances: shard ids, partitions, counts, indices and masks exactly; the
search's d2 within rtol 1e-6 of plo_tpu's (XLA's CPU fuses the distance sums
into FMAs; seen bit-equal here) and bit-equal to the port's global knn;
candidate rows exactly (they are gathered map rows). Resume: on the same mesh
within 1e-5 m and on 4 shards within 5e-3 m of the uninterrupted run
(tests/test_map_store.py:48-114); a plo_tpu checkpoint continued in the port
at 4 shards with plo_tpu's draws within 1e-3 m of plo_tpu's own continuation
at 4 devices, with the same ICP iterations (seen 1.4e-4 m: a frame of this
16 x 180 scan has ~250 correspondences, and one of them crossing a gate where
XLA's FMA-fused f32 distances round apart from torch's moves the pose by
~1e-4 m; the bound of tests/test_torch_odometry.py's resume test is 2e-3 m).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.io import synthetic as jax_synthetic
from plo_tpu.parallel import ShardedMapOdometry as JaxShardedMapOdometry
from plo_tpu.parallel import get_mesh as jax_get_mesh
from plo_tpu.parallel import map_store as jax_map_store
from plo_tpu.utils import checkpoint as jax_checkpoint
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.ops import neighbors
from plo_tpu_torch.parallel import get_mesh, map_store
from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
from plo_tpu_torch.utils import checkpoint

RESUME_AFTER, N_FRAMES = 6, 9


@pytest.fixture(scope="module", autouse=True)
def torch_two_threads():
    """Two torch threads for the module (the suite runs on 6 pytest workers
    side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud_pair(xyz, valid, normal=None):
    normal = np.zeros_like(xyz) if normal is None else normal
    jc = dataclasses.replace(JaxCloud.from_xyz(jnp.asarray(xyz), jnp.asarray(valid)),
                             normal=jnp.asarray(normal))
    pc = dataclasses.replace(PointCloud.zeros(len(xyz)), xyz=torch.from_numpy(xyz),
                             normal=torch.from_numpy(normal), valid=torch.from_numpy(valid))
    return jc, pc


def _boundary_cloud(rng, n=4096):
    """Points over negative and positive cells, a quarter of them on exact
    multiples of the 0.3 m voxel and of the 3.9 m block (13 voxels), where a
    true division and XLA's multiply by the f32 reciprocal floor apart."""
    xyz = ((rng.random((n, 3)) - 0.5) * 100).astype(np.float32)
    k = rng.integers(-40, 40, (n // 4, 3))
    xyz[: n // 4] = (k * np.where(rng.random((n // 4, 3)) < 0.5, 0.3, 3.9)).astype(np.float32)
    return xyz, rng.random(n) > 0.1


def test_voxel_shard_id_matches_jax():
    xyz, _ = _boundary_cloud(np.random.default_rng(1))
    t = torch.from_numpy(xyz)
    np.testing.assert_array_equal(map_store.voxel_shard_id(t, 8).numpy(),
                                  np.asarray(jax_map_store.voxel_shard_id(jnp.asarray(xyz), 8)))
    # The odometry's form: a constant cell, which plo_tpu's jit folds.
    jax_ids = jax.jit(lambda x: jax_map_store.voxel_shard_id(x, 8, base_cell=0.3,
                                                             block_factor=13))(jnp.asarray(xyz))
    ids = map_store.voxel_shard_id(t, 8, base_cell=0.3, block_factor=13)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
    assert (xyz < 0).any() and len(np.unique(ids.numpy())) == 8


@pytest.mark.parametrize("blocks", ["voxel", "base_cell"])
def test_partition_cloud_matches_jax(blocks):
    xyz, valid = _boundary_cloud(np.random.default_rng(2))
    jc, pc = _cloud_pair(xyz, valid)
    kw = {} if blocks == "voxel" else dict(base_cell=0.3, block_factor=13)
    # 450 rows a shard: some shards overflow and drop their last points.
    jpart, jcounts = jax.jit(lambda c: jax_map_store.partition_cloud(c, 8, 450, **kw))(jc)
    part, counts = map_store.partition_cloud(pc, 8, 450, **kw)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.sum()) < valid.sum()
    for f in dataclasses.fields(PointCloud):
        np.testing.assert_array_equal(getattr(part, f.name).numpy(),
                                      np.asarray(getattr(jpart, f.name)), err_msg=f.name)


def _tied_map(rng):
    """tests/test_map_store.py's 4096 random points, plus six points 2 m
    from a query along each axis (exact f32 distances, spread over several
    shards), so k = 4 must choose among six equal distances."""
    xyz = ((rng.random((4096, 3)) - 0.5) * 100).astype(np.float32)
    q0 = np.array([10.0, 10.0, 1.0], np.float32)
    xyz[:6] = q0 + 2.0 * np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    normal = rng.normal(size=xyz.shape).astype(np.float32)
    normal[::5] = 0.0   # zero normals: normal_ok False
    q = ((rng.random((64, 3)) - 0.5) * 100).astype(np.float32)
    q[0] = q0
    return xyz, normal, q


@pytest.fixture(scope="module")
def stores():
    xyz, normal, q = _tied_map(np.random.default_rng(0))
    jc, pc = _cloud_pair(xyz, np.ones(len(xyz), bool), normal)
    jstore = jax_map_store.ShardedMapStore(jax_get_mesh(8), per_shard=1024)
    jstore.set_model(jc)
    store = map_store.ShardedMapStore(get_mesh(8, device="cpu"), per_shard=1024)
    counts = store.set_model(pc)
    assert int(counts.sum()) == len(xyz)
    shards = map_store.voxel_shard_id(torch.from_numpy(xyz[:6]), 8)
    assert len(set(shards.tolist())) >= 3   # the ties cross shards
    return jstore, store, q, pc


def test_sharded_knn_matches_jax_and_global(stores):
    jstore, store, q, pc = stores
    d2, gidx, valid = store.knn(torch.from_numpy(q), k=4)
    jd2, jgidx, jvalid = jstore.knn(jnp.asarray(q), k=4)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(jgidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6)
    # Equal to the port's global search; the six ties take the lower shards.
    gd2, _, gvalid = neighbors.knn(torch.from_numpy(q), pc.xyz, pc.valid, k=4)
    assert torch.equal(d2, gd2) and torch.equal(valid, gvalid)
    assert torch.equal(d2[0], torch.full((4,), 4.0))
    # The global indices point at those distances' points in the layout.
    diff = torch.from_numpy(q)[:, None, :] - store.cloud.xyz[gidx.clamp(min=0)]
    np.testing.assert_allclose((diff * diff).sum(-1).numpy(), d2.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(np.sort(gidx[0].numpy() // 1024), gidx[0].numpy() // 1024)


def test_sharded_knn_gather_matches_jax(stores):
    jstore, store, q, _ = stores
    out = store.knn_gather(torch.from_numpy(q), k=4, radius=5.0)
    jout = jstore.knn_gather(jnp.asarray(q), k=4, radius=5.0)
    for name, a, b in zip(("d2", "xyz", "normal", "normal_ok", "valid"), out, jout):
        if name == "d2":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert 0 < int(out[4].sum()) < out[4].numel()   # the radius cuts some
    assert not out[3].all() and out[3].any()


def _ckpt_config():
    """tests/test_map_store.py::test_sharded_checkpoint_elastic_resume's."""
    return jax_cfg.Config(
        scan_registration=jax_cfg.ScanRegistrationConfig(
            sample_method=jax_cfg.SampleConfig(
                method="random", random=jax_cfg.RandomSampleConfig(max_points=600))),
        laser_odometry=jax_cfg.LaserOdometryConfig(
            target_mode="map", map=jax_cfg.MapConfig(voxel_size=0.4, capacity=8192),
            matching_method=jax_cfg.MatchingConfig(method="IMLS"),
            solve_method=jax_cfg.SolveConfig(
                method="RANSAC", iterations=30,
                ransac=jax_cfg.RANSACConfig(max_iterations=200, distance_threshold=0.2,
                                            final_solve_method="DRPM")),
            refresh_correspondences=False),
        sensor=jax_cfg.SensorConfig(n_scans=16, azimuth_resolution=2.0))


@pytest.fixture(scope="module")
def ckpt_scans():
    world = jax_synthetic.SyntheticWorld.corridor(seed=7, n_boxes=60, extent=30.0)
    scans, _ = jax_synthetic.synthetic_sequence(N_FRAMES, n_scans=16, azimuth_steps=180,
                                                speed=0.4, yaw_rate=0.01, seed=3, world=world)
    return scans


def _positions_apart(a, b):
    return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max()


def test_sharded_checkpoint_elastic_resume(ckpt_scans, tmp_path):
    """Save after 6 frames on 8 shards; resume on 8 (the uninterrupted
    poses) and on 4 shards (the map repartitioned by the same block hash)."""
    cfg = config_from_dict(dataclasses.asdict(_ckpt_config()))
    mesh8 = get_mesh(8, device="cpu")
    full = ShardedMapOdometry(cfg, mesh8, capacity=4096, seed=0)
    for s in ckpt_scans:
        full.process_scan(s)
    p_full = full.poses()

    half = ShardedMapOdometry(cfg, mesh8, capacity=4096, seed=0)
    for s in ckpt_scans[:RESUME_AFTER]:
        half.process_scan(s)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_sharded(half, path)
    for mesh, bound in ((mesh8, 1e-5), (get_mesh(4, device="cpu"), 5e-3)):
        res = ShardedMapOdometry(cfg, mesh, capacity=4096, seed=0)
        checkpoint.load_sharded(res, path)
        for s in ckpt_scans[RESUME_AFTER:]:
            res.process_scan(s)
        assert [f.index for f in res.trajectory] == list(range(RESUME_AFTER, N_FRAMES))
        d = _positions_apart(p_full[RESUME_AFTER:], res.poses())
        assert d < bound, (mesh.size, d)
        assert res.store.per_shard == 8192 // mesh.size


def test_jax_sharded_checkpoint_continues_in_the_port(ckpt_scans, tmp_path):
    """A plo_tpu save_sharded file (8 devices) loaded into the port at 4
    shards and continued with plo_tpu's draws, against plo_tpu's own
    continuation at 4 devices."""
    jcfg = _ckpt_config()
    jodo = JaxShardedMapOdometry(jcfg, jax_get_mesh(8), capacity=4096, seed=0)
    for s in ckpt_scans[:RESUME_AFTER]:
        jodo.process_scan(s)
    path = str(tmp_path / "jax_ckpt.npz")
    jax_checkpoint.save_sharded(jodo, path)
    jres = JaxShardedMapOdometry(jcfg, jax_get_mesh(4), capacity=4096, seed=0)
    jax_checkpoint.load_sharded(jres, path)
    for s in ckpt_scans[RESUME_AFTER:]:
        jres.process_scan(s)
    jax_poses = np.stack([f.pose for f in jres.trajectory])

    res = ShardedMapOdometry(config_from_dict(dataclasses.asdict(jcfg)),
                             get_mesh(4, device="cpu"), capacity=4096, seed=0)
    checkpoint.load_sharded(res, path)
    assert res.frame_count == RESUME_AFTER
    for k, s in enumerate(ckpt_scans[RESUME_AFTER:], start=RESUME_AFTER):
        res.process_scan(s, draws=JaxDraws(0, k))
    assert [f.iterations for f in res.trajectory] == [f.iterations for f in jres.trajectory]
    assert _positions_apart(res.poses(), jax_poses) < 1e-3
