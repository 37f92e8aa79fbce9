"""The grid-hash neighbor search (ops/grid_hash.py) and IMLS's search through
it (matching.imls_search_grid) against plo_tpu's, on the same numpy inputs.

plo_tpu's odometry compiles the cell edge into its program as a constant,
and XLA then rewrites floor(xyz / cell) into floor(xyz * (1 / cell)) with
the f32 reciprocal, which floors differently on some cell boundaries. The
port computes the cells that way, so the JAX side here runs each function
inside a jit that closes over the cell edge, as the odometry calls it.

Tolerances: bucket ids, sort orders, bucket starts, indices and masks
exactly; distances bit for bit (the port's sum of squares emulates the fma
chain XLA's CPU backend fuses it into)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.ops import grid_hash as jax_grid_hash
from plo_tpu.ops import matching as jax_matching
from plo_tpu.ops import voxel as jax_voxel
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.ops import grid_hash, matching, neighbors


def t(a):
    return torch.from_numpy(np.array(a))


def boundary_points(rng, n, cell):
    """Points on cell boundaries (k * cell in f32), some moved one ulp up or
    down, and a few well inside cells; coordinates 0 stay 0 (XLA's CPU
    flushes subnormals to zero, which one ulp from 0 would be)."""
    k = rng.integers(-200, 200, (n, 3))
    xyz = (k * np.float32(cell)).astype(np.float32)
    step = rng.choice([-1, 0, 1], (n, 3))
    xyz = np.where(step > 0, np.nextafter(xyz, np.float32(np.inf)),
                   np.where(step < 0, np.nextafter(xyz, np.float32(-np.inf)), xyz))
    xyz = np.where(k == 0, 0.0, xyz).astype(np.float32)
    xyz[: n // 10] += rng.uniform(0, cell, (n // 10, 3)).astype(np.float32)
    return xyz


@pytest.mark.parametrize("n_buckets", [1 << 17, 1 << 19, 1000, 7])
def test_hash_bucket_matches_jax_bit_for_bit(rng, n_buckets):
    """Cells with negative, zero and large coordinates (int32 extremes, where
    the prime sums wrap around) hash to plo_tpu's buckets."""
    i32 = np.iinfo(np.int32)
    cells = np.concatenate([
        rng.integers(i32.min, i32.max, (4000, 3), endpoint=True),
        rng.integers(-100, 100, (4000, 3)),
        np.array([[i32.min] * 3, [i32.max] * 3, [0, 0, 0], [-1, -1, -1],
                  [i32.max, i32.min, 0]])]).astype(np.int32)
    ref = np.asarray(jax_grid_hash.hash_bucket(jnp.asarray(cells), n_buckets))
    out = grid_hash.hash_bucket(t(cells), n_buckets).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.min() >= 0 and out.max() < n_buckets


def test_cells_take_the_f32_reciprocal():
    """floor(x * (1 / c)), as XLA compiles x / c for a constant c: equal to
    plo_tpu's cells of a jitted constant cell edge, and different from the
    true division on some boundary points (the trap this pins)."""
    xyz = boundary_points(np.random.default_rng(1), 20000, 0.3)
    ref = np.asarray(jax.jit(lambda x: jnp.floor(x / 0.3).astype(jnp.int32))(jnp.asarray(xyz)))
    np.testing.assert_array_equal(grid_hash.cell_coords(t(xyz), 0.3).numpy(), ref)
    assert (np.floor(xyz / np.float32(0.3)) != ref).any()


def test_sum_sq3_is_xla_fused_sum(rng):
    """sum(d * d, -1) bit for bit as XLA's CPU backend computes it."""
    d = rng.uniform(-50, 50, (50000, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jnp.sum(x * x, axis=-1))(jnp.asarray(d)))
    np.testing.assert_array_equal(grid_hash.sum_sq3(t(d)).numpy(), ref)


def _map_like(rng, n=6000, cell=0.3):
    """Boundary points with repeated points (exact distance ties) and some
    invalid rows."""
    xyz = boundary_points(rng, n, cell)
    xyz[:300] = xyz[300:600]
    valid = rng.random(n) > 0.15
    return xyz, valid


@pytest.mark.parametrize("cell", [0.3, 1.0])
def test_build_matches_jax(rng, cell):
    xyz, valid = _map_like(rng, cell=cell)
    gh_j = jax.jit(lambda x, v: jax_grid_hash.build(x, v, cell, 1 << 12))(
        jnp.asarray(xyz), jnp.asarray(valid))
    gh_p = grid_hash.build(t(xyz), t(valid), cell, 1 << 12)
    for f in ("xyz_sorted", "cell_sorted", "order", "starts"):
        np.testing.assert_array_equal(getattr(gh_p, f).numpy(), np.asarray(getattr(gh_j, f)), f)


@pytest.mark.parametrize("cell,m,k", [(0.3, 16, 8), (0.6, 4, 20), (1.5, 128, 20), (1.0, 1, 1)],
                         ids=["small-cells", "truncated-cells", "map-default", "k1-m1"])
def test_knn_matches_jax_with_ties(rng, cell, m, k):
    """27-cell kNN: queries on repeated points (d2 = 0 ties, to the lowest
    candidate position, as lax.top_k) and on cell boundaries; cells
    truncated at m; k above the found count."""
    xyz, valid = _map_like(rng, cell=0.3)
    q = np.concatenate([xyz[300:400], boundary_points(rng, 400, cell),
                        xyz[rng.integers(0, len(xyz), 500)] + rng.normal(0, 0.1, (500, 3))])
    q = q.astype(np.float32)
    fn = jax.jit(lambda x, v, qq: jax_grid_hash.knn(jax_grid_hash.build(x, v, cell, 1 << 12),
                                                    qq, k, 1.0, m=m))
    ref = fn(jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(q))
    out = grid_hash.knn(grid_hash.build(t(xyz), t(valid), cell, 1 << 12), t(q), k, 1.0, m=m)
    assert int(np.asarray(ref[2]).sum()) > 200
    for a, b, what in zip(out, ref, ("d2", "idx", "valid")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), what)
    d2, idx, ok = grid_hash.nearest(grid_hash.build(t(xyz), t(valid), cell, 1 << 12), t(q),
                                    1.0, m=m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[1])[:, 0])


def _voxel_map(rng, n=12000):
    """A voxel map at 0.3 m (plo_tpu's voxel_map_insert of a scattered
    cloud): at most one point a voxel, so a 1.5 m cell holds at most 125."""
    xyz = np.concatenate([rng.uniform(-12, 12, (n, 3)) * np.array([1, 1, 0.25]),
                          rng.uniform(-12, 12, (n // 4, 3)) * np.array([1, 0.05, 0.3])])
    new = JaxCloud.from_xyz(jnp.asarray(xyz.astype(np.float32)))
    new = JaxCloud(xyz=new.xyz, normal=jnp.asarray(
        np.tile(np.array([0, 0, 1], np.float32), (len(xyz), 1))), intensity=new.intensity,
        curvature=new.curvature, eigvals=new.eigvals, valid=new.valid)
    m = jax_voxel.voxel_map_insert(JaxCloud.zeros(16384), new, 0.3, jnp.zeros(3, jnp.float32))
    arrays = {f: np.asarray(getattr(m, f)) for f in
              ("xyz", "normal", "intensity", "curvature", "eigvals", "valid")}
    return m, PointCloud(**{f: t(a) for f, a in arrays.items()})


def test_imls_search_grid_matches_jax_and_the_dense_search(rng):
    """imls_search_grid on a voxel map: equal to plo_tpu's (run as its ICP
    step runs it, inside one jit) and, where the exact dense search's k
    neighbors all lie within the 1.5 m cell (the grid's contract: exact
    within min(r, cell) when a cell holds at most m points), the same
    candidate sets; elsewhere every grid neighbor is a valid map point within
    the radius (it misses neighbors, never invents them)."""
    map_j, map_p = _voxel_map(rng)
    assert int(map_p.valid.sum()) > 8000
    live = np.nonzero(np.asarray(map_j.valid))[0]
    src = (np.asarray(map_j.xyz)[rng.choice(live, 1500)]
           + rng.normal(0, 0.2, (1500, 3))).astype(np.float32)
    cfg_j, cfg_p = jax_cfg.IMLSConfig(), port_cfg.IMLSConfig()
    fn = jax.jit(lambda s, tgt: jax_matching.imls_search_grid(
        JaxCloud.from_xyz(s), tgt, cfg_j, 1.5, 128, 1 << 17))
    idx_j, ok_j = fn(jnp.asarray(src), map_j)
    idx_p, ok_p = matching.imls_search_grid(t(src), map_p, cfg_p, 1.5, 128, 1 << 17)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    assert int(ok_p.sum()) > 1500 * 10
    d2_d, idx_d, ok_d = (x.numpy() for x in neighbors.knn(
        t(src), map_p.xyz, map_p.valid, k=cfg_p.search_number, radius=cfg_p.r))
    inside = ok_d.all(1) & (d2_d[:, -1] < 1.5 ** 2 * (1 - 1e-6))
    assert inside.sum() > 1000
    for a, va, b, vb, full in zip(idx_d, ok_d, idx_p.numpy(), ok_p.numpy(), inside):
        if full:
            assert set(b[vb]) == set(a[va])
    found = idx_p.numpy()[ok_p.numpy()]
    rows = np.nonzero(ok_p.numpy())[0]
    assert map_p.valid.numpy()[found].all()
    d = np.linalg.norm(map_p.xyz.numpy()[found] - src[rows], axis=1)
    assert (d <= cfg_p.r + 1e-5).all()
