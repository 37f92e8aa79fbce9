"""The voxel map and voxel downsampling (ops/voxel.py) against plo_tpu's on
the same numpy inputs.

The JAX side runs inside a jit that closes over the leaf size, as plo_tpu's
odometry compiles its map insert (the leaf a constant, so XLA floors
xyz * (1 / leaf); tests/test_torch_grid_hash.py pins that).

Tolerances: voxel_map_insert exactly, every field and the map's order
(integer and ordering work only); voxel_downsample's masks and counts
exactly, its averages within 1e-6 relative (f32 scatter-adds in another
order than XLA's)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.ops import voxel as jax_voxel
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.ops import voxel

FIELDS = [f.name for f in dataclasses.fields(PointCloud)]


def cloud(rng, n, scale, frac):
    return {"xyz": (rng.normal(size=(n, 3)) * scale).astype(np.float32),
            "normal": rng.normal(size=(n, 3)).astype(np.float32),
            "intensity": rng.random(n).astype(np.float32),
            "curvature": rng.random(n).astype(np.float32),
            "eigvals": rng.random((n, 3)).astype(np.float32),
            "valid": rng.random(n) < frac}


def jax_of(a):
    return JaxCloud(**{f: jnp.asarray(a[f]) for f in FIELDS})


def port_of(a):
    return PointCloud(**{f: torch.from_numpy(np.array(a[f])) for f in FIELDS})


def insert_both(map_a, new_a, center, leaf=0.3, n_buckets=1 << 19):
    fn = jax.jit(lambda m, c, ctr: jax_voxel.voxel_map_insert(m, c, leaf, ctr, n_buckets))
    ref = fn(jax_of(map_a), jax_of(new_a), jnp.asarray(center))
    out = voxel.voxel_map_insert(port_of(map_a), port_of(new_a), leaf,
                                 torch.from_numpy(center), n_buckets)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), f)
    return out


def test_voxel_map_insert_semantics():
    """plo_tpu's semantics test on the port (tests/test_map_mode.py): first
    arrival wins inside a voxel, occupied voxels keep their point, the
    farthest from the center leave first."""
    zeros = lambda n: {"xyz": np.zeros((n, 3), np.float32), "normal": np.zeros((n, 3), np.float32),
                       "intensity": np.zeros(n, np.float32), "curvature": np.zeros(n, np.float32),
                       "eigvals": np.zeros((n, 3), np.float32), "valid": np.zeros(n, bool)}

    def of(xyz):
        a = zeros(len(xyz))
        a["xyz"], a["valid"] = np.asarray(xyz, np.float32), np.ones(len(xyz), bool)
        return a

    center = np.zeros(3, np.float32)
    m1 = insert_both(zeros(64), of([[0.1, 0.1, 0.1], [0.15, 0.12, 0.11],
                                    [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), center)
    kept = {tuple(round(float(x), 3) for x in p) for p in m1.xyz.numpy()[m1.valid.numpy()]}
    assert len(kept) == 3 and (0.1, 0.1, 0.1) in kept and (0.15, 0.12, 0.11) not in kept
    m1a = {f: getattr(m1, f).numpy() for f in FIELDS}
    m2 = insert_both(m1a, of([[0.12, 0.13, 0.14], [2.0, 2.0, 0.0]]), center)
    kept = {tuple(round(float(x), 3) for x in p) for p in m2.xyz.numpy()[m2.valid.numpy()]}
    assert len(kept) == 4 and (2.0, 2.0, 0.0) in kept and (0.12, 0.13, 0.14) not in kept
    rng = np.random.default_rng(0)
    both = of(np.concatenate([rng.uniform(50, 60, (6, 3)), rng.uniform(-1, 1, (6, 3))]))
    m3 = insert_both(zeros(8), both, center)
    assert (np.linalg.norm(m3.xyz.numpy()[m3.valid.numpy()], axis=1) < 10).sum() == 6


@pytest.mark.parametrize("case", ["first-arrival", "occupied", "eviction", "boundaries",
                                  "empty-map"])
def test_voxel_map_insert_matches_jax(rng, case):
    """Exactly plo_tpu's map: which points enter (first arrival inside a
    voxel, none into an occupied voxel), and the order after the stable
    distance sort, with eviction of the farthest when the union overflows."""
    map_a = cloud(rng, 4096, 5.0, 0.4)
    new_a = cloud(rng, 3000, 6.0, 0.9)
    center = np.array([0.3, -0.2, 0.1], np.float32)
    if case == "first-arrival":
        new_a["xyz"][100:400] = new_a["xyz"][400:700] + 0.01    # several points a voxel
    elif case == "occupied":
        new_a["xyz"][:1500] = map_a["xyz"][:1500] + 0.02
    elif case == "eviction":
        map_a["valid"][:] = rng.random(4096) < 0.9              # the union overflows 4,096
        new_a["xyz"][:200] = new_a["xyz"][200:400]               # equal distances
    elif case == "boundaries":
        k = rng.integers(-40, 40, (3000, 3))
        xyz = (k * np.float32(0.3)).astype(np.float32)
        new_a["xyz"] = np.where(k == 0, 0.0, np.nextafter(
            xyz, np.where(rng.random((3000, 3)) < 0.5, np.float32(-np.inf), np.float32(np.inf))
        )).astype(np.float32)
    else:
        map_a["valid"][:] = False
    out = insert_both(map_a, new_a, center)
    n_valid = int(out.valid.sum())
    assert n_valid > 2000
    if case == "eviction":
        assert n_valid == 4096
    d = np.linalg.norm(out.xyz.numpy()[: n_valid] - center, axis=1)
    assert (np.diff(d) >= -1e-5).all()     # valid prefix in distance order


@pytest.mark.parametrize("out_size", [2048, 8192])
def test_voxel_downsample_matches_jax(rng, out_size):
    """Centroids per voxel: the same voxels in the same (bucket) order and
    the same mask; averages within f32 rounding of plo_tpu's."""
    a = cloud(rng, 6000, 4.0, 0.9)
    a["xyz"][:2000] = a["xyz"][2000:4000] + 0.05
    fn = jax.jit(lambda c: jax_voxel.voxel_downsample(c, 0.5, out_size, 1 << 14))
    ref = fn(jax_of(a))
    out = voxel.voxel_downsample(port_of(a), 0.5, out_size, 1 << 14)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    assert valid.sum() > 1000
    for f in ("xyz", "normal", "intensity", "curvature", "eigvals"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(out, f).numpy(), r, rtol=1e-6, atol=1e-6, err_msg=f)
