"""The port's anchor searches, `nearest` and `projected_argmin`
(plo_tpu_torch/ops/cuda_nn.py, through plo_tpu_torch/ops/neighbors.py),
against the JAX package's Pallas kernels in interpret mode and their XLA
oracles `_nearest_xla` and `projected_knn(k=1)`, as tests/test_pallas_nn.py
runs them; plus the projected top-k and the gate rounding.

On this CPU host the wrappers run their plain PyTorch versions (CPU
tensors), and no kernel launches. The CUDA kernels are compared with the
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: indices and masks exactly. Distances: d2 to rtol 1e-6 and proj
to rtol 1e-4, the bounds tests/test_pallas_nn.py holds the Pallas kernels to
(the same f32 arithmetic; XLA may fuse it differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu.ops import neighbors as jax_nb
from plo_tpu.ops import pallas_nn
from plo_tpu_torch.ops import cuda_nn
from plo_tpu_torch.ops import neighbors


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """One parallel sqrt on every torch CPU thread before any comparison. In a
    process where JAX has run, the first vectorized sqrt a fresh torch worker
    thread computes can come back far off the last bit on that thread's rows
    (seen with torch 2.13+cpu); later calls are within an ulp. A defect of the
    CPU math library, not of the code under test."""
    torch.sqrt(torch.rand(4096, 512))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel launches."""
    cuda_nn.reset_launches()
    yield
    assert all(n == 0 for n in cuda_nn.LAUNCHES.values()), cuda_nn.LAUNCHES


def clouds(rng, q=300, t=3000, scale=100.0):
    query = ((rng.random((q, 3)) - 0.5) * scale).astype(np.float32)
    target = ((rng.random((t, 3)) - 0.5) * scale).astype(np.float32)
    tvalid = rng.random(t) > 0.15
    return query, target, tvalid


def unit_normals(rng, q):
    n = rng.normal(size=(q, 3)).astype(np.float32)
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def np_all(*tensors):
    return [np.asarray(t) for t in tensors]


@pytest.mark.parametrize("radius", [40.0, 5.0, np.inf])
def test_nearest_matches_pallas_and_xla(rng, radius):
    """Mirrors test_pallas_nearest_matches_xla; radius 5 leaves some
    queries without a neighbor in range."""
    q, t, tv = clouds(rng)
    d2, idx, val = np_all(*neighbors.nearest(*port(q, t, tv), radius=radius))
    assert idx.dtype == np.int32 and val.dtype == bool
    jargs = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv))
    for ref in (jax_nb._nearest_xla(*jargs, radius=radius),
                pallas_nn.nearest(*jargs, radius=radius, interpret=True)):
        d2r, ir, vr = np_all(*ref)
        np.testing.assert_array_equal(idx, ir)
        np.testing.assert_array_equal(val, vr)
        np.testing.assert_allclose(d2, d2r, rtol=1e-6)
    assert val.sum() > 0
    assert (~val).any() == (radius == 5.0)


def test_nearest_all_invalid(rng):
    """Mirrors test_pallas_nearest_all_invalid: idx -1, d2 +inf, not valid."""
    q, t, _ = clouds(rng, q=10, t=100)
    tv = np.zeros(100, bool)
    d2, idx, val = np_all(*neighbors.nearest(*port(q, t, tv)))
    np.testing.assert_array_equal(idx, -1)
    assert np.isposinf(d2).all() and not val.any()
    d2p, ip, vp = np_all(*pallas_nn.nearest(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv),
                                            interpret=True))
    np.testing.assert_array_equal(idx, ip)
    np.testing.assert_array_equal(val, vp)
    np.testing.assert_array_equal(d2, d2p)


@pytest.mark.parametrize("chunk", [None, 64])
def test_nearest_ties_take_the_lowest_index(rng, chunk):
    """Every target point appears three times, far apart in index (and, with
    chunk=64, in different chunks of the plain scan): the answer is the
    first copy, as both JAX forms give."""
    q, base, _ = clouds(rng, q=200, t=400, scale=20.0)
    t = np.concatenate([base, base, base])
    tv = np.ones(len(t), bool)
    tv[:50] = False                       # the first copy of some points is invalid
    q[:100] = base[rng.integers(0, 400, 100)]  # queries on target points: d2 = 0 ties
    d2, idx, _ = np_all(*cuda_nn.nearest_plain(*port(q, t, tv), chunk=chunk))
    jargs = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv))
    for ref in (jax_nb._nearest_xla(*jargs), pallas_nn.nearest(*jargs, interpret=True)):
        np.testing.assert_array_equal(idx, np.asarray(ref[1]))
    assert (idx < 400).sum() > 150 and (idx >= 400).any()  # both kinds of tie occur
    assert (d2[:100] == 0).all()


def test_projected_matches_pallas_and_xla(rng):
    """Mirrors test_pallas_projected_matches_xla (gates 10 and 4, whose
    squares are the same in f32 and in double)."""
    q, t, tv = clouds(rng, q=200, t=2000, scale=30.0)
    n = unit_normals(rng, 200)
    proj, idx, val = np_all(*neighbors.projected_argmin(*port(q, n, t, tv), 10.0, 4.0))
    assert idx.dtype == np.int32 and val.sum() > 100
    jargs = (jnp.asarray(q), jnp.asarray(n), jnp.asarray(t), jnp.asarray(tv), 10.0, 4.0)
    for ref in (jax_nb.projected_argmin(*jargs),
                pallas_nn.projected_argmin(*jargs, interpret=True)):
        pr, ir, vr = np_all(*ref)
        np.testing.assert_array_equal(val, vr)
        np.testing.assert_array_equal(idx, ir)
        np.testing.assert_allclose(proj[val], pr[val], rtol=1e-4)
    assert np.isposinf(proj[~val]).all()


def test_projected_gate_follows_the_xla_rounding():
    """plane-ICP's projected gates are (r^2, r_proj) = (2.25, 0.8). The XLA
    path the JAX package runs squares the traced f32 gate: f32(0.8)^2 =
    0.64000005. The Pallas kernel squares in double: 0.64 -> f32 0.64. A
    target whose p2 is exactly f32(0.64) therefore passes the XLA gate and
    fails the Pallas one. The port follows the XLA path."""
    b = np.float32(0.52915025)  # (b*b + 0.6*0.6) rounds to f32(0.64) exactly
    q = np.zeros((2, 3), np.float32)
    n = np.tile(np.float32([0.0, 0.0, 1.0]), (2, 1))
    t = np.float32([[0.6, b, 0.0],       # p2 = f32(0.64): on the gate
                    [0.9, 0.0, 0.0]])    # p2 = 0.81: out for every form
    tv = np.ones(2, bool)
    q[1] = [1.4, 0.5, 0.0]               # second query: p2 0.5 to target 1, 0.6408 to 0
    assert cuda_nn.f32_square(0.8) == float(np.float32(0.64000005))
    proj, idx, val = np_all(*neighbors.projected_argmin(*port(q, n, t, tv), 2.25, 0.8))
    np.testing.assert_array_equal(idx, [0, 1])
    np.testing.assert_array_equal(val, [True, True])
    assert proj[0] ** 2 == pytest.approx(0.64, rel=1e-6)
    jargs = (jnp.asarray(q), jnp.asarray(n), jnp.asarray(t), jnp.asarray(tv))
    _, ix, vx = np_all(*jax_nb.projected_knn(*jargs, 1, 2.25, 0.8))
    np.testing.assert_array_equal(ix[:, 0], idx)
    np.testing.assert_array_equal(vx[:, 0], val)
    _, ip, vp = np_all(*pallas_nn.projected_argmin(*jargs, 2.25, 0.8, interpret=True))
    np.testing.assert_array_equal(ip, [-1, 1])   # the Pallas form drops the boundary target
    np.testing.assert_array_equal(vp, [False, True])


@pytest.mark.parametrize("chunk", [None, 300])
def test_projected_knn_matches_xla(rng, chunk):
    """The general-k projected top-k (plain PyTorch in both packages):
    k = 4, ties and gate failures included."""
    q, t, tv = clouds(rng, q=150, t=1500, scale=20.0)
    t[750:] = t[:750]  # duplicates: ties between copies
    n = unit_normals(rng, 150)
    proj, idx, val = np_all(*neighbors.projected_knn(*port(q, n, t, tv), 4, 6.0, 1.5,
                                                     chunk=chunk))
    pr, ir, vr = np_all(*jax_nb.projected_knn(jnp.asarray(q), jnp.asarray(n), jnp.asarray(t),
                                              jnp.asarray(tv), 4, 6.0, 1.5))
    np.testing.assert_array_equal(val, vr)
    np.testing.assert_array_equal(idx[val], ir[vr])
    np.testing.assert_allclose(proj[val], pr[vr], rtol=1e-4)
    assert val.sum() > 200 and (~val).any()
    # k=1 of the top-k is the argmin
    p1, i1, v1 = np_all(*neighbors.projected_argmin(*port(q, n, t, tv), 6.0, 1.5))
    np.testing.assert_array_equal(i1, idx[:, 0])
    np.testing.assert_array_equal(v1, val[:, 0])
