"""Gates and guards of the port held against plo_tpu on the same inputs, on
the CPU: radius gates squared in f32 as the JAX package squares its f32
radii (knn's radius, IMLS's h gate, the cached radius re-gate), knn's tie
order, and the count and warning for a scan longer than `capacity`.

Each gate test puts one target at exactly f32(0.1) from a query: its d2 is
f32(0.1)^2 rounded in f32 = 0.0100000007, which passes `d2 <= r^2` with r^2
squared in f32 (JAX) and fails it with r^2 squared in double (0.01 ->
0.0099999998). Tolerances: masks, indices and counters exactly; d2 to
rtol 1e-6, as tests/test_torch_ops.py::test_knn_matches_jax (XLA's CPU
fusion may round the sum of squares otherwise)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.ops import matching as jax_matching
from plo_tpu.ops import neighbors as jax_neighbors
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import cuda_nn, matching, neighbors

R = 0.1
F32_R = np.float32(R)


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module: the suite runs on 6 pytest workers
    side by side (tests/test_torch_headline.py says what a full pool a
    worker costs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_f32_square_differs_from_the_double_square_at_0_1():
    assert cuda_nn.f32_square(R) == float(np.float32(0.0100000007))
    assert float(np.float32(R * R)) < cuda_nn.f32_square(R)


def _clouds(xyz, normal):
    n = len(xyz)
    fields = dict(xyz=np.asarray(xyz, np.float32), normal=np.asarray(normal, np.float32),
                  intensity=np.zeros(n, np.float32), curvature=np.zeros(n, np.float32),
                  eigvals=np.zeros((n, 3), np.float32), valid=np.ones(n, bool))
    return (JaxCloud(**{k: jnp.asarray(v) for k, v in fields.items()}),
            PointCloud(**{k: torch.from_numpy(v.copy()) for k, v in fields.items()}))


# One query at the origin; target 0 sits at exactly f32(0.1) on x, the rest
# of a z = 0 plane lies farther out, so target 0 is the anchor.
PLANE = [[F32_R, 0, 0], [0.2, 0.15, 0], [-0.2, 0.1, 0], [0, -0.3, 0], [0.3, 0.3, 0],
         [-0.3, -0.2, 0]]
UP = [[0, 0, 1]] * len(PLANE)


def test_knn_radius_gate_squares_in_f32():
    q = np.zeros((1, 3), np.float32)
    t = np.asarray(PLANE, np.float32)
    tv = np.ones(len(t), bool)
    dj, ij, vj = jax_neighbors.knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv), k=3,
                                   radius=R)
    dp, ip, vp = neighbors.knn(torch.from_numpy(q), torch.from_numpy(t),
                               torch.from_numpy(tv), k=3, radius=R)
    assert bool(np.asarray(vj)[0, 0])           # JAX keeps the target on the gate
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=1e-6)


def _assert_counters_equal(rp, rj):
    np.testing.assert_array_equal(rp.valid.numpy(), np.asarray(rj.valid))
    for k, v in rj.counters.items():
        assert int(rp.counters[k]) == int(v), k


def test_imls_too_far_gate_squares_h_in_f32():
    """IMLS with h = 0.1: the anchor at exactly h passes `min_dist <= h^2`
    in JAX, so the query is kept, and in the port."""
    cfg_j = jax_cfg.IMLSConfig(h=R, r=0.5, search_number=5)
    cfg_p = port_cfg.IMLSConfig(h=R, r=0.5, search_number=5)
    src_j, src_p = _clouds([[0, 0, 0]], [[0, 0, 1]])
    tgt_j, tgt_p = _clouds(PLANE, UP)
    rj = jax_matching.imls_project(src_j, tgt_j, cfg_j, knn_select="exact")
    rp = matching.imls_project(src_p, tgt_p, cfg_p)
    assert bool(np.asarray(rj.valid)[0]) and int(rj.counters["too_far"]) == 0
    _assert_counters_equal(rp, rj)


def test_imls_cached_regate_squares_r_in_f32():
    """The cached evaluation re-gates its frozen candidates at r = 0.1: the
    candidate at exactly r stays present in JAX (the query then fails the
    MLS stage with one neighbor, not the too_far stage), and in the port."""
    cfg_j = jax_cfg.IMLSConfig(h=1.0, r=R, search_number=5)
    cfg_p = port_cfg.IMLSConfig(h=1.0, r=R, search_number=5)
    src_j, src_p = _clouds([[0, 0, 0]], [[0, 0, 1]])
    tgt_j, tgt_p = _clouds(PLANE, UP)
    nidx = np.arange(5)[None, :]
    nfound = np.ones((1, 5), bool)
    rj = jax_matching.imls_project_cached(
        src_j, tgt_j, cfg_j, (jnp.asarray(nidx, jnp.int32), jnp.asarray(nfound)))
    rp = matching.imls_project_cached(
        src_p, tgt_p, cfg_p, (torch.from_numpy(nidx), torch.from_numpy(nfound)))
    assert int(rj.counters["too_far"]) == 0 and int(rj.counters["mls_fail"]) == 1
    _assert_counters_equal(rp, rj)


@pytest.mark.parametrize("chunk", [None, 64, 100])
def test_knn_ties_take_the_lowest_index_as_jax(chunk):
    """Exact duplicates inside a chunk and across chunk boundaries, with more
    tied targets than k: indices and d2 equal to lax.top_k's choice."""
    rng = np.random.default_rng(5)
    t = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    t[100:130] = t[7]            # 31 copies of target 7: more ties than k
    t[250:260] = t[:10]          # copies across chunk boundaries
    t[470:] = t[60]
    q = np.concatenate([t[[7, 60, 3, 255]], rng.uniform(-1, 1, (60, 3))]).astype(np.float32)
    tv = np.ones(500, bool)
    tv[[110, 300]] = False
    dj, ij, vj = jax_neighbors.knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv), k=20,
                                   radius=0.4, chunk=chunk)
    dp, ip, vp = neighbors.knn(torch.from_numpy(q), torch.from_numpy(t),
                               torch.from_numpy(tv), k=20, radius=0.4, chunk=chunk)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    assert list(ip[0, :3]) == [7, 100, 101]


def test_oversized_scan_counts_and_warns_once_as_jax():
    """Two scans of capacity + 37 points through process_scan in both
    packages, on the same config: truncated_points counts 37 per frame and
    one RuntimeWarning over the two frames, with the same text."""
    cap = 8192
    scans, _ = synthetic.synthetic_sequence(2, n_scans=32, azimuth_steps=450, seed=3)
    raw = [s[:cap + 37] for s in scans]
    assert all(len(r) == cap + 37 for r in raw)
    cfg = dict(laser_odometry=dict(motion_prior=False),
               sensor=dict(n_scans=32, azimuth_resolution=360.0 / 450))
    odo = Odometry(port_cfg.Config(
        laser_odometry=port_cfg.LaserOdometryConfig(**cfg["laser_odometry"]),
        sensor=port_cfg.SensorConfig(**cfg["sensor"])), capacity=cap, seed=0, device="cpu")
    jodo = JaxOdometry(jax_cfg.Config(
        laser_odometry=jax_cfg.LaserOdometryConfig(**cfg["laser_odometry"]),
        sensor=jax_cfg.SensorConfig(**cfg["sensor"])), capacity=cap, seed=0, transfer="float32")
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        for r in raw:
            odo.process_scan(r)
    with warnings.catch_warnings(record=True) as jax_w:
        warnings.simplefilter("always")
        for r in raw:
            jodo.process_scan(r)
    port_w = [w for w in port_w if issubclass(w.category, RuntimeWarning)]
    jax_w = [w for w in jax_w if issubclass(w.category, RuntimeWarning)]
    assert odo.truncated_points == jodo.truncated_points == 2 * 37
    assert len(port_w) == len(jax_w) == 1
    assert str(port_w[0].message) == str(jax_w[0].message)
    assert len(odo.trajectory) == len(jodo.trajectory) == 2


@pytest.mark.parametrize("ties", [False, True])
def test_knn_float_pass_flags_straddling_ties_and_otherwise_equals_the_exact_pass(ties):
    """knn's float-topk pass is exact unless a tie straddles a chunk's k-th
    place, and says so: without ties it equals the pass on (d2, idx) keys;
    with 30 copies of one point (more than k) in one chunk it flags them."""
    rng = np.random.default_rng(11)
    t = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    if ties:
        t[300:330] = t[299]
    q = np.concatenate([t[[299, 5]], rng.uniform(-1, 1, (40, 3))]).astype(np.float32)
    tv = np.ones(700, bool)
    tv[650:] = False                 # +inf ties past the valid prefix never count
    args = [torch.from_numpy(a) for a in (q, t, tv)]
    fast, flagged = neighbors._knn_pass(*args, 20, 256, exact=False)
    exact, _ = neighbors._knn_pass(*args, 20, 256, exact=True)
    assert bool(flagged) == ties
    if not ties:
        assert torch.equal(fast, exact)
