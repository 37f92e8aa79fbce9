"""The port's two kernels (plo_tpu_torch/ops/cuda_nn.py) against the JAX
package's Pallas kernels in interpret mode and their XLA oracles, as
tests/test_pallas_nn.py runs them; plus the wrappers' dispatch rule.

On this CPU host the wrappers run their plain PyTorch versions (CPU tensors).
The CUDA kernels themselves are compared with those plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: counts and ranks exactly; dist_sum to rtol 2e-5 / atol 1e-4,
the f32 accumulation-order bound tests/test_pallas_nn.py uses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu.ops import pallas_nn
from plo_tpu.ops import sampling as jax_sampling
from plo_tpu_torch.ops import cuda_nn
from plo_tpu_torch.ops import sampling


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """One parallel sqrt on every torch CPU thread before any comparison. In a
    process where JAX has run, the first vectorized sqrt a fresh torch worker
    thread computes can come back far off the last bit on that thread's rows
    (seen with torch 2.13+cpu); later calls are within an ulp. A defect of the
    CPU math library, not of the code under test."""
    torch.sqrt(torch.rand(4096, 512))


def clouds(rng, q, t, scale):
    query = ((rng.random((q, 3)) - 0.5) * scale).astype(np.float32)
    normal = rng.normal(size=(q, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    target = ((rng.random((t, 3)) - 0.5) * scale).astype(np.float32)
    return query, normal, target


@pytest.mark.parametrize("live", [None, 1800])
def test_cylinder_stats_matches_pallas_and_xla(rng, live):
    """Full target and the t_live valid prefix (the ring-sorted layout:
    valid rows first, padding after)."""
    q, n, t = clouds(rng, 500, 4096, 20.0)
    tv = rng.random(4096) > 0.15 if live is None else np.arange(4096) < live
    args = (jnp.asarray(q), jnp.asarray(n), jnp.asarray(t), jnp.asarray(tv), 1.5, 0.5)
    t_live = None if live is None else jnp.asarray(live, jnp.int32)
    c_pal, s_pal = pallas_nn.cylinder_stats(*args, t_live=t_live, interpret=True)
    c_xla, s_xla = jax_sampling.cylinder_stats(*args)
    cuda_nn.reset_launches()
    c, s = cuda_nn.cylinder_stats(torch.from_numpy(q), torch.from_numpy(n), torch.from_numpy(t),
                                  torch.from_numpy(tv), 1.5, 0.5,
                                  t_live=None if live is None else torch.tensor(live, dtype=torch.int32))
    assert c.dtype == torch.int32 and s.dtype == torch.float32
    assert np.asarray(c_pal).sum() > 200  # not a vacuous comparison
    for cj, sj in ((c_pal, s_pal), (c_xla, s_xla)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=2e-5, atol=1e-4)
    assert cuda_nn.LAUNCHES["cylinder_stats"] == 0  # CPU tensors take the plain version


def _tables(rng, p=3000, n_bins=16, cap=256):
    xyz = rng.uniform(-20, 20, (p, 3)).astype(np.float32)
    bins = rng.integers(0, n_bins, p).astype(np.int32)
    member = rng.random(p) < 0.7
    return xyz, bins, member, n_bins, cap


@pytest.mark.parametrize("needed", [None, 40])
def test_fps_ranks_matches_pallas(rng, needed):
    """The rank table of one launch, from the same slot table, against the
    Pallas kernel in interpret mode."""
    xyz, bins, member, n_bins, cap = _tables(rng)
    scores = rng.random(len(xyz)).astype(np.float32)
    rank0, _ = jax_sampling._rank_within_bins(jnp.asarray(bins), jnp.asarray(member),
                                              jnp.asarray(scores), n_bins)
    rank0 = np.asarray(rank0)
    ok = member & (rank0 < cap)
    table_xyz = np.zeros((n_bins * cap, 3), np.float32)
    table_occ = np.zeros(n_bins * cap, np.float32)
    dest = bins[ok] * cap + rank0[ok]
    table_xyz[dest] = xyz[ok]
    table_occ[dest] = 1.0
    table_xyz = table_xyz.reshape(n_bins, cap, 3)
    table_occ = table_occ.reshape(n_bins, cap)
    steps = 200 if needed is None else needed
    r_pal = pallas_nn.fps_ranks(jnp.asarray(table_xyz), jnp.asarray(table_occ),
                                jnp.asarray(steps, jnp.int32), max_rank=200, interpret=True)
    r = cuda_nn.fps_ranks(torch.from_numpy(table_xyz), torch.from_numpy(table_occ),
                          torch.tensor(steps, dtype=torch.int32), 200)
    assert r.dtype == torch.int32
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_pal))
    assert (r.numpy() < 200).sum() > 100


@pytest.mark.parametrize("needed", [None, 40])
def test_fps_rank_within_bins_matches_xla_loop(rng, needed):
    """Table build (one packed scatter), traversal and scatter-back against
    plo_tpu's XLA while_loop form, on the draws JAX made."""
    xyz, bins, member, n_bins, cap = _tables(rng)
    key = jax.random.PRNGKey(3)
    old = jax_sampling._PALLAS_FPS
    jax_sampling._PALLAS_FPS = False
    try:
        r_xla, c_xla = jax_sampling.fps_rank_within_bins(
            jnp.asarray(xyz), jnp.asarray(bins), jnp.asarray(member), key, n_bins,
            bin_capacity=cap, max_rank=200, needed=needed)
    finally:
        jax_sampling._PALLAS_FPS = old
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (len(xyz),))))
    r, c = sampling.fps_rank_within_bins(
        torch.from_numpy(xyz), torch.from_numpy(bins).long(), torch.from_numpy(member), scores,
        n_bins, bin_capacity=cap, max_rank=200,
        needed=torch.tensor(200 if needed is None else needed))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_xla))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_xla))


def test_fps_table_payload_guard():
    p = 1 << 24
    with pytest.raises(ValueError, match="2\\*\\*24"):
        sampling.fps_rank_within_bins(torch.zeros((p, 3)), torch.zeros(p, dtype=torch.long),
                                      torch.zeros(p, dtype=torch.bool), torch.zeros(p), 64,
                                      1024, 200, torch.tensor(10))


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel: here, with no CUDA toolkit,
    the build raises — the wrapper does not quietly compute the plain form."""
    monkeypatch.setattr(cuda_nn, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_nn, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(cuda_nn, "_lib", None)
    monkeypatch.setattr(cuda_nn.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    cuda_nn.reset_launches()
    m = lambda *s, **kw: torch.zeros(*s, device="meta", **kw)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_nn.cylinder_stats(m(8, 3), m(8, 3), m(64, 3), m(64, dtype=torch.bool), 1.5, 0.5)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_nn.fps_ranks(m(4, 32, 3), m(4, 32), m((), dtype=torch.int32), 200)
    with pytest.raises(TypeError):
        cuda_nn.cylinder_stats(m(8, 3), m(8, 3), m(64, 3), m(64), 1.5, 0.5)  # valid not bool
    assert cuda_nn.LAUNCHES == {"cylinder_stats": 0, "fps_ranks": 0}
    assert list(tmp_path.iterdir()) == []
