"""Each CUDA kernel of the port against its plain PyTorch version on the card.

These tests need a CUDA card and skip without one. This file imports neither
JAX nor plo_tpu, so it also runs on a GPU host without JAX, where
tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: counts and ranks exactly; dist_sum to rtol 2e-5 / atol 1e-4
(f32 sums in another order)."""
import numpy as np
import pytest
import torch

from plo_tpu_torch.ops import cuda_nn


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
