"""plo_tpu_torch — the PyTorch and CUDA port of plo_tpu's per-frame odometry.

The JAX package `plo_tpu/` beside this one is the reference: every module
here mirrors the module of the same name there, and tests/test_torch_*.py feed
both the same inputs. This package imports torch and numpy only, never JAX and
never `plo_tpu` (whose `__init__` imports JAX), so it runs on a GPU host that
has no JAX installed.

What the port covers, in `Odometry.process_scan` and `process_scans` with
target_mode="window":
  * the front-end: preprocess -> PCA normals (pointcloud, or the grid stencil
    on the range image) -> geometric-features, curvature or tensor-voting
    presample -> three-axis, random, normal or major-axis sampling;
  * matching: IMLS (euclidean, projected-distance, tensor-voting anchors) and
    plane-ICP in euclidean and projected mode;
  * solving: RANSAC/DRPM, Ceres (Huber Gauss-Newton), LS (trimmed), ICP
    (point-to-point Umeyama) and Teaser (k-core + GNC).
So the default `Config()`, bench.py's config, the shipped configs but the
FALS one, and the 36 combinations of the method matrix (method_matrix.py)
run. The four TPU kernels of plo_tpu (nearest, projected_argmin,
cylinder_stats, fps_ranks) are CUDA C++ kernels for sm_90a in csrc/, bound
with ctypes in ops/cuda_nn.py. Cross-product, FALS and SRI normals, map
mode, BA and undistortion raise NotImplementedError.

Entry points take an explicit `device`. `None` means the CUDA card and raises
where there is none; the CPU runs only when a caller asks for it
(`device="cpu"`, as the tests do).
"""
from __future__ import annotations

import torch

# Geometry code is precision-sensitive (plo_tpu forces f32 matmuls for the
# same reason): RANSAC seeding uses matmul-form distances and the solvers
# use SVDs, so TF32 must never stand in for f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plo_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
