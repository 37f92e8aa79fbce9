"""plo_tpu_torch — the PyTorch and CUDA port of plo_tpu's per-frame odometry.

The JAX package `plo_tpu/` beside this one is the reference: every module
here mirrors the module of the same name there, and tests/test_torch_*.py feed
both the same inputs. This package imports torch and numpy only, never JAX and
never `plo_tpu` (whose `__init__` imports JAX), so it runs on a GPU host that
has no JAX installed.

What the port covers: the default `Config()` pointcloud pipeline
(preprocess -> PCA normals -> geometric-features presample -> normal /
major-axis sampling) and the IMLS + RANSAC/DRPM ICP loop of
`Odometry.process_scan` in target_mode="window". The two TPU kernels on that
path (cylinder_stats, fps_ranks) are CUDA C++ kernels for sm_90a in csrc/,
bound with ctypes in ops/cuda_nn.py.

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
