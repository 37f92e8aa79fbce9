"""plo_tpu_torch — the PyTorch and CUDA port of plo_tpu's per-frame odometry.

The JAX package `plo_tpu/` beside this one is the reference: every module
here mirrors the module of the same name there, and tests/test_torch_*.py feed
both the same inputs. This package imports torch and numpy only, never JAX and
never `plo_tpu` (whose `__init__` imports JAX), so it runs on a GPU host that
has no JAX installed.

What the port covers, in `Odometry.process_scan` and `process_scans`:
  * the front-end: preprocess -> normals (pointcloud PCA or cross_product on
    the ring layout; the grid stencil's PCA, FALS or SRI on the range image)
    -> geometric-features, curvature or tensor-voting presample ->
    three-axis, random, normal or major-axis sampling;
  * matching: IMLS (euclidean, projected-distance, tensor-voting anchors) and
    plane-ICP in euclidean and projected mode;
  * solving: RANSAC/DRPM, Ceres (Huber Gauss-Newton), LS (trimmed), ICP
    (point-to-point Umeyama) and Teaser (k-core + GNC);
  * the target: the window of the last filtered clouds (target_mode
    "window") or a persistent world-frame voxel map ("map"), searched dense
    or through the grid hash, with a sync-free SO(3) projection of the world
    pose; optional per-point motion compensation (undistort);
  * windowed bundle adjustment (laser_odometry.ba, window mode), per frame
    and batched (parallel/ba.py), and loop closure on a finished trajectory
    (models/loopclosure.py: close_loops);
  * the saver's artifact mode (the per-iteration matched pairs and poses,
    utils/saver.py), checkpoint and resume (utils/checkpoint.py);
  * the command-line runner (`python -m plo_tpu_torch.cli`) over the
    synthetic simulator or a KITTI sequence read through the native
    prefetcher (io/kitti.py, native/), with ATE, RPE and KITTI drift
    (utils/evaluate.py) and torch.profiler traces (utils/profiling.py).
So every option of the single-device Config runs: the default `Config()`,
bench.py's config, every shipped config, map mode and the 36 combinations
of the method matrix (method_matrix.py). The four TPU kernels of plo_tpu
(nearest, projected_argmin, cylinder_stats, fps_ranks) are CUDA C++
kernels for sm_90a in csrc/, bound with ctypes in ops/cuda_nn.py.

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
