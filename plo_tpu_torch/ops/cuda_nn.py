"""Hand-written CUDA kernels of the per-frame path and their plain PyTorch
versions — the counterpart of plo_tpu/ops/pallas_nn.py.

  cylinder_stats  csrc/cylinder_stats.cu  replaces pallas_nn.cylinder_stats
  fps_ranks       csrc/fps_ranks.cu       replaces pallas_nn.fps_ranks

The sources have a plain C interface. `build()` compiles both with one
`nvcc` call into `_build/libplo_kernels.so` at first use (the directory is
git-ignored), and ctypes loads it: pointers and the stream go over as
`c_void_p`, and each C entry returns cudaGetLastError(), which the wrapper
raises on.

Dispatch rule: a wrapper takes its plain version only when its tensors lie on
the CPU. A CUDA tensor launches the kernel or raises; nothing falls back.
`LAUNCHES` counts kernel launches per wrapper, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("cylinder_stats.cu", "fps_ranks.cu")
LIBRARY = os.path.join(BUILD_DIR, "libplo_kernels.so")

# fps_ranks keeps a bin's x, y, z and min-d2 in shared memory (16 B a slot),
# within the 48 KB a block gets without opting in to more.
FPS_MAX_SLOTS = 3072

LAUNCHES = {"cylinder_stats": 0, "fps_ranks": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host with the CUDA toolkit")


def nvcc_command(output: str):
    """The one nvcc call that builds every kernel of the package."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", output,
            *[os.path.join(CSRC_DIR, s) for s in SOURCES]]


def build():
    """Compile the kernels into LIBRARY. Returns (seconds, compiler output)."""
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = nvcc_command(tmp)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return seconds, proc.stdout + proc.stderr


def _stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > built for s in SOURCES)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than its
    sources."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIBRARY)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.plo_cylinder_splits.argtypes = []
            lib.plo_cylinder_splits.restype = ci
            lib.plo_cylinder_stats.argtypes = [vp, vp, ci, vp, vp, ci, vp, cf, cf,
                                               vp, vp, vp, vp, vp]
            lib.plo_cylinder_stats.restype = ci
            lib.plo_fps_ranks.argtypes = [vp, vp, ci, ci, vp, ci, vp, vp]
            lib.plo_fps_ranks.restype = ci
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# cylinder_stats
# ---------------------------------------------------------------------------

def cylinder_stats_plain(query, normal, target, target_valid, r_proj: float,
                         r: float, chunk: int = 512):
    """Plain PyTorch form of plo_tpu/ops/sampling.py::cylinder_stats: per
    query, the count of valid targets with d2 < r_proj^2 and
    d2 |n|^2 - (d.n)^2 < r^2, and the sum of sqrt(d2) over them.
    Returns (count [Q] i32, dist_sum [Q] f32)."""
    nx, ny, nz = normal[:, 0:1], normal[:, 1:2], normal[:, 2:3]
    n2 = nx * nx + ny * ny + nz * nz
    cnt = torch.zeros(query.shape[0], dtype=torch.int32, device=query.device)
    dsum = torch.zeros(query.shape[0], dtype=torch.float32, device=query.device)
    for base in range(0, target.shape[0], chunk):
        tc = target[base:base + chunk]
        dx = query[:, 0:1] - tc[None, :, 0]
        dy = query[:, 1:2] - tc[None, :, 1]
        dz = query[:, 2:3] - tc[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        dn = dx * nx + dy * ny + dz * nz
        p2 = d2 * n2 - dn * dn
        ok = target_valid[None, base:base + chunk] & (d2 < r_proj * r_proj) & (p2 < r * r)
        cnt += ok.sum(1, dtype=torch.int32)
        dsum += torch.where(ok, torch.sqrt(d2), 0.0).sum(1)
    return cnt, dsum


def cylinder_stats(query: torch.Tensor, normal: torch.Tensor, target: torch.Tensor,
                   target_valid: torch.Tensor, r_proj: float, r: float,
                   t_live: Optional[torch.Tensor] = None):
    """Per-query cylinder-gate neighbor statistics (pallas_nn.cylinder_stats).
    query, normal [Q, 3] f32; target [T, 3] f32; target_valid [T] bool;
    t_live: optional int32 scalar tensor, an upper bound on the last valid
    target index + 1 (the ring counting sort makes the valid targets a prefix).
    Returns (count [Q] i32, dist_sum [Q] f32)."""
    if query.device.type == "cpu":
        if t_live is not None:  # exact: every target past t_live is invalid
            n = int(t_live)
            target, target_valid = target[:n], target_valid[:n]
        return cylinder_stats_plain(query, normal, target, target_valid, r_proj, r)
    dev = query.device
    q, t = query.shape[0], target.shape[0]
    _check("query", query, torch.float32, (q, 3), dev)
    _check("normal", normal, torch.float32, (q, 3), dev)
    _check("target", target, torch.float32, (t, 3), dev)
    _check("target_valid", target_valid, torch.bool, (t,), dev)
    if t_live is not None:
        _check("t_live", t_live, torch.int32, (), dev)
    cnt = torch.empty(q, dtype=torch.int32, device=dev)
    dsum = torch.empty(q, dtype=torch.float32, device=dev)
    if q == 0:
        return cnt, dsum
    lib = library()
    splits = lib.plo_cylinder_splits()
    part_cnt = torch.empty((splits, q), dtype=torch.int32, device=dev)
    part_sum = torch.empty((splits, q), dtype=torch.float32, device=dev)
    err = lib.plo_cylinder_stats(
        query.data_ptr(), normal.data_ptr(), q, target.data_ptr(),
        target_valid.data_ptr(), t, None if t_live is None else t_live.data_ptr(),
        float(r_proj) ** 2, float(r) ** 2, part_cnt.data_ptr(), part_sum.data_ptr(),
        cnt.data_ptr(), dsum.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "cylinder_stats")
    LAUNCHES["cylinder_stats"] += 1
    return cnt, dsum


# ---------------------------------------------------------------------------
# fps_ranks
# ---------------------------------------------------------------------------

def fps_ranks_plain(table_xyz: torch.Tensor, table_occ: torch.Tensor, steps,
                    max_rank: int) -> torch.Tensor:
    """Plain PyTorch form of the while_loop in plo_tpu/ops/sampling.py::
    fps_rank_within_bins: farthest-first ranks over every bin of a [B, C]
    slot table, lowest index on ties, max_rank where unassigned."""
    occ = table_occ > 0.5
    b, c = occ.shape
    col = torch.arange(c, device=occ.device)[None, :]
    x, y, z = table_xyz[..., 0], table_xyz[..., 1], table_xyz[..., 2]

    def d2_to(sel):
        sel = sel[:, None]
        dx = x - x.gather(1, sel)
        dy = y - y.gather(1, sel)
        dz = z - z.gather(1, sel)
        return dx * dx + dy * dy + dz * dz

    first = torch.argmax(occ.to(torch.float32), dim=1)   # first max: lowest slot
    any_occ = occ.any(dim=1)
    is_first = col == first[:, None]
    min_d = torch.where(occ & ~is_first, d2_to(first), -math.inf)
    ranks = torch.where(is_first & any_occ[:, None], 0, max_rank).to(torch.int32)
    for i in range(1, int(steps)):
        nxt = torch.argmax(min_d, dim=1)
        has = min_d.gather(1, nxt[:, None])[:, 0] > -math.inf
        is_nxt = col == nxt[:, None]
        ranks = torch.where(is_nxt & has[:, None], i, ranks)
        new_min = torch.where(is_nxt, -math.inf,
                              torch.minimum(min_d, torch.where(occ, d2_to(nxt), -math.inf)))
        min_d = torch.where(has[:, None], new_min, min_d)
    return ranks


def fps_ranks(table_xyz: torch.Tensor, table_occ: torch.Tensor, steps: torch.Tensor,
              max_rank: int) -> torch.Tensor:
    """Batched per-bin farthest-first ranks (pallas_nn.fps_ranks):
    table_xyz [B, C, 3] f32, table_occ [B, C] f32, steps: int32 scalar tensor
    (ranks 0..steps-1 are assigned) -> ranks [B, C] i32."""
    if table_xyz.device.type == "cpu":
        return fps_ranks_plain(table_xyz, table_occ, steps, max_rank)
    dev = table_xyz.device
    b, c = table_occ.shape
    _check("table_xyz", table_xyz, torch.float32, (b, c, 3), dev)
    _check("table_occ", table_occ, torch.float32, (b, c), dev)
    _check("steps", steps, torch.int32, (), dev)
    if c > FPS_MAX_SLOTS:
        raise ValueError(f"fps_ranks: {c} slots per bin, at most {FPS_MAX_SLOTS}")
    ranks = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0 or c == 0:
        return ranks
    err = library().plo_fps_ranks(
        table_xyz.data_ptr(), table_occ.data_ptr(), b, c, steps.data_ptr(),
        int(max_rank), ranks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fps_ranks")
    LAUNCHES["fps_ranks"] += 1
    return ranks
