"""Hand-written CUDA kernels of the per-frame path and their plain PyTorch
versions — the counterpart of plo_tpu/ops/pallas_nn.py.

  nearest           csrc/nearest.cu           replaces pallas_nn.nearest
  projected_argmin  csrc/projected_argmin.cu  replaces pallas_nn.projected_argmin
  cylinder_stats    csrc/cylinder_stats.cu    replaces pallas_nn.cylinder_stats
  fps_ranks         csrc/fps_ranks.cu         replaces pallas_nn.fps_ranks

The sources have a plain C interface. `build()` compiles all of them with one
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

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("nearest.cu", "projected_argmin.cu", "cylinder_stats.cu", "fps_ranks.cu")
HEADERS = ("cp_async.cuh", "tile_stream.cuh")
LIBRARY = os.path.join(BUILD_DIR, "libplo_kernels.so")

# fps_ranks keeps a bin's slots in registers, at most 6 a thread of 512, and a
# copy of its rows in shared memory (12 B a slot, within the 48 KB a block
# gets without opting in to more).
FPS_MAX_SLOTS = 3072

LAUNCHES = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}

# Largest [Q, chunk] block one chunk of a plain search materializes (128 MB
# of f32): PyTorch runs eagerly, so each elementwise step writes a block.
_CHUNK_ELEMS = 1 << 25

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
    return any(os.path.getmtime(os.path.join(CSRC_DIR, s)) > built for s in SOURCES + HEADERS)


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
            lib.plo_nearest_scratch.argtypes = [ci]
            lib.plo_nearest_scratch.restype = ci
            lib.plo_nearest.argtypes = [vp, ci, vp, vp, ci, cf, vp, vp, vp, vp, vp]
            lib.plo_nearest.restype = ci
            lib.plo_projected_scratch.argtypes = [ci]
            lib.plo_projected_scratch.restype = ci
            lib.plo_projected_argmin.argtypes = [vp, vp, ci, vp, vp, ci, cf, cf,
                                                 vp, vp, vp, vp, vp]
            lib.plo_projected_argmin.restype = ci
            lib.plo_cylinder_splits.argtypes = [ci]
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


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself if its data starts on a 16-byte boundary, else a copy (a
    fresh allocation is aligned): the tile kernels copy 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def f32_square(x: float) -> float:
    """x squared in float32 arithmetic, as XLA squares a traced f32 gate:
    f32(0.8)**2 is 0.64000005 here, where a double square rounds to 0.64."""
    x = np.float32(x)
    return float(x * x)


def chunk_size(q: int, t: int) -> int:
    """Target chunk of a plain [Q, T] search: at most _CHUNK_ELEMS a block."""
    return max(4096, min(t, _CHUNK_ELEMS // max(q, 1)))


def _merge_min(best_v, best_i, cand, base: int):
    """Fold one chunk's [Q, C] candidate values into the running (min, idx):
    the chunk's first minimum, taken only when strictly smaller, so a tie
    keeps the lower index (jnp.argmin and the scan merge of
    plo_tpu/ops/neighbors.py)."""
    cmin, carg = cand.min(dim=1)
    take = cmin < best_v
    return (torch.where(take, cmin, best_v),
            torch.where(take, carg.to(torch.int32) + base, best_i))


# ---------------------------------------------------------------------------
# nearest
# ---------------------------------------------------------------------------

def nearest_plain(query, target, target_valid, radius: float = math.inf,
                  chunk: Optional[int] = None):
    """Plain PyTorch form of plo_tpu/ops/neighbors.py::_nearest_xla: per
    query, the minimum coordinate-difference d2 = (dx*dx + dy*dy) + dz*dz
    over valid targets and its index, chunked over the target. Returns
    (d2 [Q] f32, idx [Q] i32, valid [Q] bool), valid = idx >= 0 &
    d2 <= radius^2 (squared in f32)."""
    q, t = query.shape[0], target.shape[0]
    chunk = chunk_size(q, t) if chunk is None else chunk
    best = torch.full((q,), math.inf, dtype=torch.float32, device=query.device)
    best_idx = torch.full((q,), -1, dtype=torch.int32, device=query.device)
    for base in range(0, t, chunk):
        tc = target[base:base + chunk]
        d2 = torch.zeros((q, tc.shape[0]), dtype=torch.float32, device=query.device)
        for c in range(3):
            diff = query[:, c:c + 1] - tc[None, :, c]
            d2 = d2 + diff * diff
        d2 = torch.where(target_valid[None, base:base + chunk], d2, math.inf)
        best, best_idx = _merge_min(best, best_idx, d2, base)
    return best, best_idx, (best_idx >= 0) & (best <= f32_square(radius))


def nearest(query: torch.Tensor, target: torch.Tensor, target_valid: torch.Tensor,
            radius: float = math.inf):
    """k=1 nearest valid target (pallas_nn.nearest). query [Q, 3] f32;
    target [T, 3] f32; target_valid [T] bool. Returns (d2 [Q] f32,
    idx [Q] i32, -1 where no target is valid; valid [Q] bool)."""
    if query.device.type == "cpu":
        return nearest_plain(query, target, target_valid, radius)
    dev = query.device
    q, t = query.shape[0], target.shape[0]
    _check("query", query, torch.float32, (q, 3), dev)
    _check("target", target, torch.float32, (t, 3), dev)
    _check("target_valid", target_valid, torch.bool, (t,), dev)
    d2 = torch.empty(q, dtype=torch.float32, device=dev)
    idx = torch.empty(q, dtype=torch.int32, device=dev)
    valid = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return d2, idx, valid
    lib = library()
    target, target_valid = _aligned16(target), _aligned16(target_valid)
    scratch = torch.empty(lib.plo_nearest_scratch(q), dtype=torch.int64, device=dev)
    err = lib.plo_nearest(
        query.data_ptr(), q, target.data_ptr(), target_valid.data_ptr(), t,
        f32_square(radius), scratch.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "nearest")
    LAUNCHES["nearest"] += 1
    return d2, idx, valid


# ---------------------------------------------------------------------------
# projected_argmin
# ---------------------------------------------------------------------------

def projected_p2(query, query_normal, tc, tvalid, euclid_gate2: float, proj_gate2: float):
    """Gated squared projected distances [Q, C] of one target chunk, as
    plo_tpu/ops/neighbors.py::projected_knn computes them: d = t - q,
    c = d x n, p2 = (cx*cx + cy*cy) + cz*cz, +inf where the target is
    invalid or fails d2 < euclid_gate2 or p2 < proj_gate2."""
    nx, ny, nz = query_normal[:, 0:1], query_normal[:, 1:2], query_normal[:, 2:3]
    dx = tc[None, :, 0] - query[:, 0:1]
    dy = tc[None, :, 1] - query[:, 1:2]
    dz = tc[None, :, 2] - query[:, 2:3]
    cx = dy * nz - dz * ny
    cy = dz * nx - dx * nz
    cz = dx * ny - dy * nx
    p2 = cx * cx + cy * cy + cz * cz
    d2 = dx * dx + dy * dy + dz * dz
    ok = tvalid[None, :] & (d2 < euclid_gate2) & (p2 < proj_gate2)
    return torch.where(ok, p2, math.inf)


def projected_argmin_plain(query, query_normal, target, target_valid, euclid_gate: float,
                           proj_gate: float, chunk: Optional[int] = None):
    """Plain PyTorch form of plo_tpu/ops/neighbors.py::projected_knn with
    k=1, the path the JAX package runs for plane-ICP: both gates squared in
    f32. Returns (proj [Q] f32 = sqrt(p2), idx [Q] i32, valid [Q] bool)."""
    q, t = query.shape[0], target.shape[0]
    chunk = chunk_size(q, t) if chunk is None else chunk
    eg2, pg2 = f32_square(euclid_gate), f32_square(proj_gate)
    best = torch.full((q,), math.inf, dtype=torch.float32, device=query.device)
    best_idx = torch.full((q,), -1, dtype=torch.int32, device=query.device)
    for base in range(0, t, chunk):
        p2 = projected_p2(query, query_normal, target[base:base + chunk],
                          target_valid[base:base + chunk], eg2, pg2)
        best, best_idx = _merge_min(best, best_idx, p2, base)
    valid = (best_idx >= 0) & torch.isfinite(best)
    return torch.sqrt(torch.where(torch.isfinite(best), best, math.inf)), best_idx, valid


def projected_argmin(query: torch.Tensor, query_normal: torch.Tensor, target: torch.Tensor,
                     target_valid: torch.Tensor, euclid_gate: float, proj_gate: float):
    """k=1 projected-distance anchor search (pallas_nn.projected_argmin):
    argmin of |(t - q) x n|^2 over valid targets with |t - q|^2 <
    euclid_gate^2 and the projected distance^2 < proj_gate^2, both gates
    squared in f32 (the XLA path's rounding, not the Pallas kernel's double
    square). Returns (proj [Q] f32, idx [Q] i32, valid [Q] bool)."""
    if query.device.type == "cpu":
        return projected_argmin_plain(query, query_normal, target, target_valid,
                                      euclid_gate, proj_gate)
    dev = query.device
    q, t = query.shape[0], target.shape[0]
    _check("query", query, torch.float32, (q, 3), dev)
    _check("query_normal", query_normal, torch.float32, (q, 3), dev)
    _check("target", target, torch.float32, (t, 3), dev)
    _check("target_valid", target_valid, torch.bool, (t,), dev)
    proj = torch.empty(q, dtype=torch.float32, device=dev)
    idx = torch.empty(q, dtype=torch.int32, device=dev)
    valid = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return proj, idx, valid
    lib = library()
    target, target_valid = _aligned16(target), _aligned16(target_valid)
    scratch = torch.empty(lib.plo_projected_scratch(q), dtype=torch.int64, device=dev)
    err = lib.plo_projected_argmin(
        query.data_ptr(), query_normal.data_ptr(), q, target.data_ptr(),
        target_valid.data_ptr(), t, f32_square(euclid_gate), f32_square(proj_gate),
        scratch.data_ptr(), proj.data_ptr(), idx.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "projected_argmin")
    LAUNCHES["projected_argmin"] += 1
    return proj, idx, valid


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
    target, target_valid = _aligned16(target), _aligned16(target_valid)
    splits = lib.plo_cylinder_splits(q)
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
