"""Grid-hash (voxel-bucket) neighbor search (the port of
plo_tpu/ops/grid_hash.py): the sub-linear alternative to the exact chunked
kNN of ops/neighbors.py, for voxel-downsampled maps.

Build: points are hashed by voxel cell (edge = the search radius) and sorted
by bucket, so each bucket is a contiguous range. Query: each query gathers up
to `m` candidates from each of its 27 neighboring cells and takes the k
nearest of those 27*m. Cells holding more than m points are truncated (the
first m in bucket-sorted order) and hash collisions merge cells (colliding
points are rejected by their cell coordinates but take candidate slots), so
the search can miss neighbors, never invent them; with m at least the largest
cell occupancy it is exact.

Plain PyTorch on every device, as it is plain XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from plo_tpu_torch.ops import cuda_nn

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes
_FIB = 2654435761  # Knuth multiplicative-mix constant (2^32 / phi)
_LOW32 = 0xFFFFFFFF


def _mul_low32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h, c < 2^32, in int64 without overflow:
    the product in two 16-bit halves of c."""
    lo = h * (c & 0xFFFF)
    hi = (h * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _LOW32


def hash_bucket(cell: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Spatial-hash bucket of integer voxel cells [..., 3] -> [...] int64 in
    [0, n_buckets), bit for bit plo_tpu's: the sum of prime multiples in
    int32 with wrap-around, then as uint32 the Fibonacci multiply and a
    13-bit shift, modulo n_buckets. torch's uint32 has few operations, so it
    runs in int64 keeping the low 32 bits (which int32 wrap-around leaves as
    they are)."""
    c = cell.to(torch.int64)
    h = (c[..., 0] * _P1 + c[..., 1] * _P2 + c[..., 2] * _P3) & _LOW32
    return (_mul_low32(h, _FIB) >> 13) % n_buckets


def sum_sq3(diff: torch.Tensor) -> torch.Tensor:
    """sum(diff * diff, -1) over 3 components as XLA's CPU backend fuses it,
    fma(d2, d2, fma(d1, d1, d0 * d0)): each fma is emulated by an exact f64
    product and one f64 add before the f32 rounding (a double rounding that
    can differ from a true fma only where the f64 sum falls on an f32 midpoint).
    The same bits on every device, so distance ties and orders match."""
    d = diff.to(torch.float64)
    acc = (diff[..., 0] * diff[..., 0]).to(torch.float64)
    acc = (acc + d[..., 1] * d[..., 1]).to(torch.float32).to(torch.float64)
    return (acc + d[..., 2] * d[..., 2]).to(torch.float32)


def cell_coords(xyz: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Voxel cell [..., 3] int32 of each point: floor(xyz / cell) as plo_tpu's
    odometry computes it. There the cell edge is a constant of the compiled
    program, and XLA rewrites x / c into x * (1 / c) with the f32
    reciprocal, which floors differently on some voxel boundaries; so does
    this."""
    return torch.floor(xyz * float(np.float32(1.0) / np.float32(cell_size))).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class GridHash:
    """The built structure over a target cloud."""

    xyz_sorted: torch.Tensor    # [T, 3] points in bucket-sorted order
    cell_sorted: torch.Tensor   # [T, 3] int32 cell coords (collision check)
    order: torch.Tensor         # [T] int64 original index of each sorted row
    starts: torch.Tensor        # [H + 1] int64 bucket start offsets
    cell_size: float
    n_buckets: int

    @property
    def capacity(self) -> int:
        return self.xyz_sorted.shape[0]


def build(xyz: torch.Tensor, valid: torch.Tensor, cell_size: float, n_buckets: int) -> GridHash:
    """Sort by bucket (invalid points last, as bucket n_buckets); stable, so
    a bucket keeps its points in index order, as jnp.argsort does."""
    cell = cell_coords(xyz, cell_size)
    bucket = torch.where(valid, hash_bucket(cell, n_buckets), n_buckets)
    bucket_sorted, order = torch.sort(bucket, stable=True)
    starts = torch.searchsorted(bucket_sorted,
                                torch.arange(n_buckets + 1, device=xyz.device))
    return GridHash(xyz_sorted=xyz[order], cell_sorted=cell[order], order=order,
                    starts=starts, cell_size=cell_size, n_buckets=n_buckets)


def _offsets(device) -> torch.Tensor:
    """The 27 neighbor-cell offsets [27, 3] int32, made on the device (a
    host-to-device copy from pageable memory would sync the stream)."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)


def knn(gh: GridHash, query: torch.Tensor, k: int, radius: float, m: int = 16):
    """k nearest neighbors within `radius` among the 27*m candidates.
    Returns (d2 [Q, k] ascending, idx [Q, k] int64 original-cloud indices or
    -1, valid [Q, k]). Equal distances go to the lower candidate position, as
    lax.top_k orders them: the selection runs on int64 keys of (d2 bits,
    position), whose values are distinct (torch.topk leaves the order of
    equal values undefined)."""
    q = query.shape[0]
    dev = query.device
    qcell = cell_coords(query, gh.cell_size)                          # [Q, 3]
    ncell = qcell[:, None, :] + _offsets(dev)                         # [Q, 27, 3]
    nbucket = hash_bucket(ncell, gh.n_buckets)                        # [Q, 27]
    start = gh.starts[nbucket]
    count = gh.starts[nbucket + 1] - start
    slot = torch.arange(m, device=dev)
    cand = (start[..., None] + slot).clamp(0, gh.capacity - 1).reshape(q, 27 * m)
    in_bucket = slot < count[..., None]
    same_cell = (gh.cell_sorted[cand].reshape(q, 27, m, 3) == ncell[:, :, None, :]).all(-1)
    d2 = sum_sq3(gh.xyz_sorted[cand] - query[:, None, :])
    d2 = torch.where((in_bucket & same_cell).reshape(q, 27 * m), d2, torch.inf)
    pos = torch.arange(27 * m, device=dev)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | pos
    best = torch.topk(key, k, dim=1, largest=False).values
    best_d2 = (best >> 32).to(torch.int32).view(torch.float32)
    best_idx = gh.order[torch.gather(cand, 1, best & _LOW32)]
    valid = torch.isfinite(best_d2) & (best_d2 <= cuda_nn.f32_square(radius))
    return best_d2, torch.where(valid, best_idx, -1), valid


def nearest(gh: GridHash, query: torch.Tensor, radius: float, m: int = 16):
    """k=1 form. Returns (d2 [Q], idx [Q], valid [Q])."""
    d2, idx, valid = knn(gh, query, 1, radius, m=m)
    return d2[:, 0], idx[:, 0], valid[:, 0]
