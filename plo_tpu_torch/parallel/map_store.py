"""The sharded map store and its distributed correspondence search (the port
of plo_tpu/parallel/map_store.py).

The map is cut over the mesh's shards: each shard holds the points whose
spatial block hashes to it, in a cloud of per_shard rows on its own device.
A search replicates the queries, every shard searches only its own points,
and one all_gather of the candidates plus a re-top-k gives the global
k nearest exactly; no device holds the whole map.

Layout: `partition_cloud` returns a shard-major [D * M] cloud (shard d in
rows [d * M, (d + 1) * M)) and the per-shard counts; points beyond a shard's
M and invalid ones go to a dump slot that is cut off. Global indices are
shard-major too: shard d's row j is d * M + j.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.ops import neighbors
from plo_tpu_torch.ops.grid_hash import cell_coords, hash_bucket
from plo_tpu_torch.parallel import sharding
from plo_tpu_torch.parallel.sharding import Mesh


def voxel_shard_id(xyz: torch.Tensor, n_shards: int, voxel: float = 4.0,
                   base_cell: Optional[float] = None,
                   block_factor: Optional[int] = None) -> torch.Tensor:
    """The shard of each point: the spatial hash of its block. With
    `base_cell` and `block_factor` the block is the INTEGER voxel cell
    floor-divided by block_factor, so blocks align with the voxel grid and a
    voxel never splits over two shards (which keeps per-shard voxel dedupe
    equal to the global one); else the block is the cell of edge `voxel`.
    Cells as plo_tpu computes them with a constant edge (grid_hash.
    cell_coords); floor division of negative cells rounds down, as
    jnp.floor_divide does."""
    if base_cell is not None:
        v = torch.div(cell_coords(xyz, base_cell), block_factor, rounding_mode="floor")
    else:
        v = cell_coords(xyz, voxel)
    return hash_bucket(v, n_shards)


def partition_cloud(cloud: PointCloud, n_shards: int, per_shard: int, voxel: float = 4.0,
                    base_cell: Optional[float] = None, block_factor: Optional[int] = None):
    """A padded cloud in the shard-major [n_shards * per_shard] layout, each
    shard's points in their order in `cloud`, and the per-shard counts
    [n_shards] (at most per_shard: the overflow is dropped)."""
    dev = cloud.xyz.device
    cap = cloud.capacity
    shard = torch.where(cloud.valid, voxel_shard_id(cloud.xyz, n_shards, voxel, base_cell,
                                                    block_factor), n_shards)
    order = torch.sort(shard, stable=True).indices
    # A scatter-add, not bincount, whose output size waits for the host.
    counts = torch.zeros(n_shards + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, shard, torch.ones_like(shard))[:n_shards]
    starts = torch.cumsum(counts, 0) - counts
    sorted_shard = shard[order]
    rank = torch.arange(cap, device=dev) - starts[sorted_shard.clamp(0, n_shards - 1)]
    ok = (sorted_shard < n_shards) & (rank < per_shard)
    # Every dropped point writes the dump slot n_shards * per_shard; which
    # one wins there is undefined on CUDA and harmless, as the slot is cut.
    dest = torch.where(ok, sorted_shard * per_shard + rank, n_shards * per_shard)

    def scatter(x):
        out = x.new_zeros((n_shards * per_shard + 1,) + tuple(x.shape[1:]))
        out[dest] = x[order]
        return out[:-1]

    part = PointCloud(**{f.name: scatter(getattr(cloud, f.name))
                         for f in dataclasses.fields(PointCloud)})
    return part, counts.clamp(max=per_shard)


def _merge(mesh: Mesh, d2: List[torch.Tensor], k: int, *payloads: List[torch.Tensor]):
    """The k best of every shard's [Q, k] candidates: gathered over the
    shards, concatenated shard-major per query, and selected on (d2,
    position), so equal distances go to the lower shard and then the lower
    rank within it, as lax.top_k over plo_tpu's concatenation keeps them.
    Returns (d2 [Q, k] ascending, each payload's rows [Q, k, ...])."""
    all_d2 = sharding.all_gather(mesh, [x[None] for x in d2])      # [D, Q, k]
    n_q = all_d2.shape[1]
    cat_d2 = all_d2.permute(1, 0, 2).reshape(n_q, -1)
    pos = torch.arange(cat_d2.shape[1], device=cat_d2.device).expand(n_q, -1)
    key, _ = torch.topk(neighbors._tie_key(cat_d2, pos), k, dim=1, largest=False)
    best_d2 = (key >> 32).to(torch.int32).view(torch.float32)
    best_pos = (key & 0xFFFFFFFF) - 1
    out = []
    for parts in payloads:
        rows = sharding.all_gather(mesh, [x[None] for x in parts])  # [D, Q, k, ...]
        rows = rows.transpose(0, 1).reshape((n_q, -1) + tuple(rows.shape[3:]))
        index = best_pos.view(best_pos.shape + (1,) * (rows.dim() - 2))
        out.append(torch.gather(rows, 1, index.expand((-1, -1) + tuple(rows.shape[2:]))))
    return best_d2, out


class ShardedMapStore:
    """A map cut over the mesh's shards, and the distributed k-NN over it.
    `shards` holds this process's shards (PointClouds of per_shard rows,
    each on its shard's device)."""

    def __init__(self, mesh: Mesh, per_shard: int, voxel: float = 4.0):
        self.mesh = mesh
        self.n_shards = mesh.size
        self.per_shard = per_shard
        self.voxel = voxel
        self.shards: List[PointCloud] = [PointCloud.zeros(per_shard, dev)
                                         for dev in mesh.devices]

    @property
    def cloud(self) -> PointCloud:
        """This process's shards as one shard-major cloud on mesh.device (with
        one process, the whole map in plo_tpu's [D * M] layout)."""
        return PointCloud(**{f.name: torch.cat([getattr(s, f.name).to(self.mesh.device)
                                                for s in self.shards])
                             for f in dataclasses.fields(PointCloud)})

    @cloud.setter
    def cloud(self, flat: PointCloud) -> None:
        m = self.per_shard
        self.shards = [PointCloud(**{f.name: getattr(flat, f.name)[j * m:(j + 1) * m].to(dev)
                                     for f in dataclasses.fields(PointCloud)})
                       for j, dev in enumerate(self.mesh.devices)]

    def global_cloud(self) -> PointCloud:
        """The whole map, shard-major [D * M], on mesh.device of every
        process (a collective: every process calls it)."""
        return PointCloud(**{f.name: sharding.all_gather(
            self.mesh, [getattr(s, f.name) for s in self.shards])
            for f in dataclasses.fields(PointCloud)})

    def local_slice(self, flat: PointCloud) -> PointCloud:
        """This process's rows of a shard-major [D * M] cloud."""
        lo = self.mesh.first_shard * self.per_shard
        return PointCloud(**{f.name: getattr(flat, f.name)[lo:lo + self.mesh.n_local
                                                            * self.per_shard]
                             for f in dataclasses.fields(PointCloud)})

    def set_model(self, cloud: PointCloud) -> torch.Tensor:
        """Partition and place a model cloud (replaces accumulateTargetCloud);
        returns the per-shard counts [D]."""
        part, counts = partition_cloud(cloud, self.n_shards, self.per_shard, self.voxel)
        self.cloud = self.local_slice(part)
        return counts

    def _local_knn(self, query_xyz: torch.Tensor, k: int):
        for j, s in enumerate(self.shards):
            yield j, s, neighbors.knn(query_xyz.to(s.xyz.device), s.xyz, s.valid, k=k)

    def knn(self, query_xyz: torch.Tensor, k: int, radius: float = math.inf):
        """The global k nearest map points of each query. Returns (d2 [Q, k],
        global shard-major index [Q, k] (-1 where none), valid [Q, k]), on
        mesh.device."""
        d2s, gidx = [], []
        for j, _, (d2, idx, ok) in self._local_knn(query_xyz, k):
            d2s.append(d2)
            gidx.append(torch.where(ok, (self.mesh.first_shard + j) * self.per_shard + idx, -1))
        d2, (idx,) = _merge(self.mesh, d2s, k, gidx)
        valid = (idx >= 0) & (d2 <= radius ** 2) & torch.isfinite(d2)
        return d2, idx, valid

    def knn_gather(self, query_xyz: torch.Tensor, k: int, radius: float = math.inf):
        """The distributed search that returns the candidates themselves: each
        shard searches its points and gathers its winners' rows
        [xyz, normal, normal ok] locally, and one all_gather of the [D, Q, k,
        7] candidate rows and a re-top-k merge them. Returns (d2 [Q, k],
        xyz [Q, k, 3], normal [Q, k, 3], normal_ok [Q, k], valid [Q, k]) on
        mesh.device: what matching.imls_project_candidates takes."""
        d2s, rows = [], []
        for _, s, (d2, idx, ok) in self._local_knn(query_xyz, k):
            normal_ok = s.valid & ((s.normal * s.normal).sum(-1) > 1e-12)
            packed = torch.cat([s.xyz, s.normal, normal_ok.to(torch.float32)[:, None]], 1)
            rows.append(packed[idx.clamp(0, self.per_shard - 1)])       # [Q, k, 7]
            d2s.append(torch.where(ok, d2, math.inf))
        d2, (best,) = _merge(self.mesh, d2s, k, rows)
        valid = torch.isfinite(d2) & (d2 <= radius ** 2)
        return d2, best[..., 0:3], best[..., 3:6], best[..., 6] > 0.5, valid

