"""Frame-to-map odometry with the map sharded over a mesh (the port of
plo_tpu/parallel/odometry.py).

The scale-out form of the single-device map mode (models/odometry.py,
target_mode="map"):
  * the voxel map lives shard-major over the mesh, map.capacity / D rows a
    shard, so a device holds 1/D of it;
  * a point's shard is the spatial hash of its block, whose edge is an
    integer number of map voxels (about 4 m), so all points of a voxel meet
    on one shard and inserting each shard's points into its own map part IS
    the global voxel insertion (first arrival per voxel, occupancy);
  * the correspondence search is the map store's knn_gather: each shard
    searches its part, one all_gather of the [D, Q, k, 7] candidate rows
    merges them, and no device holds the whole map;
  * the ICP loop evaluates those frozen candidates each iteration
    (matching.imls_project_candidates) and solves replicated, the math of
    the single-device frozen path, so the trajectories agree to float
    tolerance.
The front-end and the pose algebra run replicated on the mesh's first shard
of every process; each process inserts into its own shards. The world pose
and the last relative pose stay on the device, projected onto SO(3) with the
single-device path's sync-free geometry.project_so3; a frame's result row
waits on the device until a drain, as in Odometry.

Scope, as plo_tpu's: map mode, euclidean IMLS with the frozen candidate set.
plo_tpu's sharded odometry has no undistortion and no saver artifacts, so a
config that asks for either is refused here; Odometry's checkpoint.save and
load refuse a sharded run too (checkpoint.save_sharded / load_sharded).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from plo_tpu_torch import geometry as geo
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.models.odometry import Odometry, _flat_query_cap, icp_loop
from plo_tpu_torch.ops import voxel
from plo_tpu_torch.parallel import sharding
from plo_tpu_torch.parallel.map_store import ShardedMapStore, partition_cloud
from plo_tpu_torch.parallel.sharding import Mesh

# The spatial block's edge: block_factor = round(BLOCK_M / voxel_size) voxels.
BLOCK_M = 4.0


class ShardedMapOdometry(Odometry):
    """Frame-to-map odometry with the map sharded over `mesh`: Odometry's
    drivers (process_scan, and process_scans with one float32 upload a batch
    and one drain), its draws and its float64 pose chain, with the sharded
    map in place of the device map.

    defer_fetch=True keeps every frame's result on the device until
    finalize() / poses(); by default each frame is fetched and returned, as
    Odometry does."""

    def __init__(self, cfg: Config, mesh: Mesh, capacity: int = 131072, seed: int = 0,
                 defer_fetch: bool = False):
        lo = cfg.laser_odometry
        # plo_tpu's scope (parallel/odometry.py:329-331).
        if lo.target_mode != "map":
            raise ValueError("ShardedMapOdometry requires target_mode='map'")
        if lo.matching_method.method != "IMLS":
            raise ValueError("sharded map path is IMLS-only")
        if lo.matching_method.imls.use_projected_distance.enabled:
            raise ValueError("sharded map path is euclidean IMLS (no projected distance)")
        # Nor has it undistortion or the saver's artifacts (Odometry rejects
        # bundle adjustment in map mode).
        if lo.undistort:
            raise ValueError("sharded map path has no undistortion")
        if cfg.saver.enabled and cfg.saver.output_dir:
            raise ValueError("sharded map path has no saver artifacts")
        super().__init__(cfg, capacity=capacity, seed=seed, device=mesh.device,
                         async_mode=defer_fetch, sync_every=math.inf, transfer="float32")
        self.mesh = mesh
        self.n_shards = mesh.size
        # Blocks of block_factor^3 voxels indexed from the INTEGER voxel cell
        # (map_store.voxel_shard_id): a voxel never splits over two shards.
        self._base_cell = lo.map.voxel_size
        self._block_factor = max(1, round(BLOCK_M / lo.map.voxel_size))
        self.store = ShardedMapStore(mesh, lo.map.capacity // self.n_shards)

    def _map_target(self) -> ShardedMapStore:
        """The sharded map in place of the device map."""
        return self.store

    def _icp(self, flat: PointCloud, target: ShardedMapStore, draws, init_pose):
        """The distributed candidate search at the initial pose, then the
        ICP over those frozen candidates (icp_loop's candidates mode;
        plo_tpu's _make_candidate_icp)."""
        imls_cfg = self.cfg.laser_odometry.matching_method.imls
        cap = _flat_query_cap(self.cfg)
        if cap is not None and flat.capacity > cap:
            flat = flat.slice(cap)
        _, cxyz, cnrm, cok, cvalid = target.knn_gather(
            geo.transform_points(init_pose, flat.xyz), imls_cfg.search_number, radius=imls_cfg.r)
        rpose, i, n_corr, _, probs = icp_loop(self.cfg, flat, None, draws, init_pose,
                                              self.device, True,
                                              candidates=(cxyz, cnrm, cok, cvalid))
        return rpose, i, n_corr, probs

    def _map_insert(self, filtered: PointCloud) -> None:
        """The filtered cloud moved to the world frame at the world pose,
        partitioned by block over all shards (replicated), and each local
        shard's part inserted into its map part (voxel_map_insert)."""
        mp = self.cfg.laser_odometry.map
        wpose = self._world_dev
        fcap = filtered.capacity
        world = dataclasses.replace(filtered, xyz=geo.transform_points(wpose, filtered.xyz),
                                    normal=geo.rotate_vectors(wpose, filtered.normal))
        part, _ = partition_cloud(world, self.n_shards, fcap, base_cell=self._base_cell,
                                  block_factor=self._block_factor)
        center = wpose[:3, 3]
        self.store.shards = [
            voxel.voxel_map_insert(
                s, PointCloud(**{f.name: getattr(part, f.name)[g * fcap:(g + 1) * fcap]
                                          .to(s.xyz.device)
                                          for f in dataclasses.fields(part)}),
                mp.voxel_size, center.to(s.xyz.device), mp.n_buckets)
            for g, s in enumerate(self.store.shards, start=self.mesh.first_shard)]

    def sync(self) -> None:
        """Wait for the device work queued so far on every local shard."""
        for dev in sorted({d for d in self.mesh.devices if d.type == "cuda"}, key=str):
            torch.cuda.synchronize(dev)

    def map_points_per_device(self) -> int:
        """The most map points any shard holds (the memory-scaling
        observable)."""
        counts = sharding.all_gather(self.mesh, [s.valid.sum()[None] for s in self.store.shards])
        return int(counts.max())
