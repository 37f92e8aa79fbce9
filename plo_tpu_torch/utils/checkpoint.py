"""Checkpoint and resume of the odometry — the port of `save` and `load` of
plo_tpu/utils/checkpoint.py, with the same .npz keys.

The reference keeps its odometry state in three globals (prevLaserPose,
cloudQueue, frameCount; laser_odometry.cpp:48-57). Here the state is a
snapshot: the float64 pose, the frame count, the target window (or the voxel
map and the world pose), the last filtered cloud, the last relative pose,
and with windowed BA the trajectory's tail, the clouds the records match
against and the records. A run saves every K frames and resumes by loading
and skipping the processed scans.

Random numbers: plo_tpu stores its jax.random key (`key`, `key_counter`),
which the port cannot use. The port stores its torch.Generator's state under
`torch_generator_state` and restores it, so save -> load -> continue on one
device repeats the uninterrupted run's draws. A file written by plo_tpu
loads (its `key` and `key_counter` are ignored): the draws after it then
come from the port's generator as the Odometry was constructed.

`save_sharded` and `load_sharded` do the same for the sharded map odometry
(parallel/odometry.py), with plo_tpu's keys: the map is saved as one flat
shard-major cloud and partitioned again by the loading odometry's own block
hash, so a run resumes on another number of shards (elastic resume, e.g. 8
to 4).
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from plo_tpu_torch.cloud import PointCloud

if TYPE_CHECKING:
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry

FIELDS = ("xyz", "normal", "intensity", "curvature", "eigvals", "valid")
RECORD = ("s", "y", "n", "v")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _put_cloud(state: dict, prefix: str, cloud: PointCloud) -> None:
    for field in FIELDS:
        state[f"{prefix}_{field}"] = _np(getattr(cloud, field))


def _not_sharded(odo: "Odometry") -> None:
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
    if isinstance(odo, ShardedMapOdometry):
        raise TypeError("a ShardedMapOdometry saves with save_sharded and loads with "
                        "load_sharded")


def save(odo: "Odometry", path: str):
    """Write `odo`'s state to `path` (a compressed .npz), after draining its
    pending frames and materializing a batch's device window."""
    _not_sharded(odo)
    odo._drain()
    odo._sync_queue()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {
        "prev_pose": odo.prev_pose,
        "frame_count": np.asarray(odo.frame_count),
        "torch_generator_state": odo.generator.get_state().numpy(),
        "n_queue": np.asarray(len(odo.cloud_queue)),
    }
    for qi, cloud in enumerate(odo.cloud_queue):
        _put_cloud(state, f"q{qi}", cloud)
    if odo.last_filtered is not None:
        _put_cloud(state, "last", odo.last_filtered)
    if odo._map_mode and odo._device_map is not None:
        _put_cloud(state, "map", odo._device_map)
        state["world_pose"] = _np(odo._world_dev)
    if odo._last_rel is not None:
        # The motion prior's init and undistortion's sweep motion: without
        # it the first resumed frame would start from the identity.
        state["last_rel"] = _np(odo._last_rel)
    if odo._ba:
        tail = odo.trajectory[-odo.cfg.laser_odometry.ba.window:]
        state["ba_traj_idx"] = np.asarray([f.index for f in tail], np.int64)
        state["ba_traj_poses"] = (np.stack([f.pose for f in tail]) if tail
                                  else np.zeros((0, 4, 4)))
        state["ba_traj_rels"] = (np.stack([f.rel_pose for f in tail]) if tail
                                 else np.zeros((0, 4, 4)))
        state["ba_n_clouds"] = np.asarray(len(odo._ba_clouds))
        for ci, cloud in enumerate(odo._ba_clouds):
            _put_cloud(state, f"ba_c{ci}", cloud)
        state["ba_corr_keys"] = np.asarray(sorted(odo._ba_corr), np.int64)
        for k in sorted(odo._ba_corr):
            rec_prev, rec_skip = odo._ba_corr[k]
            for ri, name in enumerate(RECORD):
                state[f"ba_k{k}_p_{name}"] = _np(rec_prev[ri])
                if rec_skip is not None:
                    state[f"ba_k{k}_s_{name}"] = _np(rec_skip[ri])
    np.savez_compressed(path, **state)


def load(odo: "Odometry", path: str):
    """Restore a snapshot (the port's or plo_tpu's) into an Odometry built
    with the same config; returns it. The trajectory before the snapshot is
    not restored, except the BA window's tail."""
    from plo_tpu_torch.models.odometry import OdometryFrame
    _not_sharded(odo)

    data = np.load(path)
    dev = odo.device
    tensor = lambda key: torch.as_tensor(data[key], device=dev)
    cloud = lambda prefix: PointCloud(**{f: tensor(f"{prefix}_{f}") for f in FIELDS})

    odo.prev_pose = data["prev_pose"]
    odo.frame_count = int(data["frame_count"])
    if "torch_generator_state" in data:
        odo.generator.set_state(torch.from_numpy(data["torch_generator_state"]))
    odo._pending = []
    odo._device_window = None
    odo.cloud_queue.clear()
    for qi in range(int(data["n_queue"])):
        odo.cloud_queue.append(cloud(f"q{qi}"))
    if "last_xyz" in data:
        odo.last_filtered = cloud("last")
    if "map_xyz" in data:
        odo._device_map = cloud("map")
        odo._world_dev = tensor("world_pose")
    if "last_rel" in data:
        odo._last_rel = tensor("last_rel")
    if odo._ba and "ba_n_clouds" in data:
        odo.trajectory.clear()
        for i, pose, rel in zip(data["ba_traj_idx"], data["ba_traj_poses"],
                                data["ba_traj_rels"]):
            odo.trajectory.append(OdometryFrame(index=int(i), pose=pose, rel_pose=rel,
                                                iterations=0, n_correspondences=0, stats={}))
        odo._ba_clouds.clear()
        for ci in range(int(data["ba_n_clouds"])):
            odo._ba_clouds.append(cloud(f"ba_c{ci}"))
        odo._ba_corr.clear()
        for k in data["ba_corr_keys"]:
            k = int(k)
            rec_prev = tuple(tensor(f"ba_k{k}_p_{n}") for n in RECORD)
            rec_skip = (tuple(tensor(f"ba_k{k}_s_{n}") for n in RECORD)
                        if f"ba_k{k}_s_s" in data else None)
            odo._ba_corr[k] = (rec_prev, rec_skip)
    return odo


def save_sharded(sodo: "ShardedMapOdometry", path: str):
    """Write a ShardedMapOdometry's state to `path`: the float64 pose, the
    frame count, the generator's state, the world and last relative poses,
    the last filtered cloud and the whole map as one flat shard-major cloud
    (gathered from every process; the voxel dedupe state is the map's own
    content, so nothing of the shard layout is needed). Every process of
    the mesh calls it; the first writes."""
    sodo._drain()
    flat = sodo.store.global_cloud()
    if not sodo.mesh.is_writer:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {
        "prev_pose": sodo.prev_pose,
        "frame_count": np.asarray(sodo.frame_count),
        "torch_generator_state": sodo.generator.get_state().numpy(),
        "world_pose": _np(sodo._world_dev),
    }
    if sodo._last_rel is not None:
        state["last_rel"] = _np(sodo._last_rel)
    _put_cloud(state, "map", flat)
    if sodo.last_filtered is not None:
        _put_cloud(state, "last", sodo.last_filtered)
    np.savez_compressed(path, **state)


def load_sharded(sodo: "ShardedMapOdometry", path: str):
    """Restore a sharded snapshot (the port's or plo_tpu's) into a
    ShardedMapOdometry of the same config on any mesh: the flat map is
    partitioned by this odometry's block hash over its shards (exact: blocks
    are voxel-aligned, so per-shard dedupe carries over). plo_tpu's
    key_counter is ignored; returns sodo."""
    from plo_tpu_torch.parallel.map_store import partition_cloud

    data = np.load(path)
    dev = sodo.device
    tensor = lambda key: torch.as_tensor(data[key], device=dev)
    cloud = lambda prefix: PointCloud(**{f: tensor(f"{prefix}_{f}") for f in FIELDS})

    sodo.prev_pose = data["prev_pose"]
    sodo.frame_count = int(data["frame_count"])
    if "torch_generator_state" in data:
        sodo.generator.set_state(torch.from_numpy(data["torch_generator_state"]))
    sodo._pending = []
    part, _ = partition_cloud(cloud("map"), sodo.n_shards, sodo.store.per_shard,
                              base_cell=sodo._base_cell, block_factor=sodo._block_factor)
    sodo.store.cloud = sodo.store.local_slice(part)
    sodo._world_dev = tensor("world_pose")
    if "last_rel" in data:
        sodo._last_rel = tensor("last_rel")
    if "last_xyz" in data:
        sodo.last_filtered = cloud("last")
    return sodo
