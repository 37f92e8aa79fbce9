"""State carried across from the JAX package. The odometry has no weights:
what carries over is the configuration and, to resume a run, the state a JAX
`plo_tpu.models.Odometry` holds between frames.

Both functions take plain Python and numpy values (`dataclasses.asdict` of
the JAX objects, `np.asarray` of its arrays), so this module imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.config import Config
from plo_tpu_torch.models.odometry import Odometry, OdometryFrame


def _build(cls, tree: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(tree) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in tree:
            v = tree[f.name]
            kwargs[f.name] = _build(type(f.default), v) if dataclasses.is_dataclass(f.default) else v
    return cls(**kwargs)


def config_from_dict(tree: Mapping[str, Any]) -> Config:
    """The port's Config from `dataclasses.asdict` of a plo_tpu Config (the
    two key trees are the same; unknown keys raise)."""
    return _build(Config, tree)


def cloud_from_numpy(arrays: Mapping[str, np.ndarray], device) -> PointCloud:
    """A PointCloud from {field: numpy array} (xyz, normal, intensity,
    curvature, eigvals, valid)."""
    return PointCloud(**{f.name: torch.as_tensor(np.array(arrays[f.name]), device=device)
                         for f in dataclasses.fields(PointCloud)})


def odometry_state_from_numpy(odo: Odometry, *, last_filtered: Mapping[str, np.ndarray],
                              frame_count: int, last_rel: Optional[np.ndarray],
                              trajectory: Iterable[Mapping[str, Any]],
                              cloud_queue: Iterable[Mapping[str, np.ndarray]] = (),
                              window: Optional[Mapping[str, np.ndarray]] = None,
                              device_map: Optional[Mapping[str, np.ndarray]] = None,
                              world: Optional[np.ndarray] = None,
                              ba_clouds: Iterable[Mapping[str, np.ndarray]] = (),
                              ba_corr: Optional[Mapping[int, tuple]] = None) -> Odometry:
    """Load a JAX Odometry's carried state into a port Odometry so that the
    next `process_scan` or `process_scans` resumes where JAX stopped: the
    last filtered cloud (major-axis sampling's reference), the target window
    (`cloud_queue`, or after a batched JAX run, whose queue is empty, the
    stacked [K, P] `window` its `_window_state()` returns), the frame count,
    the last relative pose (the motion prior's init and undistortion's
    sweep motion), the float64 trajectory (`dataclasses.asdict` of its
    OdometryFrames), in map mode the voxel map (its `_device_map` as a
    cloud) and the f32 world pose (its `_world_dev`), and with bundle
    adjustment the filtered clouds its records match against (its
    `_ba_clouds`) and the records {k: (rec_prev, rec_skip or None)}, each
    record a tuple of arrays (s, y, n, valid) (its `_ba_corr`). A
    ShardedMapOdometry is refused: its map is the shard store, which
    checkpoint.load_sharded restores."""
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
    if isinstance(odo, ShardedMapOdometry):
        raise TypeError("a ShardedMapOdometry's state loads with checkpoint.load_sharded")
    dev = odo.device
    odo.last_filtered = cloud_from_numpy(last_filtered, dev)
    odo.cloud_queue = deque(cloud_from_numpy(c, dev) for c in cloud_queue)
    odo._device_window = None if window is None else cloud_from_numpy(window, dev)
    odo._device_map = None if device_map is None else cloud_from_numpy(device_map, dev)
    odo._world_dev = (None if world is None else
                      torch.as_tensor(np.asarray(world, np.float32), device=dev))
    odo._ba_clouds.clear()
    odo._ba_clouds.extend(cloud_from_numpy(c, dev) for c in ba_clouds)
    record = lambda rec: None if rec is None else tuple(
        torch.as_tensor(np.array(a), device=dev) for a in rec)
    odo._ba_corr = {int(k): (record(prev), record(skip))
                    for k, (prev, skip) in (ba_corr or {}).items()}
    odo.frame_count = int(frame_count)
    odo._last_rel = (None if last_rel is None else
                     torch.as_tensor(np.asarray(last_rel, np.float32), device=dev))
    odo.trajectory = [OdometryFrame(
        index=int(f["index"]), pose=np.asarray(f["pose"], np.float64),
        rel_pose=np.asarray(f["rel_pose"], np.float64), iterations=int(f["iterations"]),
        n_correspondences=int(f["n_correspondences"]),
        stats={k: float(v) for k, v in dict(f["stats"]).items()})
        for f in trajectory]
    odo.prev_pose = odo.trajectory[-1].pose.copy() if odo.trajectory else np.eye(4)
    return odo
