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
    return PointCloud(**{f.name: torch.as_tensor(np.asarray(arrays[f.name]), device=device)
                         for f in dataclasses.fields(PointCloud)})


def odometry_state_from_numpy(odo: Odometry, *, last_filtered: Mapping[str, np.ndarray],
                              cloud_queue: Iterable[Mapping[str, np.ndarray]],
                              frame_count: int, last_rel: Optional[np.ndarray],
                              trajectory: Iterable[Mapping[str, Any]]) -> Odometry:
    """Load a JAX Odometry's carried state into a port Odometry so that the
    next `process_scan` resumes where JAX stopped: the last filtered cloud
    (major-axis sampling's reference), the target window, the frame count,
    the last relative pose (the motion prior's init) and the float64
    trajectory (`dataclasses.asdict` of its OdometryFrames)."""
    dev = odo.device
    odo.last_filtered = cloud_from_numpy(last_filtered, dev)
    odo.cloud_queue = deque(cloud_from_numpy(c, dev) for c in cloud_queue)
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
