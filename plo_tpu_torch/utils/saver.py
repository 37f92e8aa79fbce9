"""Artifact saver — the port of plo_tpu/utils/saver.py, the reference's
results I/O (saver.cpp:28-133) in the same text formats:

  * point clouds: "x y z intensity nx ny nz curvature" a line
    (savePointCloudToTxt);
  * poses: TUM "t x y z qx qy qz qw" appended (savePoseToFile);
  * normal markers as OBJ v/l records (saveMarkerToFile /
    visualizePCAFeatures: a segment from each point along its normal);
  * matched point pairs: "sx sy sz rx ry rz" (saveMatchedPointsToFile).

Every saver takes masked clouds and drops invalid rows. Values are written
from numpy arrays of their own dtype, so a float32 prints its shortest
digits, as plo_tpu's files do (a Python float of the same value would print
17). The drivers gate everything behind SaverConfig.enabled.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.utils.evaluate import quat_f32


def _host(a) -> np.ndarray:
    """A tensor or array as a numpy array of the same dtype."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np(cloud: PointCloud):
    v = _host(cloud.valid)
    return (_host(cloud.xyz)[v], _host(cloud.intensity)[v],
            _host(cloud.normal)[v], _host(cloud.curvature)[v])


def save_point_cloud_txt(cloud: PointCloud, path: str):
    xyz, inten, nrm, curv = _np(cloud)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(xyz)):
            f.write(f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]} {inten[i]} "
                    f"{nrm[i,0]} {nrm[i,1]} {nrm[i,2]} {curv[i]}\n")


def save_pose_tum(pose: np.ndarray, path: str, timestamp: str):
    """Append one TUM-format pose line (savePoseToFile)."""
    q = quat_f32(pose)
    t = pose[:3, 3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{timestamp} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def save_normal_markers_obj(cloud: PointCloud, path: str, scale: float = 0.1):
    """OBJ line list of the normals (visualizePCAFeatures +
    saveMarkerToFile): one segment a valid point."""
    xyz, _, nrm, _ = _np(cloud)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(xyz)):
            a = xyz[i]
            b = xyz[i] + scale * nrm[i]
            f.write(f"v {a[0]} {a[1]} {a[2]}\n")
            f.write(f"v {b[0]} {b[1]} {b[2]}\n")
        for i in range(len(xyz)):
            f.write(f"l {2*i+1} {2*i+2}\n")


def save_matched_points(src_xyz, ref_xyz, valid: Optional[object], path: str):
    """Matched pair dump (saveMatchedPointsToFile)."""
    src = _host(src_xyz)
    ref = _host(ref_xyz)
    if valid is not None:
        m = _host(valid)
        src, ref = src[m], ref[m]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s, r in zip(src, ref):
            f.write(f"{s[0]} {s[1]} {s[2]} {r[0]} {r[1]} {r[2]}\n")


def save_scalar_append(path: str, number: float):
    """saveThresholdFile (saver.cpp:78-86): append one fixed-6 scalar a
    line."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{number:.6f}\n")


def save_descriptors_txt(result, path: str):
    """saveCloudFeaturesAndDescriptors: a valid point's xyz, then its 22
    descriptor values (saver.cpp:309-340). `result` has `.cloud` and
    `.descriptors()` ([22, P])."""
    desc = _host(result.descriptors())
    v = _host(result.cloud.valid)
    xyz = _host(result.cloud.xyz)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in np.nonzero(v)[0]:
            row = " ".join(str(x) for x in desc[:, i])
            f.write(f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]} {row}\n")
