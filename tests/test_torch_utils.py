"""The port's utilities against plo_tpu's on the same inputs: the
quaternions of geometry.py, PointCloud.bounding_box, the evaluation
(utils/evaluate.py), the saver's files (utils/saver.py), TicToc, MetricsLog
and DeviceTrace (utils/profiling.py).

Tolerances: quaternions and rotations within 1e-6 (f32 arithmetic in
another order); the bounding box exactly; RPE, travelled distances and
KITTI drift to rtol 1e-12 (the same float64 numpy code); the saver's files
byte for byte, except the TUM quaternion columns, within 1 float32 ulp."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import geometry as jgeo
from plo_tpu.cloud import PointCloud as JaxCloud
from plo_tpu.utils import evaluate as jax_evaluate
from plo_tpu.utils import profiling as jax_profiling
from plo_tpu.utils import saver as jax_saver
from plo_tpu_torch import geometry as geo
from plo_tpu_torch.cloud import PointCloud
from plo_tpu_torch.utils import DeviceTrace, MetricsLog, TicToc, evaluate, saver


def rotations(rng, n=64):
    """Rotations over all four Shepperd branches: small angles (trace > 0)
    and angles near pi about axes near x, y and z."""
    axes = [rng.normal(size=(n, 3))]
    for k in range(3):
        a = rng.normal(size=(n, 3)) * 0.2
        a[:, k] = 1.0
        axes.append(a)
    out = []
    for j, a in enumerate(axes):
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        ang = rng.uniform(0.0, 1.5, n) if j == 0 else rng.uniform(2.8, np.pi, n)
        out.append(np.asarray(jgeo.exp_so3(jnp.asarray((a * ang[:, None]).astype(np.float32)))))
    return np.concatenate(out).astype(np.float32)


def branches(R):
    tr = np.trace(R, axis1=1, axis2=2)
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    return np.where(tr > 0, 0, np.where((m00 >= m11) & (m00 >= m22), 1,
                                        np.where(m11 >= m22, 2, 3)))


def test_quat_from_rotation_matches_jax_on_every_branch(rng):
    R = rotations(rng)
    assert set(branches(R)) == {0, 1, 2, 3}
    q = geo.quat_from_rotation(torch.from_numpy(R)).numpy()
    qj = np.asarray(jgeo.quat_from_rotation(jnp.asarray(R)))
    assert q.dtype == np.float32 and q.shape == (len(R), 4)
    np.testing.assert_allclose(q, qj, rtol=0, atol=1e-6)
    # One matrix at a time gives the batch's rows.
    np.testing.assert_array_equal(geo.quat_from_rotation(torch.from_numpy(R[3])).numpy(), q[3])


def test_rotation_from_quat_matches_jax(rng):
    q = rng.normal(size=(50, 4)).astype(np.float32)
    q[0] = 0.0   # the identity
    R = geo.rotation_from_quat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jgeo.rotation_from_quat(jnp.asarray(q))),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(R[0], np.eye(3))
    # Round trip through the quaternion.
    Rs = rotations(rng, 8)
    back = geo.rotation_from_quat(geo.quat_from_rotation(torch.from_numpy(Rs))).numpy()
    np.testing.assert_allclose(back, Rs, rtol=0, atol=1e-6)


def port_cloud(xyz, valid, **fields):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    n = len(xyz)
    base = dict(xyz=torch.from_numpy(xyz), normal=z(n, 3), intensity=z(n), curvature=z(n),
                eigvals=z(n, 3), valid=torch.from_numpy(valid))
    base.update({k: torch.from_numpy(v) for k, v in fields.items()})
    return PointCloud(**base)


def jax_cloud(cloud):
    return JaxCloud(**{f.name: jnp.asarray(getattr(cloud, f.name).numpy())
                       for f in dataclasses.fields(cloud)})


@pytest.mark.parametrize("valid", [[True, True, False], [False, False, False]],
                         ids=["masked", "empty"])
def test_bounding_box_matches_jax(valid):
    xyz = np.array([[1, 2, 3], [-5, 0, 9], [100, 100, 100]], np.float32)
    c = port_cloud(xyz, np.array(valid))
    mn, mx = (t.numpy() for t in c.bounding_box())
    mnj, mxj = (np.asarray(t) for t in jax_cloud(c).bounding_box())
    np.testing.assert_array_equal(mn, mnj)
    np.testing.assert_array_equal(mx, mxj)
    if not any(valid):
        assert np.isposinf(mn).all() and np.isneginf(mx).all()


@pytest.fixture
def trajectories(rng):
    """A 120-frame ground truth and a noisy estimate of it."""
    n = 120
    gt = np.tile(np.eye(4), (n, 1, 1))
    est = gt.copy()
    yaw = np.cumsum(rng.normal(0.01, 0.01, n))
    gt[:, 0, 3] = np.cumsum(np.cos(yaw))
    gt[:, 1, 3] = np.cumsum(np.sin(yaw))
    est[:, :3, 3] = gt[:, :3, 3] + np.cumsum(rng.normal(0, 0.01, (n, 3)), 0)
    for i in range(n):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        gt[i, :2, :2] = [[c, -s], [s, c]]
        e = yaw[i] + 0.001 * i
        est[i, :2, :2] = [[np.cos(e), -np.sin(e)], [np.sin(e), np.cos(e)]]
    return est, gt


def test_evaluation_matches_jax(trajectories):
    est, gt = trajectories
    np.testing.assert_allclose(evaluate.rpe(est, gt, delta=3), jax_evaluate.rpe(est, gt, delta=3),
                               rtol=1e-12)
    np.testing.assert_allclose(evaluate.trajectory_distances(gt),
                               jax_evaluate.trajectory_distances(gt), rtol=1e-12)
    lengths = (10, 20, 40, 80)   # scaled to the 120 m run
    t, r, per = evaluate.kitti_odometry_errors(est, gt, lengths=lengths, step=5)
    tj, rj, perj = jax_evaluate.kitti_odometry_errors(est, gt, lengths=lengths, step=5)
    assert sorted(per) == sorted(perj) == list(lengths)
    np.testing.assert_allclose([t, r], [tj, rj], rtol=1e-12)
    for L in lengths:
        np.testing.assert_allclose(per[L], perj[L], rtol=1e-12)
    # No length fits a short run.
    t, r, per = evaluate.kitti_odometry_errors(est[:5], gt[:5])
    assert np.isnan(t) and np.isnan(r) and per == {}
    assert evaluate.ate_rmse(est, gt) == jax_evaluate.ate_rmse(est, gt)


def assert_tum_close(path_a, path_b):
    """Byte-equal lines but the quaternion columns, which are within one
    float32 ulp."""
    with open(path_a) as fa, open(path_b) as fb:
        a, b = fa.read().splitlines(), fb.read().splitlines()
    assert len(a) == len(b) > 0
    for la, lb in zip(a, b):
        ca, cb = la.split(" "), lb.split(" ")
        assert ca[:4] == cb[:4]
        qa, qb = np.float32(ca[4:]), np.float32(cb[4:])
        assert np.all(np.abs(qa - qb) <= np.spacing(np.maximum(np.abs(qa), np.abs(qb)))), (la, lb)


def test_saver_files_match_jax(tmp_path, rng):
    n = 200
    valid = rng.random(n) > 0.2
    c = port_cloud(rng.normal(size=(n, 3)).astype(np.float32) * 20, valid,
                   normal=rng.normal(size=(n, 3)).astype(np.float32),
                   intensity=rng.random(n).astype(np.float32),
                   curvature=rng.random(n).astype(np.float32))
    cj = jax_cloud(c)
    desc = rng.normal(size=(22, n)).astype(np.float32)

    class Result:   # a stub with .cloud and .descriptors()
        def __init__(self, cloud, desc):
            self.cloud, self.desc = cloud, desc

        def descriptors(self):
            return self.desc

    out = {k: tmp_path / k for k in ("port", "jax")}
    for k, mod, cloud in (("port", saver, c), ("jax", jax_saver, cj)):
        mod.save_point_cloud_txt(cloud, str(out[k] / "pcl" / "c.txt"))
        mod.save_normal_markers_obj(cloud, str(out[k] / "m.obj"))
        src = cloud.xyz
        mod.save_matched_points(src, src + 1.0, cloud.valid, str(out[k] / "matched.txt"))
        mod.save_matched_points(np.asarray(src), np.asarray(src) * 2, None,
                                str(out[k] / "matched_all.txt"))
        mod.save_scalar_append(str(out[k] / "thr" / "t.txt"), 0.123456789)
        mod.save_scalar_append(str(out[k] / "thr" / "t.txt"), -2.0)
        res = Result(cloud, torch.from_numpy(desc) if mod is saver else jnp.asarray(desc))
        mod.save_descriptors_txt(res, str(out[k] / "desc.txt"))
    for name in ("pcl/c.txt", "m.obj", "matched.txt", "matched_all.txt", "thr/t.txt",
                 "desc.txt"):
        assert (out["port"] / name).read_bytes() == (out["jax"] / name).read_bytes(), name
    assert len((out["port"] / "pcl" / "c.txt").read_text().splitlines()) == valid.sum()

    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, :3, :3] = rotations(rng, 2)[:6].astype(np.float64)
    poses[:, :3, 3] = rng.normal(size=(6, 3))
    for k, mod, ev in (("port", saver, evaluate), ("jax", jax_saver, jax_evaluate)):
        for i, p in enumerate(poses):
            mod.save_pose_tum(p, str(out[k] / "tum" / "poses.txt"), f"{i * 0.1:.6f}")
        ev.save_tum(poses, [i * 0.1 for i in range(6)], str(out[k] / "traj.txt"))
    assert_tum_close(out["port"] / "tum" / "poses.txt", out["jax"] / "tum" / "poses.txt")
    assert_tum_close(out["port"] / "traj.txt", out["jax"] / "traj.txt")


def test_tictoc_and_metrics_formats(tmp_path):
    log = tmp_path / "times.txt"
    t = TicToc()
    ms = t.toc_and_log("front-end", str(log))
    t.tic()
    t.toc_and_log("icp", str(log))
    lines = log.read_text().splitlines()
    assert ms >= 0 and len(lines) == 2
    assert lines[0] == f"front-end: {ms:.3f} ms"
    for line, step in zip(lines, ("front-end", "icp")):
        name, value = line.split(": ")
        assert name == step and value.endswith(" ms") and len(value.split(".")[1]) == 6
    recs = [{"frame": 0, "ms": 1.5, "iterations": 3}, {"frame": 1, "stats": 0.25}]
    for mod in (None, jax_profiling):
        path = tmp_path / f"metrics_{mod is None}.jsonl"
        m = (MetricsLog if mod is None else mod.MetricsLog)(str(path))
        for r in recs:
            m.log(r)
        assert m.records == recs
        assert [json.loads(line) for line in path.read_text().splitlines()] == recs
    assert (tmp_path / "metrics_True.jsonl").read_bytes() == \
        (tmp_path / "metrics_False.jsonl").read_bytes()
    assert MetricsLog().records == []   # no path: records only


def test_device_trace_on_the_cpu_writes_a_trace(tmp_path):
    with DeviceTrace(str(tmp_path / "trace")) as tr:
        torch.ones(256, 256) @ torch.ones(256, 256)
    assert os.path.exists(tr.path)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
