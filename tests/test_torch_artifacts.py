"""The saver's artifact mode in the port against plo_tpu's: the ICP loop
that dumps each iteration's matched pairs (matched_points/f*_i*.txt) and
pose (iter_poses.txt), on plane-ICP (tests/test_cli.py's light config) and
on the default IMLS config, 3 corridor frames at 32 beams x 450, capacity
16384, on plo_tpu's draws.

Tolerances: the same file names (so the same iteration counts), row counts
exactly, coordinates within 1e-4 m and iter_poses.txt's values within 1e-5
(f32 differences of the same arithmetic; seen 3.3e-5 m and 8.4e-6). On IMLS
one row a file may be off by up to 1e-3 m: from frame 2 on the source starts
from a pose ~1e-6 m off JAX's, and one matched point's IMLS neighbourhood
crosses a gate (seen: 4.9e-4 m, one row of 457; fed the same source, the two
projections agree within 1e-6 m). On plane-ICP the artifact loop is the ICP
loop, so the port's poses with artifacts equal its poses without."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES = 32, 450, 16384, 3
LIGHT = {   # tests/test_cli.py::light_config
    "scan_registration": {
        "compute_normal_method": {"format": "pointcloud", "method": "pca"},
        "presample_method": {"method": "geometric_features"},
        "sample_method": {"method": "random", "random": {"max_points": 1500}},
    },
    "laser_odometry": {
        "matching_method": {"method": "plane_ICP"},
        "solve_method": {"method": "LS", "iterations": 20},
    },
}


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module, then one parallel sqrt on every
    thread (tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def config(mod, name, tmp_path, out_dir):
    sensor = mod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS)
    if name == "plane-ICP":
        path = tmp_path / "light.json"
        path.write_text(json.dumps(LIGHT))
        cfg = mod.load(str(path), sensor=sensor)
    else:
        cfg = mod.Config(sensor=sensor)
    return dataclasses.replace(cfg, saver=mod.SaverConfig(output_dir=out_dir,
                                                          enabled=out_dir is not None))


@pytest.fixture(scope="module")
def world():
    w = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                            speed=0.5, yaw_rate=0.01, seed=3, world=w)
    return scans


def port_run(cfg, scans):
    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu")
    for k, s in enumerate(scans):
        odo.process_scan(s, draws=JaxDraws(0, k))
    return odo


def read(path):
    return np.loadtxt(path, ndmin=2)


@pytest.mark.parametrize("name", ["plane-ICP", "IMLS"])
def test_artifacts_match_jax(world, tmp_path, name):
    out = {k: str(tmp_path / k) for k in ("port", "jax")}
    jodo = JaxOdometry(config(jax_cfg, name, tmp_path, out["jax"]), capacity=CAPACITY, seed=0,
                       transfer="float32")
    for s in world:
        jodo.process_scan(s)
    odo = port_run(config(port_cfg, name, tmp_path, out["port"]), world)

    names = sorted(os.listdir(os.path.join(out["jax"], "matched_points")))
    assert sorted(os.listdir(os.path.join(out["port"], "matched_points"))) == names
    assert names[0] == "f000001_i00.txt"
    assert len(names) == sum(f.iterations for f in jodo.trajectory)
    assert [f.iterations for f in odo.trajectory] == [f.iterations for f in jodo.trajectory]
    for n in names:
        a, b = (read(os.path.join(out[k], "matched_points", n)) for k in ("port", "jax"))
        assert a.shape == b.shape and a.shape[1] == 6, n
        err = np.abs(a - b).max(1)
        assert (err > 1e-4).sum() <= (1 if name == "IMLS" else 0), (n, np.sort(err)[-3:])
        assert err.max() < 1e-3, (n, err.max())
    lines = {k: open(os.path.join(out[k], "iter_poses.txt")).read().splitlines() for k in out}
    assert len(lines["port"]) == len(names)
    assert [ln.split()[0] for ln in lines["port"]] == [ln.split()[0] for ln in lines["jax"]]
    vals = {k: np.array([[float(v) for v in ln.split()[1:]] for ln in lines[k]]) for k in out}
    np.testing.assert_allclose(vals["port"], vals["jax"], rtol=0, atol=1e-5)
    if name == "plane-ICP":
        plain = port_run(config(port_cfg, name, tmp_path, None), world)
        assert np.array_equal(plain.poses(), odo.poses())
        assert [f.iterations for f in plain.trajectory] == [f.iterations for f in odo.trajectory]
