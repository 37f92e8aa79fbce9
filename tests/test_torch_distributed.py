"""The port's sharded map odometry across a real process boundary: two
processes of `python -m plo_tpu_torch.parallel.worker`, 4 CPU shards each,
joined over gloo (parallel/distributed.py), against the port in one process:
the single-device map run within 0.01 m a pose (tests/test_distributed.py:55)
and the same 8 shards driven by one process bit for bit (the collectives keep
the global shard order, and every process computes the same replicated
values; all three runs on one torch thread a process).

The one-process run is held against plo_tpu too: the worker's config (which
must equal tools/mp_worker.py's) and scans through plo_tpu's in-process
ShardedMapOdometry on 8 virtual devices, and through the port's fed
plo_tpu's [seed, counter] draws (JaxDraws), within 2 mm a position and
1e-4 a rotation entry, the parity bound of
tests/test_torch_sharded_odometry.py (seen 9.9e-5 m and 2.0e-5). The
worker differs from that run only in the source of its draws, the port's own
generator, which the bit-for-bit comparison covers."""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_distributed import _dist_config as jax_dist_config
from test_torch_odometry import JaxDraws

from plo_tpu.parallel import ShardedMapOdometry as JaxShardedMapOdometry
from plo_tpu.parallel import get_mesh as jax_get_mesh
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.parallel import get_mesh
from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
from plo_tpu_torch.parallel.worker import dist_config, dist_scans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One torch thread, as each worker runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans():
    return dist_scans(FRAMES)[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_map_matches_single_process(tmp_path, scans):
    port, out = _free_port(), str(tmp_path / "poses.npy")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}

    def launch(pid):
        return subprocess.Popen(
            [sys.executable, "-m", "plo_tpu_torch.parallel.worker", "--process-id", str(pid),
             "--num-processes", "2", "--port", str(port), "--local-devices", "4",
             "--frames", str(FRAMES), "--device", "cpu", "--out", out],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = [launch(0), launch(1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{log[-4000:]}"
    assert all("8 frames on 8 shards (cpu)" in log for log in logs), logs
    mp_poses = np.load(out)
    assert mp_poses.shape == (FRAMES, 4, 4) and np.isfinite(mp_poses).all()

    odo = Odometry(dist_config(), capacity=8192, seed=0, device="cpu")
    for s in scans:
        odo.process_scan(s)
    assert np.linalg.norm(mp_poses[:, :3, 3] - odo.poses()[:, :3, 3], axis=1).max() < 0.01

    one = ShardedMapOdometry(dist_config(), get_mesh(8, device="cpu"), capacity=8192, seed=0)
    for s in scans:
        one.process_scan(s)
    np.testing.assert_array_equal(mp_poses, one.poses())


def test_worker_config_one_process_matches_jax(scans):
    """The worker's config and scans, one process on 8 CPU shards with
    plo_tpu's draws, against plo_tpu's ShardedMapOdometry on 8 virtual
    devices (per frame)."""
    jcfg = jax_dist_config()
    assert config_from_dict(dataclasses.asdict(jcfg)) == dist_config()
    jodo = JaxShardedMapOdometry(jcfg, jax_get_mesh(8), capacity=8192, seed=0,
                                 defer_fetch=True)
    for s in scans:
        jodo.process_scan(s)
    jax_poses = jodo.poses()
    one = ShardedMapOdometry(dist_config(), get_mesh(8, device="cpu"), capacity=8192, seed=0,
                             defer_fetch=True)
    for k, s in enumerate(scans):
        one.process_scan(s, draws=JaxDraws(0, k))
    poses = one.poses()
    np.testing.assert_allclose(poses[:, :3, 3], jax_poses[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(poses[:, :3, :3], jax_poses[:, :3, :3], atol=1e-4)
    assert all(f.n_correspondences > 300 for f in one.trajectory[1:])
