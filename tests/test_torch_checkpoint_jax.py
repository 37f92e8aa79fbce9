"""Checkpoint files written by plo_tpu's checkpoint.save, loaded into the
port (plo_tpu_torch/utils/checkpoint.py): plo_tpu's run is saved after k
frames and continued; the port loads the file and runs the next 2 frames on
plo_tpu's draws (JaxDraws of each frame's index, which the file's
frame_count gives). 32 beams x 450, capacity 16384, the corridor frames, the
configs of tests/test_torch_checkpoint.py.

Tolerances: poses within 2 mm and 1e-4 rad (the bound of
tests/test_torch_odometry.py's resume test) and ICP iteration counts within
one: the loaded state mixes plo_tpu's init pose (last_rel, 2.4e-7 off the
port's own) with plo_tpu's window, and on that mix the port's LS delta of
frame 2 falls just above the 1 mm convergence threshold where plo_tpu's falls
below it (one more iteration, 5e-5 m; from the port's own state, or with
either piece the port's, the counts are equal). With BA within 1e-4 m and
5e-5 rad (tests/test_torch_ba.py's bound)."""
import numpy as np
import pytest
import torch
from test_torch_ba import assert_trajectories_close
from test_torch_checkpoint import CASES, frames_by_index, scans  # noqa: F401
from test_torch_odometry import JaxDraws

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu.utils import checkpoint as jax_checkpoint
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import checkpoint

CAPACITY = 16384


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module, then one parallel sqrt on every
    thread (tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["window", "ba"])
def test_jax_checkpoint_loads_into_the_port(scans, tmp_path, case):
    make, _, k, _ = CASES[case]
    jodo = JaxOdometry(make(jax_cfg), capacity=CAPACITY, seed=0, transfer="float32")
    for s in scans[:k]:
        jodo.process_scan(s)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(jodo, path)
    for s in scans[k:k + 2]:
        jodo.process_scan(s)
    odo = checkpoint.load(Odometry(make(port_cfg), capacity=CAPACITY, seed=0, device="cpu"),
                          path)
    assert odo.frame_count == k
    for i in range(k, k + 2):
        odo.process_scan(scans[i], draws=JaxDraws(0, odo.frame_count))
    ref = frames_by_index(jodo)
    got = frames_by_index(odo)
    if case == "ba":
        assert sorted(got) == list(range(k + 2 - len(got), k + 2)) and min(got) < k
        assert_trajectories_close(np.stack([f.pose for f in got.values()]),
                                  np.stack([ref[i].pose for i in got]))
        return
    assert sorted(got) == [k, k + 1]
    for i, f in got.items():
        np.testing.assert_allclose(f.pose[:3, 3], ref[i].pose[:3, 3], rtol=0, atol=2e-3)
        np.testing.assert_allclose(f.pose[:3, :3], ref[i].pose[:3, :3], rtol=0, atol=1e-4)
        assert abs(f.iterations - ref[i].iterations) <= 1, (i, f.iterations, ref[i].iterations)
