"""Checkpoint and resume (plo_tpu_torch/utils/checkpoint.py): save -> load
-> continue against the uninterrupted run of the port, in window mode, map
mode, batched (process_scans) and with windowed BA saved mid-window, at 32
beams x 450, capacity 16384, on the corridor frames
(tests/test_torch_checkpoint_jax.py loads plo_tpu's files).

Tolerance: none; the resumed run is bit for bit the uninterrupted one on the
CPU (poses, ICP iterations, correspondences and stats), the generator's
state being in the file."""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_map_mode import map_config

from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import checkpoint

N_SCANS, AZ_STEPS, CAPACITY = 32, 450, 16384


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Two torch threads for the module, then one parallel sqrt on every
    thread (tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans():
    w = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    return synthetic.synthetic_sequence(6, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                        speed=0.5, yaw_rate=0.01, seed=3, world=w)[0]


def window_cfg(mod):
    """tests/test_torch_map_mode.py's config (range-image PCA, geometric
    presample, random 1,200, frozen IMLS, LS) on the window target."""
    cfg = map_config(mod)
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, target_mode="window"))


def ba_cfg(mod):
    """window_cfg with windowed BA over 4 frames, 512 correspondences a
    record (tests/test_ba.py::_ba_cfg's BA settings)."""
    cfg = window_cfg(mod)
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, ba=mod.BAConfig(enabled=True, window=4, iterations=4,
                                            max_correspondences=512)))


CASES = {   # config, frames, frames before the save, batch
    "window": (window_cfg, 4, 2, None),
    "map": (map_config, 4, 2, None),
    "batched": (window_cfg, 5, 3, 2),
    "ba": (ba_cfg, 5, 3, None),   # saved with records the first refine needs
}


def run(odo, scans, batch):
    if batch is None:
        for s in scans:
            odo.process_scan(s)
    else:
        odo.process_scans(scans, batch=batch)
        odo.finalize()
    return odo


def frames_by_index(odo):
    return {f.index: f for f in odo.trajectory}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_repeats_the_uninterrupted_run(scans, tmp_path, case):
    make, n, k, batch = CASES[case]
    cfg = make(port_cfg)
    odo = lambda: Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu",
                           async_mode=batch is not None)
    full = run(odo(), scans[:n], batch)
    path = str(tmp_path / "sub" / "ckpt.npz")
    checkpoint.save(run(odo(), scans[:k], batch), path)
    resumed = checkpoint.load(odo(), path)
    assert resumed.frame_count == k
    run(resumed, scans[k:n], batch)
    got, ref = frames_by_index(resumed), frames_by_index(full)
    assert max(got) == n - 1 and min(got) <= k
    if case == "ba":
        assert min(got) < k   # the restored tail, refined again after the resume
    for i, f in got.items():
        g = ref[i]
        assert np.array_equal(f.pose, g.pose), i
        if i >= k:
            assert (f.iterations, f.n_correspondences, f.stats) == \
                (g.iterations, g.n_correspondences, g.stats), i


def test_resume_continues_per_frame_after_a_batch(scans, tmp_path):
    """A batched run saved with its window on the device, resumed frame by
    frame, repeats the uninterrupted batched-then-per-frame run."""
    cfg = window_cfg(port_cfg)
    full = Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu", async_mode=True)
    run(full, scans[:3], 2)
    run(full, scans[3:5], None)
    a = Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu", async_mode=True)
    run(a, scans[:3], 2)
    assert a._device_window is not None
    checkpoint.save(a, str(tmp_path / "ckpt.npz"))
    b = checkpoint.load(Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu"),
                        str(tmp_path / "ckpt.npz"))
    run(b, scans[3:5], None)
    assert np.array_equal(b.poses(), full.poses()[3:])
