"""The slice end to end: the port's Odometry against plo_tpu's on synthetic
scans at the tests/test_odometry.py CPU size (32 beams x 450, capacity
16384), default Config() with motion_prior=False (the reference-format
setting, config.py:464); plus the resume through convert.py and the guards
that keep the port free of JAX.

The world is the structure-rich corridor of test_imls_ransac_drpm: the
identity-init regime needs walls around the ground plane to pin x/y (on the
default around-path world plo_tpu itself does not stay under the bound over
these 5 frames)."""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.convert import config_from_dict, odometry_state_from_numpy
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import evaluate

N_SCANS, AZ_STEPS, CAPACITY, N_FRAMES, RESUME_AFTER = 32, 450, 16384, 5, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_warm():
    """Two torch threads for the module (the suite runs on 6 pytest workers
    side by side; tests/test_torch_headline.py says what a full pool a worker
    costs), then one parallel sqrt on every torch CPU thread before any
    comparison. In a process where JAX has run, the first vectorized sqrt a
    fresh torch worker thread computes can come back far off the last bit on
    that thread's rows (seen with torch 2.13+cpu); later calls are within an
    ulp. A defect of the CPU math library, not of the code under test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def jax_config():
    return jax_cfg.Config(
        laser_odometry=jax_cfg.LaserOdometryConfig(motion_prior=False),
        sensor=jax_cfg.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS))


class JaxDraws:
    """The draws plo_tpu's Odometry(seed) makes for frame `frame`: its host
    counter keys are [seed, 1] for frame 0's front-end, then [seed, 2f] for
    frame f's front-end and [seed, 2f+1] for its ICP, folded with the
    iteration index (models/odometry.py:298)."""

    def __init__(self, seed, frame):
        key = lambda c: jnp.asarray([np.uint32(seed), np.uint32(c)])
        self.fe_key = key(1 if frame == 0 else 2 * frame)
        self.icp_key = key(2 * frame + 1)

    def frontend(self, n, p):
        if n == 0:   # three-axis sampling draws nothing
            return []
        keys = [self.fe_key] if n == 1 else list(jax.random.split(self.fe_key))
        return [torch.from_numpy(np.array(jax.random.uniform(k, (p,)))) for k in keys]

    def ransac(self, iteration, n_valid, m):
        k = jax.random.fold_in(self.icp_key, iteration)
        return torch.from_numpy(np.array(jax.random.randint(k, (m,), 0, int(n_valid)))).long()

    def teaser(self, iteration, n, m):
        """Teaser's scale-estimate pairs (plo_tpu/solvers/gnc.py:78-80)."""
        ka, kb = jax.random.split(jax.random.fold_in(self.icp_key, iteration))
        return tuple(torch.from_numpy(np.array(jax.random.randint(k, (m,), 0, n))).long()
                     for k in (ka, kb))


class JaxBatchDraws(JaxDraws):
    """The draws of frame `frame` inside plo_tpu's batched step
    (models/odometry.py:548,564): the front-end takes
    fold_in(PRNGKey(seed), frame), the ICP fold_in of that with 1, folded
    with the iteration index. Frames that plo_tpu runs one by one after a
    batch take its host counter keys, which only those calls advance: the
    k-th such call after frame 0 has JaxDraws' keys of frame k
    (`JaxDraws(seed, k)`)."""

    def __init__(self, seed, frame):
        self.fe_key = jax.random.fold_in(jax.random.PRNGKey(seed), frame)
        self.icp_key = jax.random.fold_in(self.fe_key, 1)


def cloud_arrays(cloud):
    return {f.name: np.array(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


@pytest.fixture(scope="module")
def run():
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZ_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=world)
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    odo = JaxOdometry(jax_config(), capacity=CAPACITY, seed=0, transfer="float32")
    state = None
    for i, s in enumerate(scans):
        odo.process_scan(s)
        if i == RESUME_AFTER:
            state = dict(
                last_filtered=cloud_arrays(odo.last_filtered),
                cloud_queue=[cloud_arrays(c) for c in odo.cloud_queue],
                frame_count=odo.frame_count, last_rel=np.array(odo._last_rel),
                trajectory=[dataclasses.asdict(f) for f in odo.trajectory])
    return scans, gt, odo.poses(), state


def test_slice_end_to_end_ate(run):
    """Both trajectories under the ATE bound of tests/test_odometry.py; the
    port on its own torch.Generator draws, through the kernels' wrappers."""
    scans, gt, jax_poses, _ = run
    assert evaluate.ate_rmse(jax_poses, gt, align=False) < 0.1
    odo = Odometry(config_from_dict(dataclasses.asdict(jax_config())), capacity=CAPACITY,
                   seed=0, device="cpu")
    frames = [odo.process_scan(s) for s in scans]
    est = odo.poses()
    assert np.isfinite(est).all()
    assert evaluate.ate_rmse(est, gt, align=False) < 0.1
    assert all(f.n_correspondences > 100 for f in frames[1:])
    assert all(0 < f.stats["n_sampled"] <= 2000 for f in frames[1:])


def test_resume_from_jax_state_matches_jax(run):
    """Load plo_tpu's state after frame k into the port and run the
    remaining frames on JAX's draws: each pose matches JAX's to 2 mm and
    1e-4 rad (f32 differences of the same arithmetic, through up to 30 ICP
    iterations)."""
    scans, _, jax_poses, state = run
    odo = Odometry(port_cfg.Config(
        laser_odometry=port_cfg.LaserOdometryConfig(motion_prior=False),
        sensor=port_cfg.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZ_STEPS)),
        capacity=CAPACITY, seed=0, device="cpu")
    odometry_state_from_numpy(odo, **state)
    np.testing.assert_array_equal(odo.poses(), jax_poses[:RESUME_AFTER + 1])
    for k in range(RESUME_AFTER + 1, N_FRAMES):
        f = odo.process_scan(scans[k], draws=JaxDraws(0, k))
        np.testing.assert_allclose(f.pose[:3, 3], jax_poses[k][:3, 3], atol=2e-3)
        np.testing.assert_allclose(f.pose[:3, :3], jax_poses[k][:3, :3], atol=1e-4)


def test_odometry_without_a_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Odometry(port_cfg.Config())


def test_unported_options_raise(tmp_path, run):
    """No option of the single-device Config is refused any more: the last
    one, the saver's artifact mode, constructs and runs a frame on the CPU
    (its ICP trail: tests/test_torch_artifacts.py)."""
    scans = run[0]
    cfg = port_cfg.Config(saver=port_cfg.SaverConfig(enabled=True, output_dir=str(tmp_path)),
                          sensor=port_cfg.SensorConfig(n_scans=N_SCANS,
                                                       azimuth_resolution=360.0 / AZ_STEPS))
    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device="cpu")
    assert odo._artifact_dir == str(tmp_path)
    f = odo.process_scan(scans[0])
    assert f.index == 0 and np.array_equal(f.pose, np.eye(4))


_BLOCK_JAX = """
import importlib, importlib.abc, importlib.util, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "plo_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import plo_tpu_torch
for m in pkgutil.walk_packages(plo_tpu_torch.__path__, "plo_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "plo_tpu")]
assert not bad, bad
print("imported without jax")
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert "imported without jax" in proc.stdout


def test_port_sources_name_no_jax():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|plo_tpu)(\s|\.|$)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "plo_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as fh:
            assert not pat.search(fh.read()), p


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """With no CUDA device (and, alone, with nothing of the repo beside it)
    chip_smoke.py exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
