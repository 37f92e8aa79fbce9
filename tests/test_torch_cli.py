"""The port's command-line runner (python -m plo_tpu_torch.cli) on the CPU:
tests/test_cli.py's two cases with the same assertions, a checkpoint resume
that repeats the uninterrupted run bit for bit, and the refusal to run
without a card unless `--platform cpu` asks for the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_cli import light_config

from plo_tpu_torch import cli
from plo_tpu_torch.io import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two torch threads a run (the suite runs on 6 pytest workers side by side).
ENV = dict(os.environ, OMP_NUM_THREADS="2")


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cli(args):
    return subprocess.run([sys.executable, "-m", "plo_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=600, env=ENV, cwd=REPO)


def test_cli_synthetic_run(tmp_path, capsys):
    """In process (the kitti case below runs `python -m`)."""
    rc = cli.main(["--dataset", "synthetic", "--frames", "3", "--platform", "cpu",
                   "--capacity", "16384", "--scan-lines", "32", "--azimuth-steps", "450",
                   "--azimuth-resolution", "0.8", "--config", light_config(tmp_path),
                   "--output", str(tmp_path), "--eval-gt", "--save-artifacts"])
    assert rc == 0
    out = capsys.readouterr()
    # Trajectory + metrics written.
    assert (tmp_path / "trajectory_tum.txt").exists()
    lines = (tmp_path / "trajectory_tum.txt").read_text().strip().split("\n")
    assert len(lines) == 3 and len(lines[0].split()) == 8
    metrics = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().strip().split("\n")]
    assert len(metrics) == 3
    assert "correspondences" in metrics[0]
    # Artifacts in reference formats.
    assert (tmp_path / "pcl_cloud" / "000000.txt").exists()
    assert (tmp_path / "pca_markers" / "000000.obj").exists()
    assert (tmp_path / "imls_results.txt").exists()
    # Per-iteration ICP artifacts (laser_odometry.cpp:621-625).
    m0 = tmp_path / "matched_points" / "f000001_i00.txt"
    assert m0.exists()
    assert len(m0.read_text().strip().split("\n")[0].split()) == 6  # sx sy sz rx ry rz
    iter_lines = (tmp_path / "iter_poses.txt").read_text().strip().split("\n")
    assert len(iter_lines) >= 2 and len(iter_lines[0].split()) == 8  # TUM rows
    # ATE JSON line on stdout.
    ate_line = [l for l in out.out.strip().split("\n") if l.startswith("{")][-1]
    assert "ate_m" in json.loads(ate_line)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """tests/test_cli.py::test_cli_kitti_layout's sequence (3 frames at 32 x
    450, 0.5 m a frame, seed 4) and one more frame, in the KITTI layout with
    a non-trivial Tr (the reader must conjugate the ground truth back into
    the velodyne frame)."""
    scans, gt_velo = synthetic.synthetic_sequence(
        4, n_scans=32, azimuth_steps=450, speed=0.5, yaw_rate=0.005, seed=4)
    root = tmp_path_factory.mktemp("kitti")
    tr = np.eye(4)
    tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    tr[:3, 3] = [0.05, -0.07, -0.27]
    synthetic.write_kitti_layout(str(root), scans, gt_velo, seq="07", tr=tr)
    return root


def kitti_args(root, cfg, out, *extra):
    return ["--dataset", "kitti", "--kitti-root", str(root), "--seq", "07",
            "--platform", "cpu", "--capacity", "16384", "--scan-lines", "32",
            "--azimuth-resolution", "0.8", "--config", cfg, "--output", str(out), *extra]


def test_cli_kitti_layout(tmp_path, kitti_root):
    out = run_cli(kitti_args(kitti_root, light_config(tmp_path), tmp_path / "out",
                             "--frames", "3", "--eval-gt"))
    assert out.returncode == 0, out.stderr[-2000:]
    ate_line = [l for l in out.stdout.strip().split("\n") if l.startswith("{")][-1]
    ate = json.loads(ate_line)["ate_m"]
    assert ate < 0.1, f"KITTI-layout ATE too high: {ate}"


def range_image_config(tmp_path):
    """A reference-format config.json the CPU runs faster than the light
    one: range-image PCA normals, random 1,200, IMLS, LS."""
    p = tmp_path / "range_image.json"
    p.write_text(json.dumps({
        "scan_registration": {
            "compute_normal_method": {"format": "range_image", "method": "pca"},
            "presample_method": {"method": "geometric_features"},
            "sample_method": {"method": "random", "random": {"max_points": 1200}},
        },
        "laser_odometry": {
            "matching_method": {"method": "IMLS"},
            "solve_method": {"method": "LS", "iterations": 20},
        },
    }))
    return str(p)


def test_cli_resume_repeats_the_uninterrupted_run(tmp_path, kitti_root, capsys):
    """4 frames in one run; then 2 frames checkpointed and the last 2
    resumed from the checkpoint: the resumed frames' TUM lines are the
    uninterrupted run's, byte for byte."""
    cfg = range_image_config(tmp_path)
    assert cli.main(kitti_args(kitti_root, cfg, tmp_path / "full", "--frames", "4")) == 0
    assert cli.main(kitti_args(kitti_root, cfg, tmp_path / "first", "--frames", "2",
                               "--checkpoint-every", "2")) == 0
    assert cli.main(kitti_args(kitti_root, cfg, tmp_path / "resumed", "--start", "2",
                               "--frames", "2", "--resume",
                               str(tmp_path / "first" / "ckpt.npz"))) == 0
    assert "resumed at frame 2" in capsys.readouterr().out
    full = (tmp_path / "full" / "trajectory_tum.txt").read_text().splitlines()
    resumed = (tmp_path / "resumed" / "trajectory_tum.txt").read_text().splitlines()
    assert len(full) == 4 and resumed == full[2:]


def test_cli_without_a_card_fails_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="runs on a CUDA device and none is available"):
        cli.main(["--dataset", "synthetic", "--frames", "1", "--output", str(out)])
    assert not out.exists()
