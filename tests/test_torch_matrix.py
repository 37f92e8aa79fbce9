"""Slice C end to end, and the port's method matrix (plo_tpu_torch/
method_matrix.py), the counterpart of tools/method_matrix.py: its 36
configurations equal the tool's; one three-axis combination, projected IMLS,
the ICP solver and Teaser match plo_tpu end to end on JAX's draws; the entry
point's output and its refusal without a card; and the whole matrix on the
port as one slow test, the counterpart of tests/test_odometry.py::
test_method_matrix_all_green_combos_converge.

Tolerances: configurations equal field for field; poses within 2 mm /
1e-4 rad of JAX's (the bound of tests/test_torch_odometry.py), over 2 frames
(one ICP frame) for the solver cases: Teaser's GNC weights turn rounding
differences into different iterates over more frames (its ATE here is
~0.3 m in plo_tpu itself; the reference marks Teaser unverified); every
combination below the slow JAX test's 0.1 m ATE."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_odometry import JaxDraws
from test_torch_sampling_c import torch_cpu  # noqa: F401

from plo_tpu import config as jax_cfg
from plo_tpu.models import Odometry as JaxOdometry
from plo_tpu_torch import method_matrix
from plo_tpu_torch.convert import config_from_dict
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool_config(presample, sampler, match, solver):
    """tools/method_matrix.py's mkcfg, on plo_tpu's config classes."""
    c = jax_cfg
    sm = {"three_axis": c.SampleConfig(method="three_axis",
                                       three_axis=c.ThreeAxisConfig(points_per_list=167)),
          "random": c.SampleConfig(method="random",
                                   random=c.RandomSampleConfig(max_points=1500)),
          "major_axis": c.SampleConfig(method="major_axis",
                                       major_axis=c.MajorAxisConfig(max_total_points=1500))}
    sv = dict(method=solver, iterations=30)
    if solver == "RANSAC":
        sv["ransac"] = c.RANSACConfig(max_iterations=500, distance_threshold=0.3,
                                      final_solve_method="DRPM")
    return c.Config(
        scan_registration=c.ScanRegistrationConfig(
            compute_normal_method=c.ComputeNormalConfig(format="pointcloud", method="pca"),
            presample_method=c.PresampleConfig(method=presample), sample_method=sm[sampler]),
        laser_odometry=c.LaserOdometryConfig(matching_method=c.MatchingConfig(method=match),
                                             solve_method=c.SolveConfig(**sv)),
        sensor=c.SensorConfig(n_scans=32, azimuth_resolution=360.0 / 450))


def test_matrix_configs_are_the_tools():
    assert len(method_matrix.COMBOS) == 36 == len(set(method_matrix.COMBOS))
    for combo in method_matrix.COMBOS:
        assert (dataclasses.asdict(method_matrix.make_config(*combo))
                == dataclasses.asdict(_tool_config(*combo))), combo


def test_three_axis_combination_matches_jax():
    """curvature presample, three-axis sampling, IMLS (hybrid refresh) and
    LS, with the motion prior, on the matrix's hardened sequence: 3 frames
    of the port on JAX's draws against plo_tpu."""
    combo = ("curvature", "three_axis", "IMLS", "LS")
    scans, _ = synthetic.hardened_sequence(3)
    jo = JaxOdometry(_tool_config(*combo), capacity=method_matrix.CAPACITY, seed=0,
                     transfer="float32")
    po = Odometry(method_matrix.make_config(*combo), capacity=method_matrix.CAPACITY,
                  device="cpu")
    for k, s in enumerate(scans):
        fj, fp = jo.process_scan(s), po.process_scan(s, draws=JaxDraws(0, k))
        assert fp.stats["n_sampled"] == fj.stats["n_sampled"] == 9 * 167
        np.testing.assert_allclose(fp.pose[:3, 3], fj.pose[:3, 3], atol=2e-3)
        np.testing.assert_allclose(fp.pose[:3, :3], fj.pose[:3, :3], atol=1e-4)
    assert fp.n_correspondences > 300


def test_matrix_rows_and_report(capsys):
    """run_matrix prints a JSON row per combination and report() the table
    and the summary line; a combination that raises is a failed row."""
    rows = method_matrix.run_matrix("cpu", frames=2, threshold=0.1,
                                    combos=[("geometric_features", "random", "plane_ICP", "LS"),
                                            ("geometric_features", "random", "ICP?", "LS")])
    assert [r["ok"] for r in rows] == [True, False]
    assert rows[0]["iterations"][0] == 0 and rows[0]["iterations"][1] > 0
    assert method_matrix.report(rows, 2, 0.1) == 1
    out = capsys.readouterr().out
    assert '"solver": "LS"' in out and "EXC geometric_features/random/ICP?/LS" in out
    assert "| geometric_features | random | plane_ICP | LS |" in out
    assert "1/2 combos converged (< 0.1 m ATE over 2 frames" in out


@pytest.fixture(scope="module")
def hardened():
    return synthetic.hardened_sequence(2)


def _e2e_config(case):
    """plo_tpu Configs (motion_prior off, the reference-format setting) of
    the end-to-end cases."""
    c = jax_cfg
    lo = dict(motion_prior=False)
    if case == "projected-imls":
        lo.update(matching_method=c.MatchingConfig(imls=c.IMLSConfig(
            use_projected_distance=c.ProjectedDistanceConfig(enabled=True))),
            solve_method=c.SolveConfig(method="LS"))
    elif case == "icp":
        lo.update(matching_method=c.MatchingConfig(method="plane_ICP"),
                  solve_method=c.SolveConfig(method="ICP", iterations=10,
                                             icp=c.ICPSolverConfig(max_iterations=10)))
    else:
        lo.update(matching_method=c.MatchingConfig(method="plane_ICP"),
                  solve_method=c.SolveConfig(method="Teaser", teaser=c.TeaserConfig(
                      estimate_scaling=True)))
    return c.Config(laser_odometry=c.LaserOdometryConfig(**lo),
                    sensor=c.SensorConfig(n_scans=method_matrix.N_SCANS,
                                          azimuth_resolution=360.0 / method_matrix.AZIMUTH_STEPS))


@pytest.mark.parametrize("case", ["projected-imls", "icp", "teaser"])
def test_odometry_matches_jax(hardened, case):
    """The port's Odometry on JAX's draws against plo_tpu's on the method
    matrix's hardened sequence. The ICP case cuts its iteration and solver
    counts to 10 and 10 to keep the CPU run short (chip_smoke's C4 runs them
    uncut on the card)."""
    scans, _ = hardened
    cfg = _e2e_config(case)
    cap = method_matrix.CAPACITY
    jo = JaxOdometry(cfg, capacity=cap, seed=0, transfer="float32")
    po = Odometry(config_from_dict(dataclasses.asdict(cfg)), capacity=cap, device="cpu")
    for k, s in enumerate(scans):
        fj = jo.process_scan(s)
        fp = po.process_scan(s, draws=JaxDraws(0, k))
        np.testing.assert_allclose(fp.pose[:3, 3], fj.pose[:3, 3], atol=2e-3)
        np.testing.assert_allclose(fp.pose[:3, :3], fj.pose[:3, :3], atol=1e-4)
        if k:
            assert fp.n_correspondences > 100 and abs(fp.n_correspondences
                                                      - fj.n_correspondences) <= 5


def test_method_matrix_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        method_matrix.main(["--frames", "2"])


@pytest.mark.slow
def test_method_matrix_all_green_combos_converge_on_the_port():
    """All 36 combinations through the port on the CPU, 6 frames, each below
    0.1 m ATE."""
    out = subprocess.run(
        [sys.executable, "-m", "plo_tpu_torch.method_matrix", "--frames", "6",
         "--threshold", "0.1", "--device", "cpu"],
        capture_output=True, text=True, timeout=3500, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "36/36 combos converged" in out.stdout
