"""tests/test_planetary.py's first claim on plo_tpu_torch: on the planetary
world (tests/test_torch_planetary.py says which), Weighted LS hallucinates
lateral motion from the unconstrained null space, and DRPM holds still in
it. The port frame by frame with each final solve, on plo_tpu's draws; the
bounds are tests/test_planetary.py's. A file of its own: its Weighted LS run
takes 10-30 ICP iterations a frame, each a kNN re-search."""
import numpy as np
import pytest
import torch
from test_torch_planetary import planetary, run  # noqa: F401  (fixture)

from plo_tpu_torch.utils import evaluate


@pytest.fixture(scope="module", autouse=True)
def torch_cpu_threads():
    """Four torch threads for the module (the other port files take two, as
    the suite runs on 6 pytest workers side by side): the Weighted LS run
    re-searches kNN (1,500 queries, 16,384 slots, 0.4-0.7 s on two threads)
    every ICP iteration, 10-30 a frame. Then one parallel sqrt on every thread (see
    tests/test_torch_odometry.py::torch_cpu_warm)."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    torch.sqrt(torch.rand(4096, 512))
    yield
    torch.set_num_threads(n)


def test_drpm_bounds_degenerate_chain(planetary):  # noqa: F811
    """Weighted LS hallucinates lateral motion from the unconstrained null
    space; DRPM holds still in it: cross-track below 0.1 m, ATE below 0.7 of
    WLS's, no frame further from the ground truth than the distance
    travelled."""
    scans, gtr = planetary
    est_wls, est_drpm = run(scans, "Weighted LS").poses(), run(scans, "DRPM").poses()
    cross_wls = np.abs(est_wls[:, 1, 3] - gtr[:, 1, 3]).max()
    cross_drpm = np.abs(est_drpm[:, 1, 3] - gtr[:, 1, 3]).max()
    assert cross_wls > 1.0, cross_wls
    assert cross_drpm < 0.10, cross_drpm
    ate_wls = evaluate.ate_rmse(est_wls, gtr, align=False)
    ate_drpm = evaluate.ate_rmse(est_drpm, gtr, align=False)
    assert ate_drpm < 0.7 * ate_wls, (ate_drpm, ate_wls)
    total = np.linalg.norm(gtr[-1, :3, 3])
    assert np.linalg.norm(est_drpm[-1, :3, 3] - gtr[-1, :3, 3]) <= total + 0.1
