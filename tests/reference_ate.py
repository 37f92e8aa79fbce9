"""plo_tpu's own ATE on chip_smoke.py's phase 7 paths (C1-C7): the same
configs (chip_smoke.slice_c_configs on plo_tpu.config), the same 5 corridor
frames (HDL-64 x 900; C3 on a VLP-32C at 0.2 deg), capacity 131072, frame
by frame through plo_tpu's Odometry with JAX on the CPU. chip_smoke.py's
JAX_ATE_M holds these numbers: where one is below 0.05 m the port's path on
the card must meet the 0.1 m bound.

    JAX_PLATFORMS=cpu python tests/reference_ate.py [C1 C2 ...]

Prints one JSON line per path (ATE in m, ICP iterations, correspondences).
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from plo_tpu import config as cfgmod  # noqa: E402
from plo_tpu.models import Odometry  # noqa: E402
from plo_tpu.utils import evaluate  # noqa: E402


def main(names):
    cfgs = chip_smoke.slice_c_configs(cfgmod, REPO)
    hdl, vlp = None, None
    for name in names or list(cfgs):
        if name == "C3":
            vlp = vlp or chip_smoke.make_vlp32_sequence()
            scans, gt = vlp
        else:
            hdl = hdl or chip_smoke.make_sequence()
            scans, gt = hdl
        t0 = time.perf_counter()
        odo = Odometry(cfgs[name], capacity=chip_smoke.CAPACITY, seed=0, transfer="float32")
        frames = [odo.process_scan(s) for s in scans]
        est = odo.poses()
        ate = evaluate.ate_rmse(est, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt),
                                align=False)
        print(json.dumps(dict(path=name, jax_ate_m=float(ate), finite=bool(np.isfinite(est).all()),
                              iterations=[f.iterations for f in frames],
                              correspondences=[f.n_correspondences for f in frames],
                              seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
