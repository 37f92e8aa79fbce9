"""plo_tpu's own ATE on chip_smoke.py's phase 7 and 9 paths (C1-C7, D1-D7):
the same configs (chip_smoke.slice_c_configs and slice_d_configs on
plo_tpu.config), the same 5 corridor frames (HDL-64 x 900; C3 on a VLP-32C
at 0.2 deg; D4 on chip_smoke.make_swept_sequence), capacity 131072 (D1, D2: 57600),
frame by frame through plo_tpu's Odometry with JAX on the CPU.
chip_smoke.py's JAX_ATE_M holds these numbers: where one is below 0.05 m
the port's path on the card must meet the 0.1 m bound.

    JAX_PLATFORMS=cpu python tests/reference_ate.py [C1 C2 ... D1 "D4 off" ...]

    JAX_PLATFORMS=cpu python tests/reference_ate.py --bench-map {dense,grid_hash}

--bench-map runs plo_tpu's map mode as tools/bench_map_mode.py does (its
config, the 113 bench scans, grid16, batch 16) and prints each frame's ICP
iterations and the ATE.

A D4 name with the suffix "@phase3" ("D4@phase3", "D4 off@phase3") runs
phase 3's own frames swept by distort_sequence instead: the motion at which
compensation does not lower plo_tpu's ATE.

Prints one JSON line per path (ATE in m, ICP iterations, correspondences).
"""
import dataclasses
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
    cfgs = {**chip_smoke.slice_c_configs(cfgmod, REPO), **chip_smoke.slice_d_configs(cfgmod, REPO)}
    hdl, vlp, swept = None, None, None
    for name in names or list(cfgs):
        cfg_name, _, variant = name.partition("@")
        if name == "C3":
            vlp = vlp or chip_smoke.make_vlp32_sequence()
            scans, gt = vlp
        else:
            hdl = hdl or chip_smoke.make_sequence()
            scans, gt = hdl
            if variant == "phase3":
                from plo_tpu_torch.io import synthetic
                scans = synthetic.distort_sequence(scans, gt, chip_smoke.N_SCANS)
            elif name.startswith("D4"):
                swept = swept or chip_smoke.make_swept_sequence()
                scans, gt = swept
        t0 = time.perf_counter()
        capacity = chip_smoke.MAP_CAPACITY if name in ("D1", "D2") else chip_smoke.CAPACITY
        odo = Odometry(cfgs[cfg_name], capacity=capacity, seed=0, transfer="float32")
        frames = [odo.process_scan(s) for s in scans]
        est = odo.poses()
        ate = evaluate.ate_rmse(est, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt),
                                align=False)
        print(json.dumps(dict(path=name, jax_ate_m=float(ate), finite=bool(np.isfinite(est).all()),
                              iterations=[f.iterations for f in frames],
                              correspondences=[f.n_correspondences for f in frames],
                              seconds=round(time.perf_counter() - t0, 1))), flush=True)


def bench_map(search):
    from plo_tpu_torch import bench
    cfg = chip_smoke.slice_d_configs(cfgmod, REPO)["D1"]
    cfg = dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, map=dataclasses.replace(cfg.laser_odometry.map, search=search)))
    scans, gt = bench.cached_sequence(workers=4)
    t0 = time.perf_counter()
    odo = Odometry(cfg, capacity=bench.CAPACITY, seed=0, async_mode=True, transfer="grid16")
    odo.process_scans(scans, batch=bench.BATCH)
    odo.finalize()
    ate = evaluate.ate_rmse(odo.poses(), np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt),
                            align=False)
    print(json.dumps(dict(bench_map=search, jax_ate_m=float(ate),
                          iterations=[f.iterations for f in odo.trajectory],
                          seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bench-map"]:
        bench_map(sys.argv[2])
    else:
        main(sys.argv[1:])
