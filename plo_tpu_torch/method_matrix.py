"""The method matrix on the port — the counterpart of tools/method_matrix.py
(the results.png analog): every green reference combination of
normals = pca x presample {geometric_features, curvature} x sampler
{three_axis, random, major_axis} x matching {IMLS, plane_ICP} x solver
{Ceres, LS, RANSAC}, 36 in all, on the hardened synthetic sequence (the
corridor world at 32 beams x 450, 2 cm range noise, sweep distortion, 1 %
dynamic outliers), each through Odometry.process_scan at capacity 16384.
Prints one JSON line per combination, a markdown table and the line
"N/36 combos converged"; exits 1 unless all converge.

    python -m plo_tpu_torch.method_matrix [--frames 6] [--threshold 0.15] [--device cpu]

Runs on the CUDA card; without one it raises unless given --device cpu.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time
import traceback

import numpy as np

from plo_tpu_torch import config as cfgmod, resolve_device
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.utils import evaluate

N_SCANS, AZIMUTH_STEPS, CAPACITY = 32, 450, 16384
PRESAMPLES = ("geometric_features", "curvature")
SAMPLERS = ("three_axis", "random", "major_axis")
MATCHES = ("IMLS", "plane_ICP")
SOLVERS = ("Ceres", "LS", "RANSAC")
COMBOS = tuple(itertools.product(PRESAMPLES, SAMPLERS, MATCHES, SOLVERS))


def make_config(presample: str, sampler: str, match: str, solver: str) -> cfgmod.Config:
    """tools/method_matrix.py's mkcfg: the Python Config defaults (so the
    motion prior is on) with the combination's stages."""
    sm = {"three_axis": cfgmod.SampleConfig(
              method="three_axis", three_axis=cfgmod.ThreeAxisConfig(points_per_list=167)),
          "random": cfgmod.SampleConfig(
              method="random", random=cfgmod.RandomSampleConfig(max_points=1500)),
          "major_axis": cfgmod.SampleConfig(
              method="major_axis", major_axis=cfgmod.MajorAxisConfig(max_total_points=1500))}
    sv = dict(method=solver, iterations=30)
    if solver == "RANSAC":
        sv["ransac"] = cfgmod.RANSACConfig(max_iterations=500, distance_threshold=0.3,
                                           final_solve_method="DRPM")
    return cfgmod.Config(
        scan_registration=cfgmod.ScanRegistrationConfig(
            compute_normal_method=cfgmod.ComputeNormalConfig(format="pointcloud", method="pca"),
            presample_method=cfgmod.PresampleConfig(method=presample),
            sample_method=sm[sampler]),
        laser_odometry=cfgmod.LaserOdometryConfig(
            matching_method=cfgmod.MatchingConfig(method=match),
            solve_method=cfgmod.SolveConfig(**sv)),
        sensor=cfgmod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZIMUTH_STEPS))


def run_matrix(device, frames: int = 6, threshold: float = 0.15, combos=COMBOS):
    """Each combination on `device`: one JSON line each as it finishes.
    Returns the rows (presample, sampler, match, solver, ate_m, ok, secs,
    iterations)."""
    scans, gt = synthetic.hardened_sequence(frames)
    rows = []
    for presample, sampler, match, solver in combos:
        t0 = time.perf_counter()
        iters = []
        try:
            odo = Odometry(make_config(presample, sampler, match, solver), capacity=CAPACITY,
                           seed=0, device=device)
            iters = [odo.process_scan(s).iterations for s in scans]
            ate = float(evaluate.ate_rmse(odo.poses(), gt, align=False))
        except Exception:  # noqa: BLE001 — the row records it, and the run fails
            ate = float("nan")
            print(f"EXC {presample}/{sampler}/{match}/{solver}:\n{traceback.format_exc()}",
                  flush=True)
        ok = bool(np.isfinite(ate) and ate < threshold)
        row = dict(presample=presample, sampler=sampler, match=match, solver=solver,
                   ate_m=round(ate, 4), ok=ok, secs=round(time.perf_counter() - t0, 1),
                   iterations=iters)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def report(rows, frames: int, threshold: float) -> int:
    """The markdown table and the summary line; returns the failures."""
    print("\n| presample | sampler | matching | solver | ATE (mm) | ok |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['presample']} | {r['sampler']} | {r['match']} | {r['solver']} | "
              f"{r['ate_m'] * 1000:.1f} | {'yes' if r['ok'] else 'NO'} |")
    fail = sum(not r["ok"] for r in rows)
    print(f"\n{len(rows) - fail}/{len(rows)} combos converged (< {threshold} m ATE over "
          f"{frames} frames with 2 cm noise, sweep distortion, 1% outliers)", flush=True)
    return fail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The 36-combination method matrix on the port.")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="per-combo converged = ATE below this (m)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run_matrix(device, args.frames, args.threshold)
    return 0 if report(rows, args.frames, args.threshold) == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
