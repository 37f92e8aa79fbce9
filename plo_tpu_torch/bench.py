"""Throughput of the port on the JAX package's headline benchmark: bench.py's
config and scans, through `Odometry.process_scans` on one CUDA card.

    python -m plo_tpu_torch.bench
    python -m plo_tpu_torch.bench --map {dense,grid_hash}

Prints the card's name and power limit (nvidia-smi's line), then bench.py's
three JSON lines with its metric names and units, the headline last (each
after a line with its windows' rates and the timed frames' ICP iterations):
  * scans_per_sec_device_ceiling — grid16 batches uploaded before the clock
    starts, through the batched step (the port's ICP loop still syncs with
    the host every iteration, so this is not a device-only number);
  * scans_per_sec_1chip_grid16 — grid16 transfer, end to end;
  * scans_per_sec_1chip — int16 transfer, end to end.
vs_baseline is scans/s over the sensor's 10 Hz, as bench.py reports it.
The protocol is bench.py's: warm up on frame 0 and one batch, then the median
of three windows of two batches each, each window closed by a sync (no
fetch). The 113 synthetic HDL-64 x 900 scans are cached in
.bench_scans_v1.npz at the repo root, the file and format bench.py uses.

With --map, the map-mode benchmark of tools/bench_map_mode.py instead: the
headline config with target_mode="map" (a 65,536-point voxel map at 0.3 m,
searched "dense" or through the "grid_hash"), the grid16 transfer, the same
scans and protocol; one line, `map_mode_scans_per_sec_<search>`.
Raises without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
import zipfile

import numpy as np
import torch

from plo_tpu_torch import config as cfgmod
from plo_tpu_torch.models.odometry import Odometry

SCAN_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          ".bench_scans_v1.npz")
CAPACITY, BATCH = 57600, 16          # 64 x 900 grid cells; bench.py's batch
N_WINDOWS, WINDOW = 3, 2 * BATCH     # three timed windows of two batches
N_WARM = 1 + BATCH                   # frame 0 and one batch
N_FRAMES = N_WARM + N_WINDOWS * WINDOW


def headline_config(n_scans: int = 64, azimuth_resolution: float = 0.4) -> cfgmod.Config:
    """bench.py's config (bench.py:117-141): range_image/pca normals, the
    geometric presample, random sampling of 2,000, frozen IMLS, RANSAC-1000
    with the DRPM refit, 30 ICP iterations."""
    return cfgmod.Config(
        scan_registration=cfgmod.ScanRegistrationConfig(
            compute_normal_method=cfgmod.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=cfgmod.PresampleConfig(method="geometric_features"),
            sample_method=cfgmod.SampleConfig(
                method="random", random=cfgmod.RandomSampleConfig(max_points=2000)),
        ),
        laser_odometry=cfgmod.LaserOdometryConfig(
            refresh_correspondences=False,
            matching_method=cfgmod.MatchingConfig(method="IMLS"),
            solve_method=cfgmod.SolveConfig(
                method="RANSAC", iterations=30,
                ransac=cfgmod.RANSACConfig(max_iterations=1000, distance_threshold=0.2,
                                           final_solve_method="DRPM")),
        ),
        sensor=cfgmod.SensorConfig(n_scans=n_scans, azimuth_resolution=azimuth_resolution),
    )


def map_config(search: str, n_scans: int = 64,
               azimuth_resolution: float = 0.4) -> cfgmod.Config:
    """tools/bench_map_mode.py's config: the headline config against a
    persistent world-frame voxel map of 65,536 points at 0.3 m, searched
    `search` ("dense" or "grid_hash")."""
    cfg = headline_config(n_scans, azimuth_resolution)
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        cfg.laser_odometry, target_mode="map",
        map=cfgmod.MapConfig(voxel_size=0.3, capacity=65536, search=search)))


def cached_sequence(n_frames: int = N_FRAMES, path: str = SCAN_CACHE, workers: int = 1):
    """bench.py's scans (bench.py:147-151): the corridor world of seed 7 with
    140 boxes over 120 m, HDL-64 x 900, 0.5 m and 0.005 rad a frame, seed 11;
    read from `path` when it holds n_frames of them, else generated and
    written there."""
    from plo_tpu_torch.io import synthetic

    if os.path.exists(path):
        try:
            data = np.load(path)
            if int(data["n"]) == n_frames:
                return [data[f"s{i}"] for i in range(n_frames)], data["gt"]
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            pass
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=120.0)
    scans, gt = synthetic.synthetic_sequence(n_frames, n_scans=64, azimuth_steps=900,
                                             speed=0.5, yaw_rate=0.005, seed=11, world=world,
                                             workers=workers)
    try:
        np.savez(path, n=n_frames, gt=gt, **{f"s{i}": s for i, s in enumerate(scans)})
    except OSError:
        pass
    return scans, gt


def _iterations(odo, first: int) -> str:
    its = [f.iterations for f in odo.trajectory[first:]]
    return f"ICP iterations over the {len(its)} timed frames: mean {np.mean(its):.2f}, max {max(its)}"


def measure(cfg, scans, transfer: str, device) -> float:
    """Median scans/s over the timed windows (bench.py's _measure)."""
    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device=device, async_mode=True,
                   transfer=transfer)
    odo.process_scans(scans[:N_WARM], batch=BATCH)
    odo.finalize()
    rates = []
    i = N_WARM
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        odo.process_scans(scans[i:i + WINDOW], batch=BATCH)
        odo.sync()
        rates.append(WINDOW / (time.perf_counter() - t0))
        i += WINDOW
    odo.finalize()
    print(f"{transfer}: windows {[round(r, 3) for r in rates]} scans/s; "
          f"{_iterations(odo, N_WARM)}", flush=True)
    return sorted(rates)[N_WINDOWS // 2]


def measure_device_ceiling(cfg, scans, device, n_batches: int = 4) -> float:
    """scans/s of the batched step on grid16 batches packed and copied to the
    device before the clock starts (bench.py's _measure_device_ceiling): the
    first batch warms, the rest are timed."""
    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device=device, async_mode=True,
                   transfer="grid16")
    odo.process_scans(scans[:N_WARM], batch=BATCH)
    odo.finalize()
    ups = [odo._upload_batch(scans[N_WARM + b * BATCH:N_WARM + (b + 1) * BATCH])
           for b in range(n_batches)]
    odo._batch_step(*ups[0], [None] * BATCH)
    odo.sync()
    t0 = time.perf_counter()
    for up in ups[1:]:
        odo._batch_step(*up, [None] * BATCH)
    odo.sync()
    rate = (n_batches - 1) * BATCH / (time.perf_counter() - t0)
    odo.finalize()
    print(f"device ceiling: {_iterations(odo, N_WARM + BATCH)}", flush=True)
    return rate


def _line(metric: str, value: float) -> str:
    return json.dumps({"metric": metric, "value": round(value, 3), "unit": "scans/s",
                       "vs_baseline": round(value / 10.0, 3)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Throughput of plo_tpu_torch on one CUDA card.")
    ap.add_argument("--map", choices=("dense", "grid_hash"), default=None,
                    help="the map-mode benchmark (tools/bench_map_mode.py) with this search")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("plo_tpu_torch.bench: needs a CUDA card")
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else
          f"nvidia-smi failed ({proc.returncode})", flush=True)
    device = torch.device("cuda")
    t0 = time.perf_counter()
    scans, _ = cached_sequence(workers=min(8, os.cpu_count() or 1))
    print(f"scans: {len(scans)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.map is not None:
        rate = measure(map_config(args.map), scans, "grid16", device)
        print(_line(f"map_mode_scans_per_sec_{args.map}", rate), flush=True)
        return
    cfg = headline_config()
    print(_line("scans_per_sec_device_ceiling", measure_device_ceiling(cfg, scans, device)),
          flush=True)
    print(_line("scans_per_sec_1chip_grid16", measure(cfg, scans, "grid16", device)), flush=True)
    print(_line("scans_per_sec_1chip", measure(cfg, scans, "int16", device)), flush=True)


if __name__ == "__main__":
    main()
