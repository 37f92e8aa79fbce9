"""Where a frame's time goes on the card: per-frame wall time, the front-end's
share of it, and the device's busy share and top kernels from a
torch.profiler trace of the steady frames.

    python -m plo_tpu_torch.utils.profile_frames [--config PATH] [--projected]
        [--headline] [--out DIR]

Runs the corridor sequence of chip_smoke.py (HDL-64 x 900, capacity 131072)
through Odometry.process_scan on the CUDA card twice: once untraced (the
per-frame wall times), then on a fresh Odometry with frames 1-2 as warm-up
and frames 3-5 traced (the profiler's own overhead inflates those). Without --config it runs the default Config() with
motion_prior=False; --projected enables plane_ICP.use_projected_distance.
--headline runs bench.py's config (plo_tpu_torch.bench) at capacity 57600,
each frame after the first as a one-frame batched step (process_scans)
with the int16 transfer, and also times the grid-stencil PCA
alone on the last frame's raster (CUDA events, median of 10) and counts its
device launches.
Prints a summary and writes it, with the top device kernels, to
--out/profile_<name>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from plo_tpu_torch import bench, config as cfgmod
from plo_tpu_torch.io import synthetic
from plo_tpu_torch.models.odometry import Odometry
from plo_tpu_torch.ops import normals, preprocess

N_FRAMES, N_SCANS, AZIMUTH_STEPS, CAPACITY = 5, 64, 900, 131072   # HDL-64 x 900


def build_config(path, projected: bool, n_scans: int = N_SCANS,
                 azimuth_steps: int = AZIMUTH_STEPS) -> cfgmod.Config:
    """The default Config() with motion_prior=False (path None), or the
    config file at `path` as `config.load` reads it, optionally with
    plane_ICP.use_projected_distance enabled."""
    sensor = cfgmod.SensorConfig(n_scans=n_scans, azimuth_resolution=360.0 / azimuth_steps)
    if path is None:
        return cfgmod.Config(laser_odometry=cfgmod.LaserOdometryConfig(motion_prior=False),
                             sensor=sensor)
    cfg = cfgmod.load(path, sensor=sensor)
    if not projected:
        return cfg
    lo = cfg.laser_odometry
    mm = lo.matching_method
    picp = dataclasses.replace(mm.plane_icp, use_projected_distance=dataclasses.replace(
        mm.plane_icp.use_projected_distance, enabled=True))
    return dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
        lo, matching_method=dataclasses.replace(mm, plane_icp=picp)))


def _busy_us(events) -> float:
    """Length of the union of the device-side intervals (microseconds)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _grid_pca(odo, scan, acts) -> dict:
    """The grid-stencil PCA alone on one frame's raster: device ms (CUDA
    events around one call, median of 10) and its device launches."""
    cfg = odo.cfg.scan_registration
    fe = odo.frontend
    pts = np.zeros((fe.capacity, 4), np.float32)
    pts[:len(scan)] = scan[:fe.capacity]
    rc = preprocess.preprocess(torch.from_numpy(pts).to(odo.device), min(len(scan), fe.capacity),
                               odo.cfg.sensor, sort=False)
    _, xyzg, _, occ, _ = preprocess.rasterize_range_image(rc, fe.height, fe.width)
    call = lambda: normals.compute_normals_pca_grid(xyzg, occ, cfg.compute_normal_method.pca,
                                                    cfg.use_all_points)
    call()
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    return dict(grid_pca_ms=float(np.median(times)), grid_pca_launches=launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--projected", action="store_true")
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--out", default="out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames: needs a CUDA card")
    name = ("headline" if args.headline else "default" if args.config is None else
            os.path.splitext(os.path.basename(args.config))[0]
            + ("-projected" if args.projected else ""))
    dev = torch.device("cuda")
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, _ = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS,
                                            azimuth_steps=AZIMUTH_STEPS, speed=0.5,
                                            yaw_rate=0.01, seed=3, world=world)
    if args.headline:
        cfg, capacity = bench.headline_config(N_SCANS, 360.0 / AZIMUTH_STEPS), bench.CAPACITY
    else:
        cfg, capacity = build_config(args.config, args.projected), CAPACITY

    def frame(odo, s):
        t = time.perf_counter()
        if args.headline:
            odo.process_scans([s], batch=1)
        else:
            odo.process_scan(s)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t), odo.trajectory[-1].iterations

    odo = Odometry(cfg, capacity=capacity, seed=0, device=dev)
    untraced = [frame(odo, s) for s in scans]
    odo = Odometry(cfg, capacity=capacity, seed=0, device=dev)
    for s in scans[:2]:
        frame(odo, s)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        traced = [frame(odo, s) for s in scans[2:]]
        wall_us = 1e6 * (time.perf_counter() - t0)
    # The front-end alone on the same scans (same work as inside process_scan).
    fe_ms = []
    for s in scans[2:]:
        t = time.perf_counter()
        odo.frontend.process(s, odo.draws.frontend(odo.frontend.n_draws(False),
                                                   odo.frontend.filtered_capacity),
                             odo.last_filtered, first_frame=False)
        torch.cuda.synchronize()
        fe_ms.append(1e3 * (time.perf_counter() - t))

    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us(dev_events)
    by_name = {}
    for e in dev_events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]
    summary = dict(
        path=name, device=torch.cuda.get_device_name(0),
        frames_ms=[u[0] for u in untraced], iterations=[u[1] for u in untraced],
        traced_frames_ms=[t[0] for t in traced], frontend_ms=fe_ms,
        traced_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us, kernel_launches=len(dev_events),
        top_kernels=[dict(name=k[:200], launches=n, ms=t / 1e3) for k, (n, t) in top])
    if odo.frontend.format == "range_image":
        summary.update(_grid_pca(odo, scans[-1], acts))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{name}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels"}))
    for k in summary["top_kernels"][:10]:
        print(f"  {k['ms']:9.3f} ms {k['launches']:6d} x  {k['name']}")


if __name__ == "__main__":
    main()
