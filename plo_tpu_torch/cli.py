"""Command-line odometry runner — the port of plo_tpu/cli.py, which
replaces the reference's roslaunch entry (planetary_slam_VLP_32.launch):
loads a reference-format config.json, streams scans from KITTI or the
synthetic simulator, runs the odometry, and writes the TUM trajectory and
the per-frame metrics. Same flags, defaults, outputs and stdout lines.

It runs on the CUDA card; `--platform cpu` runs it on the CPU. Without
`--platform` on a host with no card it fails before it writes anything.

Usage:
    python -m plo_tpu_torch.cli --dataset synthetic --frames 20 --output out/
    python -m plo_tpu_torch.cli --config config.json --dataset kitti \\
        --kitti-root /data/kitti --seq 00 --output out/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="LiDAR odometry on a CUDA card (PyTorch port)")
    p.add_argument("--config", default=None, help="reference-format config.json")
    p.add_argument("--dataset", choices=["kitti", "synthetic"], default="synthetic")
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--seq", default="00")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--output", default=None, help="output dir (TUM poses, metrics JSONL)")
    p.add_argument("--capacity", type=int, default=131072)
    p.add_argument("--scan-lines", type=int, default=64, help="N_SCANS (16/32/64)")
    p.add_argument("--min-range", type=float, default=2.0)
    p.add_argument("--max-range", type=float, default=150.0)
    p.add_argument("--azimuth-resolution", type=float, default=0.2)
    p.add_argument("--azimuth-steps", type=int, default=1800,
                   help="synthetic dataset: firings per revolution")
    p.add_argument("--platform", default=None,
                   help="torch device to run on (e.g. cpu); default: the CUDA card")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-gt", action="store_true",
                   help="evaluate ATE/RPE when ground truth is available")
    p.add_argument("--save-artifacts", action="store_true",
                   help="per-frame cloud/marker dumps in the reference's text "
                        "formats (saver.cpp) — slow, off by default")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save odometry state to <output>/ckpt.npz every N "
                        "frames (resume with --resume)")
    p.add_argument("--resume", default=None, help="checkpoint to restore before running")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per device step (the batched driver; >1 "
                        "requires max_queue_size==1)")
    p.add_argument("--close-loops", action="store_true",
                   help="post-run loop closure: revisit detection + keyframe "
                        "re-registration + pose-graph relax "
                        "(models/loopclosure.py)")
    p.add_argument("--target-mode", choices=["window", "map"], default=None,
                   help="override the target model: reference window or "
                        "persistent voxel map (frame-to-map)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch import resolve_device
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.utils import MetricsLog, TicToc, checkpoint, evaluate, saver

    device = resolve_device(args.platform)
    sensor = cfgmod.SensorConfig(
        n_scans=args.scan_lines, azimuth_resolution=args.azimuth_resolution,
        minimum_range=args.min_range, maximum_range=args.max_range)
    cfg = cfgmod.load(args.config, sensor=sensor) if args.config else cfgmod.Config(sensor=sensor)
    if args.target_mode:
        cfg = dataclasses.replace(cfg, laser_odometry=dataclasses.replace(
            cfg.laser_odometry, target_mode=args.target_mode))
    if args.save_artifacts and args.output:
        # Artifact mode also dumps the matched pairs and the pose of every
        # ICP iteration (laser_odometry.cpp:621-625).
        cfg = dataclasses.replace(cfg, saver=cfgmod.SaverConfig(
            output_dir=args.output, enabled=True))

    gt = None
    if args.dataset == "kitti":
        from plo_tpu_torch.io import kitti
        if not args.kitti_root:
            raise SystemExit("--kitti-root required for the kitti dataset")
        scans = (s for _, s in kitti.kitti_scan_iterator(
            args.kitti_root, args.seq, start=args.start, count=args.frames,
            capacity=args.capacity))
        pose_file = os.path.join(args.kitti_root, "poses", f"{args.seq}.txt")
        if os.path.exists(pose_file):
            gt = kitti.read_poses(pose_file)
            calib = os.path.join(args.kitti_root, "sequences", args.seq, "calib.txt")
            if os.path.exists(calib):
                # KITTI's ground truth is in the cam0 frame; the odometry
                # runs in the velodyne frame.
                gt = kitti.poses_to_velodyne_frame(gt, kitti.read_calib_tr(calib))
    else:
        from plo_tpu_torch.io import synthetic
        scan_list, gt = synthetic.synthetic_sequence(
            args.frames or 20, n_scans=args.scan_lines, azimuth_steps=args.azimuth_steps,
            speed=1.0, yaw_rate=0.005, seed=args.seed)
        scans = iter(scan_list)

    outdir = args.output
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    metrics = MetricsLog(os.path.join(outdir, "metrics.jsonl") if outdir else None)
    times_file = os.path.join(outdir, "odometry_times.txt") if outdir else None

    odo = Odometry(cfg, capacity=args.capacity, seed=args.seed, device=device,
                   async_mode=args.batch > 1)
    if args.resume:
        checkpoint.load(odo, args.resume)
        print(f"resumed at frame {odo.frame_count}")
    tic = TicToc()
    if args.close_loops:
        # Loop closure re-reads the revisit keyframes' scans after the run;
        # KITTI's scans arrive as a generator.
        scans = list(scans)
    if args.batch > 1:
        odo.process_scans(list(scans), batch=args.batch)
        odo.finalize()
        total_ms = tic.toc()
        for frame in odo.trajectory:
            metrics.log({"frame": frame.index, "iterations": frame.iterations,
                         "correspondences": frame.n_correspondences, **frame.stats})
        print(f"{len(odo.trajectory)} frames in {total_ms:.0f} ms "
              f"({len(odo.trajectory) / max(total_ms, 1e-9) * 1000:.1f} scans/s)")
    else:
        for i, scan in enumerate(scans):
            tic.tic()
            # process_scan fetches the frame's pose, which waits for the
            # device: the time is the frame's whole time.
            frame = odo.process_scan(scan)
            ms = tic.toc()
            if times_file:
                with open(times_file, "a") as f:
                    f.write(f"Frame {i}: {ms:.3f} ms\n")
            metrics.log({"frame": i, "ms": ms, "iterations": frame.iterations,
                         "correspondences": frame.n_correspondences, **frame.stats})
            if args.save_artifacts and outdir:
                ts = f"{i:06d}"
                saver.save_point_cloud_txt(
                    odo.last_filtered, os.path.join(outdir, "pcl_cloud", ts + ".txt"))
                saver.save_normal_markers_obj(
                    odo.last_filtered, os.path.join(outdir, "pca_markers", ts + ".obj"))
                saver.save_pose_tum(
                    frame.pose, os.path.join(outdir, "imls_results.txt"),
                    f"{i * cfg.sensor.scan_period:.6f}")
            print(f"frame {i}: {ms:7.1f} ms  iters={frame.iterations:2d} "
                  f"corr={frame.n_correspondences}")
            if args.checkpoint_every and outdir and (i + 1) % args.checkpoint_every == 0:
                checkpoint.save(odo, os.path.join(outdir, "ckpt.npz"))

    poses = odo.poses()
    if args.close_loops:
        from plo_tpu_torch.models.loopclosure import close_loops
        corrected, loop_edges = close_loops(cfg, scans, poses, capacity=args.capacity,
                                            device=device)
        print(f"loop closure: {len(loop_edges)} edge(s) "
              f"{[(i, j) for i, j, _, _ in loop_edges]}")
        if loop_edges:
            poses = corrected
    if outdir:
        evaluate.save_tum(poses, [f.index * cfg.sensor.scan_period for f in odo.trajectory],
                          os.path.join(outdir, "trajectory_tum.txt"))

    if args.eval_gt and gt is not None:
        n = len(poses)
        s = args.start if args.dataset == "kitti" else 0
        gtw = gt[s : s + n]
        gtr = np.einsum("ij,njk->nik", np.linalg.inv(gtw[0]), gtw)
        ate = evaluate.ate_rmse(poses, gtr, align=False)
        terr, rerr = evaluate.rpe(poses, gtr)
        t_drift, r_drift, per_len = evaluate.kitti_odometry_errors(poses, gtr)
        rec = {"ate_m": ate, "rpe_trans_m": terr, "rpe_rot_rad": rerr}
        if per_len:
            rec["kitti_t_drift_pct"] = round(t_drift * 100, 4)
            rec["kitti_r_drift_deg_per_100m"] = round(float(np.degrees(r_drift)) * 100, 4)
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
