"""One process of a multi-process sharded map odometry run (the port of
tools/mp_worker.py):

    python -m plo_tpu_torch.parallel.worker --process-id P --num-processes N \\
        --port PORT [--local-devices 4] [--frames 8] [--batched] \\
        [--device cpu] [--out poses.npy]

Every process joins the group at localhost:PORT (parallel/distributed.py),
drives its --local-devices shards of the global mesh through
ShardedMapOdometry on the same synthetic scans (the replicated front-end,
the map sharded over all processes' shards) and computes the same
trajectory; process 0 writes the poses to --out. Without --device, process
P drives card P mod the visible count over NCCL; with --device cpu, gloo.
tests/test_torch_distributed.py runs 2 processes x 4 CPU shards.
"""
from __future__ import annotations

import argparse

import numpy as np

from plo_tpu_torch import config as cfgmod


def dist_config() -> cfgmod.Config:
    """tests/test_distributed.py::_dist_config (tools/mp_worker.py's)."""
    return cfgmod.Config(
        scan_registration=cfgmod.ScanRegistrationConfig(
            sample_method=cfgmod.SampleConfig(
                method="random", random=cfgmod.RandomSampleConfig(max_points=1024))),
        laser_odometry=cfgmod.LaserOdometryConfig(
            target_mode="map", map=cfgmod.MapConfig(voxel_size=0.3, capacity=16384),
            matching_method=cfgmod.MatchingConfig(method="IMLS"),
            solve_method=cfgmod.SolveConfig(
                method="RANSAC", iterations=30,
                ransac=cfgmod.RANSACConfig(max_iterations=200, distance_threshold=0.2,
                                           final_solve_method="DRPM")),
            refresh_correspondences=False),
        sensor=cfgmod.SensorConfig(n_scans=32, azimuth_resolution=0.8))


def dist_scans(frames: int):
    """tools/mp_worker.py's scans: the corridor world of seed 7 at 32 x 450."""
    from plo_tpu_torch.io import synthetic
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    return synthetic.synthetic_sequence(frames, n_scans=32, azimuth_steps=450, speed=0.5,
                                        yaw_rate=0.01, seed=3, world=world)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4, help="shards of this process")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batched", action="store_true",
                    help="drive the frames through process_scans (batches) instead of "
                         "one process_scan call a frame")
    ap.add_argument("--device", default=None,
                    help="the shards' device (default: card P mod the visible count)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from plo_tpu_torch.parallel import distributed
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry

    nproc, pid = distributed.initialize(f"localhost:{args.port}", args.num_processes,
                                        args.process_id, local_shards=args.local_devices,
                                        device=args.device)
    try:
        mesh = distributed.global_mesh()
        assert nproc == args.num_processes and mesh.size == nproc * args.local_devices
        scans, _ = dist_scans(args.frames)
        sodo = ShardedMapOdometry(dist_config(), mesh, capacity=8192, seed=0,
                                  defer_fetch=True)
        if args.batched:
            sodo.process_scans(scans, batch=max(2, (args.frames - 1) // 2))
        else:
            for s in scans:
                sodo.process_scan(s)
        poses = sodo.poses()
        print(f"[proc {pid}] {len(poses)} frames on {mesh.size} shards "
              f"({mesh.devices[0]}), final t={poses[-1][:3, 3]}", flush=True)
        if args.out and pid == 0:
            np.save(args.out, poses)
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
