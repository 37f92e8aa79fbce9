"""plo_tpu's own ATE on chip_smoke.py's phase 7 and 9 paths (C1-C7, D1-D7):
the same configs (chip_smoke.slice_c_configs and slice_d_configs on
plo_tpu.config), the same 5 corridor frames (HDL-64 x 900; C3 on a VLP-32C
at 0.2 deg; D4 on chip_smoke.make_swept_sequence), capacity 131072 (D1, D2: 57600),
frame by frame through plo_tpu's Odometry with JAX on the CPU.
chip_smoke.py's JAX_ATE_M holds these numbers: where one is below 0.05 m
the port's path on the card must meet the 0.1 m bound.

    JAX_PLATFORMS=cpu python tests/reference_ate.py [C1 C2 ... D1 "D4 off" ...]

    JAX_PLATFORMS=cpu python tests/reference_ate.py --bench-map {dense,grid_hash}

    JAX_PLATFORMS=cpu python tests/reference_ate.py E1 E2 E3 E4 E5

--bench-map runs plo_tpu's map mode as tools/bench_map_mode.py does (its
config, the 113 bench scans, grid16, batch 16) and prints each frame's ICP
iterations and the ATE.

A D4 name with the suffix "@phase3" ("D4@phase3", "D4 off@phase3") runs
phase 3's own frames swept by distort_sequence instead: the motion at which
compensation does not lower plo_tpu's ATE.

E1-E5 are phase 10's paths (windowed BA, loop closure, the planetary
world): each prints the numbers its phase holds the port to (slice_e).

    JAX_PLATFORMS=cpu python tests/reference_ate.py F1 F3

F1 and F3 are phase 11's command lines (chip_smoke.cli_argv) through
plo_tpu's own CLI with --platform cpu: F1 the KITTI-density drill at full
width (its layout written by chip_smoke.kitti_drill), F3 the CLI's
synthetic defaults; each prints the CLI's evaluation line (slice_f).

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
    if any(n.startswith("F") for n in names):
        return slice_f([n for n in names if n.startswith("F")])
    if any(n.startswith("E") for n in names):
        return slice_e([n for n in names if n.startswith("E")])
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


def _run(cfg, scans, capacity, batch=None):
    """plo_tpu's Odometry over the scans, frame by frame (batch None) or
    through process_scans(batch) in async mode; returns the Odometry."""
    if batch is None:
        odo = Odometry(cfg, capacity=capacity, seed=0)
        for s in scans:
            odo.process_scan(s)
    else:
        odo = Odometry(cfg, capacity=capacity, seed=0, async_mode=True)
        odo.process_scans(scans, batch=batch)
        odo.finalize()
    return odo


def _snr_min_prob(cfg, scans):
    """tests/test_planetary.py's min_prob_on: the least DRPM probability of
    a solve on frame 2 matched against frame 1."""
    import jax.numpy as jnp
    from plo_tpu.models.odometry import _build_match_solve, _slice_flat
    from plo_tpu.solvers.drpm import solve_drpm
    r = cfg.laser_odometry.solve_method.ransac
    odo = Odometry(cfg, capacity=chip_smoke.BA_CAPACITY, seed=0)
    fe_prev = odo.frontend.process(scans[0], odo._next_key(), None, first_frame=True)
    fe = odo.frontend.process(scans[1], odo._next_key(), fe_prev.filtered, first_frame=False)
    match, _, prepare_target, _, _ = _build_match_solve(cfg)
    tgt_n, tgt_ok = prepare_target(fe_prev.filtered)
    flat = _slice_flat(cfg, fe.flat)
    res = match(flat, fe_prev.filtered, tgt_n, tgt_ok)
    w = res.valid.astype(jnp.float32)
    w = w / jnp.maximum(w.sum(), 1.0)
    _, _, probs = solve_drpm(flat.xyz, res.y, res.normal, res.valid, w, r.drpm_threshold,
                             r.drpm_stdev_points, r.drpm_stdev_normals)
    return float(np.min(np.asarray(probs)))


def slice_e(names):
    """plo_tpu's numbers for chip_smoke.py's phase 10 (E1-E5) on the same
    configs (chip_smoke.slice_e_configs) and frames (slice_e_sequence; E3
    phase 3's), one JSON line each."""
    from plo_tpu.models import loopclosure
    cfgs = chip_smoke.slice_e_configs(cfgmod, REPO)
    cap = chip_smoke.BA_CAPACITY
    ate = lambda odo, gt: float(evaluate.ate_rmse(odo.poses(), chip_smoke.relative_gt(gt),
                                                   align=False))
    for name in names:
        t0 = time.perf_counter()
        if name == "E3":
            scans, gt = chip_smoke.make_sequence()
        else:
            scans, gt = chip_smoke.slice_e_sequence(name, workers=4)
        if name == "E1":
            out = {f"ate_{k}_m": ate(_run(cfgs[f"E1 {k}"], scans, cap), gt) for k in ("off", "on")}
        elif name == "E2":
            pf, b = _run(cfgs["E2"], scans, cap), _run(cfgs["E2"], scans, cap, chip_smoke.BA_BATCH)
            gap = np.linalg.norm(pf.poses()[:, :3, 3] - b.poses()[:, :3, 3], axis=1)
            out = dict(ate_per_frame_m=ate(pf, gt), ate_batched_m=ate(b, gt),
                       gap_max_m=float(gap.max()))
        elif name == "E3":
            odo = _run(cfgs["E3"], scans, chip_smoke.CAPACITY)
            out = dict(ate_m=ate(odo, gt), iterations=[f.iterations for f in odo.trajectory])
        elif name == "E4":
            odo = _run(cfgs["E4"], scans, chip_smoke.LOOP_CAPACITY, chip_smoke.LOOP_BATCH)
            poses, gtr = odo.poses(), chip_smoke.relative_gt(gt)
            fixed, edges = loopclosure.close_loops(
                cfgs["E4"], scans, poses, min_gap=chip_smoke.LOOP_MIN_GAP,
                radius=chip_smoke.LOOP_RADIUS, capacity=chip_smoke.LOOP_CAPACITY)
            end = lambda p: float(np.linalg.norm(p[-1, :3, 3] - gtr[-1, :3, 3]))
            out = dict(ate_before_m=ate(odo, gt),
                       ate_after_m=float(evaluate.ate_rmse(fixed, gtr, align=False)),
                       end_before_m=end(poses), end_after_m=end(fixed),
                       edges=[(i, j, n) for i, j, _, n in edges])
        elif name == "E5":
            gtr = chip_smoke.relative_gt(gt)
            runs = {k: _run(cfgs[f"E5 {k}"], scans, cap) for k in ("DRPM", "WLS")}
            batched = _run(cfgs["E5 DRPM"], scans, cap, chip_smoke.BA_BATCH)
            min_prob = lambda odo: [min(f.stats[f"drpm_prob_{i}"] for i in range(6))
                                    for f in odo.trajectory]
            corridor, _ = chip_smoke.slice_e_sequence("E5 corridor")
            out = {**{f"ate_{k}_m": ate(o, gt) for k, o in runs.items()},
                   **{f"cross_track_{k}_m": float(np.abs(o.poses()[:, 1, 3] - gtr[:, 1, 3]).max())
                      for k, o in runs.items()},
                   "min_prob_per_frame": min_prob(runs["DRPM"]),
                   "min_prob_batched": min_prob(batched),
                   "snr_min_prob_planetary": _snr_min_prob(cfgs["E5 DRPM"], scans),
                   "snr_min_prob_corridor": _snr_min_prob(cfgs["E5 DRPM"], corridor)}
        else:
            raise ValueError(name)
        print(json.dumps(dict(path=name, **out, seconds=round(time.perf_counter() - t0, 1))),
              flush=True)


def slice_f(names):
    """plo_tpu's CLI on chip_smoke.py's phase 11 command lines (F1, F3),
    in a temporary directory; one JSON line each with the CLI's evaluation."""
    import contextlib
    import io
    import tempfile
    from plo_tpu import cli
    from plo_tpu_torch.io import synthetic
    for name in names:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            if name == "F1":
                chip_smoke.kitti_drill(synthetic, root, workers=4)
            argv = chip_smoke.cli_argv(name, root, os.path.join(root, "out"))
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + ["--platform", "cpu"])
            ev = json.loads([ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1])
            with open(os.path.join(root, "out", "metrics.jsonl")) as f:
                iters = [json.loads(ln)["iterations"] for ln in f]
        print(json.dumps(dict(path=name, rc=rc, **ev, iterations=iters,
                              seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bench-map"]:
        bench_map(sys.argv[2])
    else:
        main(sys.argv[1:])
