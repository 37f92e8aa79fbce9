#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its results; any failure exits non-zero with a
traceback, and a watchdog turns a hang into the same:
  0. require a CUDA card; print nvidia-smi's name and power limit;
  1. build the kernels from plo_tpu_torch/csrc with the one nvcc call and
     print the build time and ptxas's register / shared-memory lines;
  2. each kernel against its plain PyTorch version on the card, at its
     path's shapes (cylinder_stats with and without t_live, fps_ranks;
     nearest and projected_argmin at plane-ICP's 2,000 queries against a
     131,072-slot target, plus an all-invalid target and duplicated
     targets), timed with CUDA events (median of 15 runs after a warm-up);
  3-5. three paths, each 5 synthetic HDL-64 x 900 frames (one corridor
     sequence) through Odometry.process_scan at capacity 131072, with every
     launch count set to 0 just before the path and read just after:
     3. the default config (motion_prior=False, the reference-format
        setting): cylinder_stats and fps_ranks must launch on frames 2-5;
     4. B1, configs/aloam_kitti00.json as shipped (plane-ICP, euclidean):
        nearest must launch once per ICP iteration of frames 2-5;
     5. B2, the same with plane_ICP.use_projected_distance enabled:
        projected_argmin must launch once per ICP iteration;
     on each, every pose must be finite and the ATE against the ground truth
     below 0.1 m (the bound of tests/test_odometry.py).
The second-to-last line is the kernels' JSON record; the last line, printed
only when every phase passed, is {"ok": true, "device": {...}}.

Imports torch, numpy and plo_tpu_torch only (never JAX or plo_tpu); writes
nothing but the kernel build under plo_tpu_torch/_build/.
"""
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time

WATCHDOG_S = 1080
N_FRAMES = 5
N_SCANS, AZIMUTH_STEPS = 64, 900   # HDL-64 x 900
CAPACITY = 131072                  # Odometry's default point capacity
QUERIES = 12800                    # cylinder_stats queries: 64 bins x 200
ICP_QUERIES = 2000                 # plane-ICP source: random.max_points of aloam_kitti00
LIVE = 57600                       # valid filtered points of an HDL-64 x 900 scan
ALOAM = "configs/aloam_kitti00.json"
PICP_R, PICP_R_PROJ = 1.5, 0.8     # aloam_kitti00's plane_ICP r and r_proj
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, H100 SXM data sheet
CYL_OPS_PER_PAIR = 22        # 3 sub, 3+3+2 mul, 2+2+1 add/sub, 2 compares, sqrt, add, count
FPS_OPS_PER_SLOT_STEP = 12   # 3 sub, 3 mul, 2 add, min, compare, argmax compare + select
NEAREST_OPS_PER_PAIR = 9     # 3 sub, 3 mul, 2 add, compare
PROJ_OPS_PER_PAIR = 9        # d2 and its gate: 3 sub, 3 mul, 2 add, compare
PROJ_OPS_PER_GATED_PAIR = 17  # where d2 passes: cross 6 mul 3 sub, p2 3 mul 2 add, 2 compares, select
ATE_BOUND_M = 0.1


def cuda_ms(fn, reps=15):
    """Median milliseconds of fn() over `reps` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    card = proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else ""
    if not card:
        raise RuntimeError(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    print(card, flush=True)  # nvidia-smi's own line: name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from plo_tpu_torch.ops import cuda_nn
    seconds, log = cuda_nn.build()
    print(f"build: {seconds:.2f} s, one nvcc call -> {os.path.relpath(cuda_nn.LIBRARY)}", flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)
    cuda_nn.library()


def phase_kernels(dev):
    """Each kernel against its plain version on the main path's shapes.
    Returns the per-kernel records (launches are filled in after phase 3)."""
    import torch
    from plo_tpu_torch.ops import cuda_nn

    g = torch.Generator(device=dev).manual_seed(1)
    records = []

    # cylinder_stats: 12,800 queries (64 bins x 200) against a 131,072-slot
    # filtered cloud whose 57,600 valid points (HDL-64 x 900) form the prefix
    # — a ground plane with some relief, queries among the points.
    q_n, t_n, live = QUERIES, CAPACITY, LIVE
    tgt = torch.zeros((t_n, 3), device=dev)
    tgt[:live, :2] = torch.rand((live, 2), generator=g, device=dev) * 60.0 - 30.0
    tgt[:live, 2] = -1.7 + 0.3 * torch.sin(tgt[:live, 0] / 3.0) + 0.02 * torch.randn(
        live, generator=g, device=dev)
    valid = torch.arange(t_n, device=dev) < live
    pick = torch.randint(0, live, (q_n,), generator=g, device=dev)
    query = (tgt[pick] + 0.05 * torch.randn((q_n, 3), generator=g, device=dev)).contiguous()
    normal = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, 1.0], device=dev) + 0.2 * torch.randn((q_n, 3), generator=g, device=dev),
        dim=1).contiguous()
    t_live = torch.tensor(live, dtype=torch.int32, device=dev)
    c_ref, s_ref = cuda_nn.cylinder_stats_plain(query, normal, tgt, valid, 1.5, 0.5)
    err = 0.0
    for tl in (t_live, None):
        c, s = cuda_nn.cylinder_stats(query, normal, tgt, valid, 1.5, 0.5, t_live=tl)
        torch.cuda.synchronize()
        if not torch.equal(c, c_ref):
            raise AssertionError(f"cylinder_stats counts differ (t_live={tl is not None}): "
                                 f"{int((c != c_ref).sum())} of {q_n}")
        # dist_sum: f32 sums in another order (8 target slices vs 512-wide
        # chunks) — rtol 2e-5 / atol 1e-4, as tests/test_pallas_nn.py.
        torch.testing.assert_close(s, s_ref, rtol=2e-5, atol=1e-4)
        err = max(err, float((s - s_ref).abs().max()))
    ms = cuda_ms(lambda: cuda_nn.cylinder_stats(query, normal, tgt, valid, 1.5, 0.5, t_live=t_live))
    ms_full = cuda_ms(lambda: cuda_nn.cylinder_stats(query, normal, tgt, valid, 1.5, 0.5))
    plain_ms = cuda_ms(lambda: cuda_nn.cylinder_stats_plain(query, normal, tgt, valid, 1.5, 0.5))
    n_valid = int(valid.sum())
    ops = q_n * n_valid * CYL_OPS_PER_PAIR
    nbytes = q_n * 3 * 4 * 2 + t_n * 3 * 4 + t_n + q_n * 8
    print(f"cylinder_stats: Q={q_n} T={t_n} valid={n_valid}: counts equal "
          f"(mean {float(c_ref.float().mean()):.2f} neighbors), max |dist_sum err| {err:.3g}; "
          f"kernel {ms:.4f} ms (t_live) / {ms_full:.4f} ms (full T), plain {plain_ms:.3f} ms",
          flush=True)
    records.append(dict(name="cylinder_stats", route="cuda",
                        source="plo_tpu_torch/csrc/cylinder_stats.cu",
                        replaces="plo_tpu/ops/pallas_nn.py:238", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, **_bound(ops, nbytes), library_ms=None))

    # fps_ranks: 64 bins x 1024 slots, 200 steps; bins filled unevenly (an
    # empty one, full ones) as the major-axis histogram fills them.
    b, c, steps = 64, 1024, 200
    table_xyz = (torch.rand((b, c, 3), generator=g, device=dev) * 40.0 - 20.0).contiguous()
    fill = torch.randint(0, c + 1, (b, 1), generator=g, device=dev)
    fill[0], fill[1] = 0, c
    table_occ = (torch.arange(c, device=dev)[None, :] < fill).to(torch.float32).contiguous()
    steps_t = torch.tensor(steps, dtype=torch.int32, device=dev)
    r = cuda_nn.fps_ranks(table_xyz, table_occ, steps_t, 200)
    r_ref = cuda_nn.fps_ranks_plain(table_xyz, table_occ, steps_t, 200)
    torch.cuda.synchronize()
    if not torch.equal(r, r_ref):
        raise AssertionError(f"fps_ranks differ in {int((r != r_ref).sum())} slots")
    ms = cuda_ms(lambda: cuda_nn.fps_ranks(table_xyz, table_occ, steps_t, 200))
    plain_ms = cuda_ms(lambda: cuda_nn.fps_ranks_plain(table_xyz, table_occ, steps_t, 200), reps=10)
    occupied = int(table_occ.sum())
    ops = occupied * (steps - 1) * FPS_OPS_PER_SLOT_STEP
    nbytes = b * c * (3 * 4 + 4) + b * c * 4
    print(f"fps_ranks: B={b} C={c} steps={steps} occupied={occupied}: ranks equal "
          f"({int((r < 200).sum())} ranked); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms", flush=True)
    records.append(dict(name="fps_ranks", route="cuda", source="plo_tpu_torch/csrc/fps_ranks.cu",
                        replaces="plo_tpu/ops/pallas_nn.py:344", max_abs_err=0.0, ms=ms,
                        plain_ms=plain_ms, **_bound(ops, nbytes), library_ms=None))
    return records + phase_anchor_kernels(dev, g)


def _anchor_inputs(dev, g):
    """Plane-ICP's shapes: 2,000 queries among a 131,072-slot target whose
    57,600 valid points (HDL-64 x 900) form the prefix — a ground plane with
    relief and walls, so that normals point several ways. The last 4,000
    valid points repeat the first 4,000 (exact ties), and 200 queries sit
    on repeated points (d2 = 0 ties)."""
    import torch
    t_n, live, q_n = CAPACITY, LIVE, ICP_QUERIES
    tgt = torch.zeros((t_n, 3), device=dev)
    tgt[:live, :2] = torch.rand((live, 2), generator=g, device=dev) * 60.0 - 30.0
    tgt[:live, 2] = -1.7 + 0.3 * torch.sin(tgt[:live, 0] / 3.0) + 0.02 * torch.randn(
        live, generator=g, device=dev)
    wall = torch.rand(live, generator=g, device=dev) < 0.3
    tgt[:live, 1] = torch.where(wall, torch.sign(tgt[:live, 1]) * 8.0, tgt[:live, 1])
    tgt[:live, 2] = torch.where(wall, tgt[:live, 2] + 4.0 * torch.rand(live, generator=g, device=dev),
                                tgt[:live, 2])
    tgt[live - 4000:live] = tgt[:4000]
    valid = torch.arange(t_n, device=dev) < live
    pick = torch.randint(0, live, (q_n,), generator=g, device=dev)
    query = tgt[pick] + 0.2 * torch.randn((q_n, 3), generator=g, device=dev)
    query[:200] = tgt[torch.randint(0, 4000, (200,), generator=g, device=dev)]
    normal = torch.nn.functional.normalize(torch.randn((q_n, 3), generator=g, device=dev), dim=1)
    return query.contiguous(), normal.contiguous(), tgt, valid


def phase_anchor_kernels(dev, g):
    """nearest and projected_argmin against their plain versions: idx and
    valid exactly, d2 and proj bit-equal, on plane-ICP's shapes, an
    all-invalid target and a 12-point target of duplicates."""
    import torch
    from plo_tpu_torch.ops import cuda_nn

    query, normal, tgt, valid = _anchor_inputs(dev, g)
    q_n, t_n = query.shape[0], tgt.shape[0]
    eg = float(PICP_R * PICP_R)
    none_valid = torch.zeros_like(valid)
    dup = tgt[:4].repeat(3, 1).contiguous()   # ties across the whole target
    cases = [("main", tgt, valid), ("all-invalid", tgt, none_valid),
             ("duplicates", dup, torch.ones(12, dtype=torch.bool, device=dev))]
    kernels = [
        ("nearest", lambda t, v: cuda_nn.nearest(query, t, v, PICP_R),
         lambda t, v: cuda_nn.nearest_plain(query, t, v, PICP_R)),
        ("projected_argmin", lambda t, v: cuda_nn.projected_argmin(query, normal, t, v, eg, PICP_R_PROJ),
         lambda t, v: cuda_nn.projected_argmin_plain(query, normal, t, v, eg, PICP_R_PROJ)),
    ]
    n_valid = int(valid.sum())
    # Pairs that pass projected_argmin's d2 gate: only they need the cross product.
    eg2 = cuda_nn.f32_square(eg)
    gated = sum(int((((query[:, None, :] - tgt[None, s:s + 8192]) ** 2).sum(-1) < eg2)
                    [:, valid[s:s + 8192]].sum()) for s in range(0, n_valid, 8192))
    nbytes_in = q_n * 12 + t_n * 12 + t_n
    records = []
    for name, kern, plain in kernels:
        for case, t, v in cases:
            out, ref = kern(t, v), plain(t, v)
            torch.cuda.synchronize()
            for a, b, what in zip(out, ref, ("distance", "idx", "valid")):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} ({case}): {what} differs from the plain version "
                                         f"in {int((a != b).sum())} of {q_n}")
            if case == "all-invalid" and not bool((out[1] == -1).all()):
                raise AssertionError(f"{name}: an all-invalid target gave an index")
            if case == "duplicates" and not bool((out[1] < 4).all()):
                raise AssertionError(f"{name}: a tie did not go to the lowest index")
            if case == "main":
                found = int(out[2].sum())
        ms = cuda_ms(lambda: kern(tgt, valid))
        plain_ms = cuda_ms(lambda: plain(tgt, valid))
        if name == "nearest":
            ops = q_n * n_valid * NEAREST_OPS_PER_PAIR
            nbytes = nbytes_in + q_n * 9
        else:
            ops = q_n * n_valid * PROJ_OPS_PER_PAIR + gated * PROJ_OPS_PER_GATED_PAIR
            nbytes = nbytes_in + q_n * 12 + q_n * 9
        print(f"{name}: Q={q_n} T={t_n} valid={n_valid}: equal to the plain version bit for bit "
              f"(main: {found} found; all-invalid: none; duplicates: lowest index); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms", flush=True)
        records.append(dict(name=name, route="cuda", source=f"plo_tpu_torch/csrc/{name}.cu",
                            replaces="plo_tpu/ops/pallas_nn.py:" + ("117" if name == "nearest" else "148"),
                            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, **_bound(ops, nbytes),
                            library_ms=None))
    print(f"projected_argmin: {gated} of {q_n * n_valid} valid pairs pass the d2 gate", flush=True)
    return records


def _bound(ops, nbytes):
    """The least time the card could take: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations")


def make_sequence():
    """5 HDL-64 x 900 frames of a structure-rich world: the identity-init
    reference regime needs walls around the ground plane to pin x/y (as
    tests/test_odometry.py's RANSAC/DRPM test)."""
    from plo_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS, azimuth_steps=AZIMUTH_STEPS,
                                             speed=0.5, yaw_rate=0.01, seed=3, world=world)
    print(f"sequence: {N_FRAMES} scans of {[len(s) for s in scans]} points "
          f"generated in {time.perf_counter() - t0:.1f} s", flush=True)
    return scans, gt


def configs():
    """The three paths' configs: default (motion_prior=False), B1, B2."""
    from plo_tpu_torch.utils.profile_frames import build_config
    aloam = os.path.join(os.path.dirname(os.path.abspath(__file__)), ALOAM)
    return (build_config(None, False, N_SCANS, AZIMUTH_STEPS),
            build_config(aloam, False, N_SCANS, AZIMUTH_STEPS),
            build_config(aloam, True, N_SCANS, AZIMUTH_STEPS))


def phase_path(dev, name, cfg, scans, gt, expect):
    """One path: the frames through the port's Odometry, with every launch
    count set to 0 just before and read just after; `expect(icp_iterations)`
    gives the launch counts the path must show (icp_iterations: the sum over
    frames 2-5). Returns the launch counts."""
    import numpy as np
    import torch
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.utils import evaluate

    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device=dev)
    torch.cuda.synchronize()
    cuda_nn.reset_launches()
    wall = time.perf_counter()
    iters = []
    for s in scans:
        t = time.perf_counter()
        f = odo.process_scan(s)
        torch.cuda.synchronize()
        iters.append(f.iterations)
        print(f"  {name} frame {f.index}: {1e3 * (time.perf_counter() - t):.1f} ms, "
              f"{f.iterations} ICP iterations, {f.n_correspondences} correspondences, "
              f"{int(f.stats['n_sampled'])} sampled", flush=True)
    wall = time.perf_counter() - wall
    launches = dict(cuda_nn.LAUNCHES)
    est = odo.poses()
    if not np.isfinite(est).all():
        raise AssertionError(f"{name}: non-finite pose")
    ate = evaluate.ate_rmse(est, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt), align=False)
    print(f"{name}: {wall:.2f} s for {N_FRAMES} frames, ATE {ate:.4f} m, "
          f"ICP iterations {iters}, launches {launches}", flush=True)
    if launches != expect(sum(iters[1:])):
        raise AssertionError(f"{name}: launches {launches}, expected {expect(sum(iters[1:]))}")
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"{name}: ATE {ate} m >= {ATE_BOUND_M} m")
    return launches


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    phase_card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    phase_build()
    dev = torch.device("cuda")
    records = phase_kernels(dev)
    scans, gt = make_sequence()
    default, b1, b2 = configs()
    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    frames = N_FRAMES - 1  # frames 2-5 run ICP and major-axis sampling
    by_path = {
        "default": phase_path(dev, "default", default, scans, gt,
                              lambda it: {**zero, "cylinder_stats": frames, "fps_ranks": frames}),
        "B1": phase_path(dev, "B1", b1, scans, gt, lambda it: {**zero, "nearest": it}),
        "B2": phase_path(dev, "B2", b2, scans, gt, lambda it: {**zero, "projected_argmin": it}),
    }
    main_path = {"nearest": "B1", "projected_argmin": "B2",
                 "cylinder_stats": "default", "fps_ranks": "default"}
    for rec in records:
        rec["launches"] = by_path[main_path[rec["name"]]][rec["name"]]
        rec["launches_by_path"] = {p: c[rec["name"]] for p, c in by_path.items()}
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
