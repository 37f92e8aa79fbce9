#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plo_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--baseline DIR]

Phases, each printing its results; any failure exits non-zero with a
traceback, and a watchdog turns a hang into the same:
  0. require a CUDA card; print nvidia-smi's name and power limit;
  1. build the kernels from plo_tpu_torch/csrc with the one nvcc call and
     print the build time and ptxas's register / shared-memory lines;
  2. each kernel against its plain PyTorch version on the card, at its
     path's shapes (cylinder_stats with and without t_live; fps_ranks, also
     on a table of duplicated points; nearest and projected_argmin at
     plane-ICP's 2,000 queries against a 131,072-slot target, plus an
     all-invalid target, duplicated targets and an unaligned view of the
     target). Each kernel is timed three ways: `ms`, device time from one
     pair of CUDA events around up to 50 back-to-back calls queued behind a
     spin kernel (median of 7 runs); `call_ms`, one call between events
     with the device idle before it, so the wrapper's host prelude counts;
     `profiler_ms`, the kernels' own device time in a torch.profiler trace;
  2b. knn on the card against knn on the CPU at the default path's IMLS
     search, with exact ties inside and across chunks;
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
     below 0.1 m (the bound of tests/test_odometry.py);
  6. the headline path: bench.py's config (range_image/pca normals, random
     sampling, frozen IMLS, RANSAC/DRPM) at capacity 57600 on the same
     frames through Odometry.process_scans(batch=4) (frame 0 alone, frames
     2-5 as one batch), for the int16 and the grid16 transfer: every pose
     finite, ATE below 0.1 m, and no launch of any of the four kernels (the
     path reaches none, so a launch is a silent reroute); then float32
     process_scans bit-identical to a process_scan loop on the card;
  7. slice C's paths, 5 frames each through process_scan at capacity 131072
     (HDL-64 x 900 but C3), launch counts set to 0 before each and read after
     (it = the ICP iterations of frames 2-5):
       C1 configs/imls_wls_kitti00.json as shipped: no launch;
       C2 C1 with IMLS.use_projected_distance: projected_argmin it times;
       C3 configs/tensor_voting_vlp32.json on a VLP-32C at 0.2 deg
          (32 x 1800): no launch; the path's peak device memory printed;
       C4 B1 solved by ICP: nearest 31 it times (a match and 30 solve steps);
       C5 B1 solved by Teaser (k-core on): nearest it times;
       C6 the default config with FPS normal sampling: fps_ranks 5 times;
       C7 the default config with random major-axis quotas: cylinder_stats
          4 times, fps_ranks never;
     every pose finite; the ATE below 0.1 m where plo_tpu's own ATE on the
     same frames (JAX_ATE_M, tests/reference_ate.py on the CPU) is below
     0.05 m, else correspondences > 0 on every ICP frame and the ATE printed;
  8. the method matrix (plo_tpu_torch.method_matrix): all 36 combinations
     at the tool's size (32 x 450, 6 frames, capacity 16384) on the card,
     each below 0.1 m ATE; the table and the phase's time printed;
  9. slice D's paths on phase 3's frames, launch counts set to 0 before each
     and read after, every pose finite, frame times, ICP iterations, launches
     and peak device memory printed:
       D1 map dense: tools/bench_map_mode.py's config (range_image/pca,
          random 2,000, frozen IMLS, RANSAC-1000 + DRPM, a 65,536-point voxel
          map at 0.3 m) at capacity 57600, through process_scan (float32)
          and through process_scans(batch=4) with grid16: no launch, ATE
          below 0.1 m, det(R) of the device world pose within 1e-5 of 1;
       D2 map grid_hash: D1 with map.search="grid_hash": the same checks, and
          every position within 2e-3 m of D1's (tests/test_map_mode.py:104);
       D3 map plane-ICP: B1 with target_mode="map" at capacity 131072:
          nearest it times, ATE below 0.1 m;
       D4 undistortion: B1 with motion_prior and undistort on swept frames
          (phase 3's world at 0.8 m and 0.02 rad a frame, each passed
          through synthetic.distort_sequence; make_swept_sequence says why):
          nearest it times; and with undistort off: the undistorted ATE must
          be the lower;
       D5 FALS: configs/drpm_range_image.json as shipped: nearest it times;
          capability (plo_tpu does not converge there);
       D6 SRI: D5 with method SRI; D7 cross-product: B1 with
          compute_normal_method.method="cross_product": nearest it times;
     D3-D7 per frame at capacity 131072, gated as phase 7 (JAX_ATE_M);
 10. slice D's last part: windowed BA, loop closure, the planetary world
     (slice_e_configs, slice_e_sequence), launch counts set to 0 before
     each path and read after, every pose finite, frame times and ICP
     iterations printed, plo_tpu's own numbers (JAX_E) beside the port's:
       E1 tests/test_ba.py's BA rescue (identity init, 1 m a frame, 12
          frames at 32 x 450, capacity 16384) with BA off and on, per frame:
          ATE(on) x 2 below ATE(off); one refine_window call timed;
       E2 its batched case (10 frames): per frame and through
          process_scans(batch=4) in async mode, positions within 0.05 m of
          each other, the batched ATE below max(2 x per frame, 0.05 m);
       E3 B1 with BA on (window 4) on phase 3's frames: nearest it + 7 times
          (the ICP loop, and the recorder: 1 + 2 + 2 + 2 matches), ATE below
          0.1 m;
       E4 tests/test_loopclosure.py's 136-frame rectangle loop through
          process_scans(batch=8), then close_loops: a loop edge, the endpoint
          error cut by 3x, the ATE below 0.7x, pose 0 unchanged; the
          odometry's and close_loops' seconds printed;
       E5 tests/test_planetary.py's planetary frames, DRPM against Weighted
          LS: its three claims;
     E1, E2, E4 and E5 launch no kernel (their searches are knn);
 11. the CLI: plo_tpu_torch.cli.main(argv) in process, in a temporary
     directory deleted after, launch counts set to 0 before each run and
     read after, the CLI's frame lines and evaluation echoed:
       F1 tests/test_kitti_density.py's drill at full width: 4 HDL-64 x 1900
          scans (above 110k points each, no truncation) written in the KITTI
          layout and read through the native prefetcher at capacity 131072,
          its plane-ICP + LS config, --save-artifacts --checkpoint-every 2
          --eval-gt: nearest once per ICP iteration of frames 2-4, the
          reference's artifact files in their formats, ATE below 0.25 m;
          the artifacts' size and the saver's seconds printed;
       F2 F1 without artifacts, 2 frames checkpointed, then the last 2
          resumed from the checkpoint: positions within 1e-4 m of F1's;
       F3 the CLI's defaults (synthetic, 64 x 1800, capacity 131072, the
          default config) for 5 frames: cylinder_stats and fps_ranks 4
          times each, every pose finite, the ATE gated as phase 7's
          (JAX_F, tests/reference_ate.py F1 F3);
     and a DeviceTrace (torch.profiler) of one F1 frame holding a device
     event of nearest_kernel; the prefetcher's read time and the phase's
     seconds printed.
 12. multi-device (plo_tpu_torch.parallel), 8 shards on cuda:0, launch
     counts set to 0 before each run and read after, frame times printed:
       G1 the sharded map at full width: bench.map_config("dense") (the
          headline config against a 65,536-point voxel map at 0.3 m) at
          capacity 57600 on 9 HDL-64 x 900 frames of phase 3's world and
          motion, per frame and batched (frame 0, then two batches of 4),
          against the single-device map run: positions within 0.01 m, ATE
          gap below 5 mm, ATE below 0.1 m, no shard above 2/8 of the map,
          batched poses equal to per frame, no kernel launch (the search is
          knn);
       G2 the sharded ICP step with 8 shards and on a 2 x 4 mesh, B1 on
          phase 3's frames 2-5 (each frame's flat against the previous
          filtered cloud), against the single-device icp_loop: rPose within
          1e-4, correspondence counts equal, nearest launched 8 times an
          ICP iteration, each launch bit-equal to nearest_plain on its
          shard's slice;
       G3 make_distributed_refine with 8 shards against refine_window on
          E3's BA window (B1 + BA, window 4, HDL-64 x 900): within 1e-4;
          both refines timed;
       G4 G1's per-frame run saved after its 6th frame (save_sharded),
          loaded on 8 and on 4 shards and run to its 9th: positions within
          1e-5 m and 5e-3 m of the uninterrupted run;
       G5 G1's per-frame run with the mesh joined to a 1-rank NCCL group on
          a localhost TCP port: poses equal to G1's; a CUDA tensor on a gloo
          group raises;
With --baseline DIR (an older checkout, e.g. `git archive` of a parent
commit unpacked into a git-ignored directory), each call that phases 2 and
2b time (MAIN_CALLS) is also made with DIR's function of the same name and
timed in turns with this tree's (DIR, this tree, this tree, DIR), and the
rows where the two outputs differ are counted.
The second-to-last line is the kernels' JSON record; the last line, printed
only when every phase passed, is {"ok": true, "device": {...}}.

Imports torch, numpy and plo_tpu_torch only (never JAX or plo_tpu); writes
the kernel and loader builds under plo_tpu_torch/_build/ (and DIR's), and
phase 11's files in a temporary directory that it deletes.
"""
import argparse
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
CYL_OPS_PER_PAIR = 9         # every pair: d2 (3 sub, 3 mul, 2 add) and its compare
CYL_OPS_PER_GATED_PAIR = 13  # where d2 passes: d.n 3 mul 2 add, p2 2 mul 1 sub, compare, sqrt, add, count
FPS_OPS_PER_SLOT_STEP = 12   # 3 sub, 3 mul, 2 add, min, compare, argmax compare + select
NEAREST_OPS_PER_PAIR = 9     # 3 sub, 3 mul, 2 add, compare
PROJ_OPS_PER_PAIR = 9        # d2 and its gate: 3 sub, 3 mul, 2 add, compare
PROJ_OPS_PER_GATED_PAIR = 17  # where d2 passes: cross 6 mul 3 sub, p2 3 mul 2 add, 2 compares, select
GATE_INSTR_PER_PAIR = 10     # lane-instructions a pair of the pair kernels issues at least:
                             # d2 (3 sub, 3 mul, 2 add, unfused), its compare, the bit or
                             # select it feeds
H100_LANE_INSTR_PER_S = 132 * 128 * 1.98e9  # 132 SMs x 4 schedulers x 32 lanes at 1.98 GHz
SPIN_CYCLES_PER_MS = 2.0e6   # torch.cuda._sleep cycles a millisecond, at most (1.98 GHz)
ATE_BOUND_M = 0.1
HEADLINE_BATCH = 4                 # phase 6: frame 0 alone, frames 2-5 as one batch
IMLS_WLS, TENSOR_VOTING = "configs/imls_wls_kitti00.json", "configs/tensor_voting_vlp32.json"
VLP32_AZIMUTH_STEPS = 1800         # phase 7 C3: a VLP-32C at 0.2 deg
# plo_tpu's ATE (m) on phase 7's and 9's frames, the same configs and
# capacities, JAX on the CPU (tests/reference_ate.py). Where it is below JAX_ATE_GATE_M the path
# must meet ATE_BOUND_M; elsewhere plo_tpu itself does not converge there and
# the check is capability only.
JAX_ATE_M = {"C1": 0.002480622126666324, "C2": 1.2676303351183331, "C3": 1.2000892780120929,
             "C4": 0.014870992114515327, "C5": 1.210399997576329, "C6": 0.0022576493822073353,
             "C7": 0.0014565372107066643,
             "D1": 0.0007514070380471967, "D2": 0.0007449906840990181,
             "D3": 0.002205519435076148, "D4": 0.006180176648298155,
             "D4 off": 0.00793042390687992, "D5": 0.8214545315066566,
             "D6": 0.1546565440617852, "D7": 0.0025577796593220423}
JAX_ATE_GATE_M = 0.05
# plo_tpu's numbers on phase 10's paths, JAX on the CPU (tests/reference_ate.py
# E1-E5): ATEs (m), E2's largest per-frame / batched position gap (m), E4's
# endpoint errors (m) and loop edges (i, j, correspondences), E5's worst
# cross-track errors (m) and least DRPM probabilities.
JAX_E = {"E1 off": 4.280728995875654, "E1 on": 0.5284734430823392,
         "E2": 0.06786820143905097, "E2 batched": 0.06571666027546282,
         "E2 gap": 0.005558122889156798, "E3": 0.0028565717347245555,
         "E4 before": 0.1446818457923702, "E4 after": 0.08024550231203001,
         "E4 end before": 0.29723754036010086, "E4 end after": 0.013542971669248548,
         "E4 edges": [(0, 134, 451)],
         "E5 DRPM": 2.0916503589120987, "E5 WLS": 7.636329239462856,
         "E5 cross DRPM": 1.607342212956588e-07, "E5 cross WLS": 13.062289213663796,
         "E5 min prob": 0.0, "E5 min prob batched": 0.0,
         "E5 snr planetary": 0.0, "E5 snr corridor": 0.9975725412368774}
# plo_tpu's ATE (m) on phase 11's F1 and F3 command lines, through its own
# CLI with --platform cpu (tests/reference_ate.py F1 F3).
JAX_F = {"F1": 0.0028641061868325273, "F3": 0.0016377498046388319}
MATRIX_FRAMES, MATRIX_ATE_M = 6, 0.1   # phase 8: the slow JAX test's frames and bound
DRPM_RANGE_IMAGE = "configs/drpm_range_image.json"
MAP_CAPACITY, MAP_BATCH = 57600, 4     # phase 9 D1/D2: bench_map_mode's capacity; batch
MAP_GRID_HASH_M = 2e-3                 # phase 9 D2: grid_hash positions within this of D1's
DET_TOLERANCE = 1e-5                   # phase 9 D1/D2: |det(R) - 1| of the world pose
SMALL_AZIMUTH_STEPS = 450              # phase 10 E1, E2, E4, E5: 32 beams x 450
BA_WINDOW = 4                          # phase 10: the BA window (tests/test_ba.py)
BA_CAPACITY = 16384                    # phase 10 E1, E2, E5: the JAX tests' capacity
BA_BATCH = 4                           # phase 10 E2: process_scans' batch
BA_GAP_M = 0.05                        # phase 10 E2: batched positions within this of per frame
LOOP_CAPACITY, LOOP_BATCH = 14400, 8   # phase 10 E4 (tests/test_loopclosure.py)
LOOP_MIN_GAP, LOOP_RADIUS = 60, 4.0    # phase 10 E4: close_loops' revisit detection
KITTI_FRAMES, KITTI_AZIMUTH_STEPS = 4, 1900   # phase 11 F1: tests/test_kitti_density.py's drill
KITTI_ATE_BOUND_M = 0.25               # phase 11 F1: the drill's bound
KITTI_MIN_POINTS = 110_000             # phase 11 F1: KITTI-class density a scan
CKPT_EVERY = 2                         # phase 11 F1, F2: --checkpoint-every
RESUME_GAP_M = 1e-4                    # phase 11 F2: resumed positions within this of F1's
CLI_FRAMES = 5                         # phase 11 F3: the CLI's own synthetic sequence
SHARDS = 8                             # phase 12: shards on cuda:0 (G1-G5)
G_FRAMES, G_SAVE_AFTER = 9, 5          # phase 12 G1: frames; G4: saved after this index
G_BATCH = 4                            # phase 12 G1: frame 0 alone, then two batches of 4
G_SINGLE_GAP_M, G_ATE_GAP_M = 0.01, 0.005   # G1: tests/test_parallel.py:131-181's bounds
G_ICP_ATOL, G_BA_ATOL = 1e-4, 1e-4     # G2, G3: tests/test_parallel.py:41-56, :112
G_RESUME_M, G_ELASTIC_M = 1e-5, 5e-3   # G4: tests/test_map_store.py:48-114's bounds

# Each path's ATE (m) as phase_path measured it, by path name.
ATES = {}

# The call of each function that phases 2 and 2b time, as label ->
# (module under plo_tpu_torch/ops, function name, args, kwargs): what
# --baseline times again with an older checkout's function of that name.
MAIN_CALLS = {}


def call_ms(fn, reps=15):
    """Median milliseconds of one call of fn() between a pair of CUDA events,
    the device idle before it, after one warm-up: the wrapper's host
    prelude before its first launch counts, so this is an upper bound of the
    device time."""
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


def cuda_ms(fn, runs=7):
    """Device milliseconds per call of fn(): one pair of CUDA events around
    N back-to-back calls (N up to 50, about 20 ms of work), divided by N;
    the median over `runs` such runs, after a warm-up. Each run first queues
    a spin kernel long enough for the host to enqueue all N calls behind it,
    so the calls run back to back on the device and the host's time between
    launches is not counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n = max(1, min(50, int(20.0 / max(wall_ms, 1e-3))))
    spin_cycles = int(min(1.5 * n * wall_ms + 0.5, 300.0) * SPIN_CYCLES_PER_MS)
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def profiler_ms(fn, kernels, calls=10, attempts=2):
    """Device milliseconds per call of fn() that torch.profiler attributes to
    the named CUDA kernels (substrings of their names), or None where the
    trace holds no device event of them. A trace that holds no device event
    at all (it happens now and then on the H100 host) is taken again, up to
    `attempts` traces."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev_events:
            break
    us = [e.time_range.elapsed_us() for e in dev_events if any(k in e.name for k in kernels)]
    if not us:
        print(f"  profiler: no device event named {kernels} among "
              f"{sorted({e.name[:80] for e in dev_events})[:6]}", flush=True)
    return sum(us) / 1e3 / calls if us else None


def timings(fn, kernels):
    """cuda_ms, call_ms and profiler_ms of one wrapper."""
    return dict(ms=cuda_ms(fn), call_ms=call_ms(fn), profiler_ms=profiler_ms(fn, kernels))


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


def _gated(query, tgt, valid, gate2):
    """How many valid query-target pairs have d2 < gate2 (chunked)."""
    n = 0
    for s in range(0, tgt.shape[0], 8192):
        d = ((query[:, None, :] - tgt[None, s:s + 8192]) ** 2).sum(-1) < gate2
        n += int(d[:, valid[s:s + 8192]].sum())
    return n


def issue_ms(pairs):
    """The issue ceiling of a pair kernel: GATE_INSTR_PER_PAIR
    lane-instructions a pair at the card's lane issue rate. Computed, not
    measured: printed beside the kernel's times, kept out of its record."""
    return pairs * GATE_INSTR_PER_PAIR / H100_LANE_INSTR_PER_S * 1e3


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
        # dist_sum: f32 sums in another order (target slices vs 512-wide
        # chunks) — rtol 2e-5 / atol 1e-4, as tests/test_pallas_nn.py.
        torch.testing.assert_close(s, s_ref, rtol=2e-5, atol=1e-4)
        err = max(err, float((s - s_ref).abs().max()))
    MAIN_CALLS["cylinder_stats"] = ("cuda_nn", "cylinder_stats",
                                    (query, normal, tgt, valid, 1.5, 0.5), dict(t_live=t_live))
    rec = timings(lambda: cuda_nn.cylinder_stats(query, normal, tgt, valid, 1.5, 0.5,
                                                 t_live=t_live), ("cylinder_",))
    full_ms = cuda_ms(lambda: cuda_nn.cylinder_stats(query, normal, tgt, valid, 1.5, 0.5))
    plain_ms = cuda_ms(lambda: cuda_nn.cylinder_stats_plain(query, normal, tgt, valid, 1.5, 0.5))
    n_valid = int(valid.sum())
    gated = _gated(query, tgt, valid, cuda_nn.f32_square(1.5))
    ops = q_n * n_valid * CYL_OPS_PER_PAIR + gated * CYL_OPS_PER_GATED_PAIR
    nbytes = q_n * 3 * 4 * 2 + t_n * 3 * 4 + t_n + q_n * 8
    print(f"cylinder_stats: Q={q_n} T={t_n} valid={n_valid}: counts equal "
          f"(mean {float(c_ref.float().mean()):.2f} neighbors), max |dist_sum err| {err:.3g}; "
          f"{gated} of {q_n * n_valid} pairs pass the d2 gate; "
          f"kernel {rec['ms']:.4f} ms (t_live) / {full_ms:.4f} ms (full T), "
          f"one call {rec['call_ms']:.4f} ms, profiler {rec['profiler_ms']}, "
          f"plain {plain_ms:.3f} ms; issue ceiling {issue_ms(q_n * n_valid):.4f} ms "
          f"(computed)", flush=True)
    records.append(dict(name="cylinder_stats", route="cuda",
                        source="plo_tpu_torch/csrc/cylinder_stats.cu",
                        replaces="plo_tpu/ops/pallas_nn.py:238", max_abs_err=err,
                        plain_ms=plain_ms, full_t_ms=full_ms, **rec, **_bound(ops, nbytes),
                        library_ms=None))

    # fps_ranks: 64 bins x 1024 slots, 200 steps; bins filled unevenly (an
    # empty one, full ones) as the major-axis histogram fills them. A second
    # table repeats points: pairs of duplicates in every bin, and one bin of
    # 1,024 copies of one point (every min-d2 ties at 0).
    b, c, steps = 64, 1024, 200
    table_xyz = (torch.rand((b, c, 3), generator=g, device=dev) * 40.0 - 20.0).contiguous()
    fill = torch.randint(0, c + 1, (b, 1), generator=g, device=dev)
    fill[0], fill[1] = 0, c
    table_occ = (torch.arange(c, device=dev)[None, :] < fill).to(torch.float32).contiguous()
    dup_xyz = table_xyz.clone()
    dup_xyz[:, c // 2:] = dup_xyz[:, :c // 2]
    dup_xyz[2] = dup_xyz[2, 0]
    steps_t = torch.tensor(steps, dtype=torch.int32, device=dev)
    for case, xyz in (("duplicates", dup_xyz), ("main", table_xyz)):
        r = cuda_nn.fps_ranks(xyz, table_occ, steps_t, 200)
        r_ref = cuda_nn.fps_ranks_plain(xyz, table_occ, steps_t, 200)
        torch.cuda.synchronize()
        if not torch.equal(r, r_ref):
            raise AssertionError(f"fps_ranks ({case}) differ in {int((r != r_ref).sum())} slots")
    MAIN_CALLS["fps_ranks"] = ("cuda_nn", "fps_ranks", (table_xyz, table_occ, steps_t, 200), {})
    rec = timings(lambda: cuda_nn.fps_ranks(table_xyz, table_occ, steps_t, 200), ("fps_kernel",))
    plain_ms = cuda_ms(lambda: cuda_nn.fps_ranks_plain(table_xyz, table_occ, steps_t, 200))
    occupied = int(table_occ.sum())
    ops = occupied * (steps - 1) * FPS_OPS_PER_SLOT_STEP
    nbytes = b * c * (3 * 4 + 4) + b * c * 4
    print(f"fps_ranks: B={b} C={c} steps={steps} occupied={occupied}: ranks equal "
          f"({int((r < 200).sum())} ranked; duplicated points too); kernel {rec['ms']:.4f} ms "
          f"= {1e3 * rec['ms'] / (steps - 1):.3f} us a step, one call {rec['call_ms']:.4f} ms, "
          f"profiler {rec['profiler_ms']}, plain {plain_ms:.3f} ms", flush=True)
    records.append(dict(name="fps_ranks", route="cuda", source="plo_tpu_torch/csrc/fps_ranks.cu",
                        replaces="plo_tpu/ops/pallas_nn.py:344", max_abs_err=0.0,
                        plain_ms=plain_ms, **rec, **_bound(ops, nbytes), library_ms=None))
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
             ("duplicates", dup, torch.ones(12, dtype=torch.bool, device=dev)),
             ("unaligned", tgt[1:], valid[1:])]   # views 12 and 1 bytes past an allocation
    MAIN_CALLS["nearest"] = ("cuda_nn", "nearest", (query, tgt, valid, PICP_R), {})
    MAIN_CALLS["projected_argmin"] = ("cuda_nn", "projected_argmin",
                                      (query, normal, tgt, valid, eg, PICP_R_PROJ), {})
    kernels = [
        ("nearest", lambda t, v: cuda_nn.nearest(query, t, v, PICP_R),
         lambda t, v: cuda_nn.nearest_plain(query, t, v, PICP_R), ("nearest_",)),
        ("projected_argmin", lambda t, v: cuda_nn.projected_argmin(query, normal, t, v, eg, PICP_R_PROJ),
         lambda t, v: cuda_nn.projected_argmin_plain(query, normal, t, v, eg, PICP_R_PROJ),
         ("projected_",)),
    ]
    n_valid = int(valid.sum())
    # Pairs that pass projected_argmin's d2 gate: only they need the cross product.
    gated = _gated(query, tgt, valid, cuda_nn.f32_square(eg))
    nbytes_in = q_n * 12 + t_n * 12 + t_n
    records = []
    for name, kern, plain, kernel_names in kernels:
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
        rec = timings(lambda: kern(tgt, valid), kernel_names)
        plain_ms = cuda_ms(lambda: plain(tgt, valid))
        if name == "nearest":
            ops = q_n * n_valid * NEAREST_OPS_PER_PAIR
            nbytes = nbytes_in + q_n * 9
        else:
            ops = q_n * n_valid * PROJ_OPS_PER_PAIR + gated * PROJ_OPS_PER_GATED_PAIR
            nbytes = nbytes_in + q_n * 12 + q_n * 9
        ceiling = issue_ms(q_n * n_valid)
        print(f"{name}: Q={q_n} T={t_n} valid={n_valid}: equal to the plain version bit for bit "
              f"(main: {found} found; all-invalid: none; duplicates: lowest index; unaligned "
              f"target); kernel {rec['ms']:.4f} ms, one call {rec['call_ms']:.4f} ms, profiler "
              f"{rec['profiler_ms']}, plain {plain_ms:.3f} ms; issue ceiling {ceiling:.4f} ms "
              f"(computed), {100 * ceiling / rec['ms']:.0f} % of it", flush=True)
        records.append(dict(name=name, route="cuda", source=f"plo_tpu_torch/csrc/{name}.cu",
                            replaces="plo_tpu/ops/pallas_nn.py:" + ("117" if name == "nearest" else "148"),
                            max_abs_err=0.0, plain_ms=plain_ms, **rec, **_bound(ops, nbytes),
                            library_ms=None))
    print(f"projected_argmin: {gated} of {q_n * n_valid} valid pairs pass the d2 gate", flush=True)
    records[0]["icp_case_ms"] = phase_icp_nearest(dev, g)
    records[0]["map_case_ms"] = phase_map_nearest(dev, g)
    return records


def phase_icp_nearest(dev, g):
    """nearest at the point-to-point ICP solve's shapes (solvers/
    icp_umeyama.py): the moved source (2,000) against its matched points
    (2,000), radius infinite, half the targets masked; bit-equal to the
    plain version. Returns the kernel's device ms."""
    import torch
    from plo_tpu_torch.ops import cuda_nn
    q_n = ICP_QUERIES
    tgt = (torch.rand((q_n, 3), generator=g, device=dev) * 60.0 - 30.0).contiguous()
    query = (tgt + 0.05 * torch.randn((q_n, 3), generator=g, device=dev)).contiguous()
    valid = torch.rand(q_n, generator=g, device=dev) < 0.5
    out = cuda_nn.nearest(query, tgt, valid)
    ref = cuda_nn.nearest_plain(query, tgt, valid)
    torch.cuda.synchronize()
    for a, b, what in zip(out, ref, ("distance", "idx", "valid")):
        if not torch.equal(a, b):
            raise AssertionError(f"nearest (ICP solve shapes): {what} differs from the plain "
                                 f"version in {int((a != b).sum())} of {q_n}")
    if not bool(valid[out[1].long()].all()):
        raise AssertionError("nearest (ICP solve shapes): matched a masked target")
    ms = cuda_ms(lambda: cuda_nn.nearest(query, tgt, valid))
    print(f"nearest (ICP solve): Q=T={q_n}, {int(valid.sum())} valid, radius inf: equal to the "
          f"plain version bit for bit; kernel {ms:.4f} ms", flush=True)
    return ms


MAP_SLOTS, MAP_LIVE = 65536, 50000   # phase 9 D3's voxel map: capacity, valid prefix


def phase_map_nearest(dev, g):
    """nearest at the map's shape (phase 9 D3): 2,000 queries against a
    65,536-slot voxel map at 0.3 m whose 50,000 valid points are a prefix in
    order of distance from the sensor, as voxel_map_insert leaves them,
    radius 1.5 m; bit-equal to the plain version. Returns the kernel's
    device ms."""
    import torch
    from plo_tpu_torch.ops import cuda_nn
    cells = torch.randint(-100, 101, (MAP_SLOTS, 3), generator=g, device=dev)
    cells[:, 2] = cells[:, 2] % 12 - 6
    pts = cells.to(torch.float32) * 0.3 + 0.15
    pts = pts[torch.argsort((pts * pts).sum(1))].contiguous()
    valid = torch.arange(MAP_SLOTS, device=dev) < MAP_LIVE
    query = (pts[torch.randint(0, MAP_LIVE, (ICP_QUERIES,), generator=g, device=dev)]
             + 0.2 * torch.randn((ICP_QUERIES, 3), generator=g, device=dev)).contiguous()
    out = cuda_nn.nearest(query, pts, valid, PICP_R)
    ref = cuda_nn.nearest_plain(query, pts, valid, PICP_R)
    torch.cuda.synchronize()
    for a, b, what in zip(out, ref, ("distance", "idx", "valid")):
        if not torch.equal(a, b):
            raise AssertionError(f"nearest (map shape): {what} differs from the plain version "
                                 f"in {int((a != b).sum())} of {ICP_QUERIES}")
    if not bool((out[1][out[2]] < MAP_LIVE).all()):
        raise AssertionError("nearest (map shape): matched a slot past the valid prefix")
    ms = cuda_ms(lambda: cuda_nn.nearest(query, pts, valid, PICP_R))
    plain = cuda_ms(lambda: cuda_nn.nearest_plain(query, pts, valid, PICP_R))
    ops = ICP_QUERIES * MAP_LIVE * NEAREST_OPS_PER_PAIR
    nbytes = ICP_QUERIES * 12 + MAP_SLOTS * 13 + ICP_QUERIES * 9
    print(f"nearest (map): Q={ICP_QUERIES} T={MAP_SLOTS} valid={MAP_LIVE} (prefix), r={PICP_R}: "
          f"equal to the plain version bit for bit ({int(out[2].sum())} found); kernel "
          f"{ms:.4f} ms, plain {plain:.3f} ms, bound {_bound(ops, nbytes)}", flush=True)
    return ms


def phase_knn(dev, g):
    """knn on the card against knn on the CPU on the same inputs, at the
    default path's IMLS search (2,048 queries, k = 20, r = 3 m, a
    131,072-slot target with 57,600 valid): indices, masks and d2 exactly
    equal. The target holds exact ties inside a chunk (40 copies of one
    point, more than k) and across chunk boundaries (the last 4,000 valid
    points repeat the first 4,000), and queries sit on tied points. Times
    the search on the card on the same target before the ties are put in
    (`knn_ms`, the common case) and after (`knn_ties_ms`, which takes the
    exact second pass)."""
    import torch
    from plo_tpu_torch.ops import neighbors

    q_n, t_n, live, k, radius = 2048, CAPACITY, LIVE, 20, 3.0
    tgt = torch.zeros((t_n, 3), device=dev)
    tgt[:live] = torch.rand((live, 3), generator=g, device=dev) * 40.0 - 20.0
    tgt[:live, 2] *= 0.1
    valid = torch.arange(t_n, device=dev) < live
    pick = torch.randint(0, live, (q_n,), generator=g, device=dev)
    query = (tgt[pick] + 0.3 * torch.randn((q_n, 3), generator=g, device=dev)).contiguous()
    search = lambda: neighbors.knn(query, tgt, valid, k=k, radius=radius)
    MAIN_CALLS["knn"] = ("neighbors", "knn", (query.clone(), tgt.clone(), valid),
                         dict(k=k, radius=radius))
    rec = dict(knn_ms=cuda_ms(search))

    tgt[live - 4000:live] = tgt[:4000]
    a = live // 3                 # inside one chunk at the path's chunk size
    tgt[a:a + 40] = tgt[a + 40]
    query[:200] = tgt[torch.randint(0, 4000, (200,), generator=g, device=dev)]
    query[200:250] = tgt[a + 40]
    cpu = [x.cpu() for x in (query, tgt, valid)]

    MAIN_CALLS["knn (ties)"] = ("neighbors", "knn", (query, tgt, valid), dict(k=k, radius=radius))
    out = neighbors.knn(query, tgt, valid, k=k, radius=radius)
    ref = neighbors.knn(*cpu, k=k, radius=radius)
    differ = _rows_differ(out, ref)
    print(f"knn: {differ} of {q_n} rows differ between CUDA and CPU", flush=True)
    if differ:
        raise AssertionError(f"knn on CUDA differs from knn on the CPU in {differ} rows")
    if not bool((out[1][200:250] < a + 40).all()):
        raise AssertionError("knn: a tie inside a chunk did not go to the lower indices")
    rec["knn_ties_ms"] = cuda_ms(search)
    print(f"knn: Q={q_n} T={t_n} k={k}: equal to the CPU form (ties: lowest index); "
          f"{rec['knn_ms']:.3f} ms on the card, {rec['knn_ties_ms']:.3f} ms with the ties",
          flush=True)
    return rec


def _rows_differ(out, ref):
    """How many rows differ in any of two functions' outputs (a tensor or a
    tuple of tensors of Q rows each)."""
    import torch
    out, ref = (x if isinstance(x, tuple) else (x,) for x in (out, ref))
    rows = torch.zeros(out[0].shape[0], dtype=torch.bool)
    for x, y in zip(out, ref):
        rows |= (x.cpu() != y.cpu()).reshape(x.shape[0], -1).any(1)
    return int(rows.sum())


def phase_baseline(root):
    """Each call of MAIN_CALLS made with the function of the same name from
    the older checkout at `root` (its plo_tpu_torch/ops modules, loaded under
    other names, its kernels built into its own _build/): the rows where the
    two outputs differ, and both timed in turns (root, this tree, this tree,
    root) with cuda_ms, and root's with call_ms."""
    import importlib.util
    mods = {}
    for name in sorted({m for m, _, _, _ in MAIN_CALLS.values()}):
        spec = importlib.util.spec_from_file_location(
            f"baseline_{name}", os.path.join(root, "plo_tpu_torch", "ops", f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    seconds, _ = mods["cuda_nn"].build()
    print(f"baseline: {root}, built in {seconds:.2f} s", flush=True)
    for label, (mod, fn, args, kwargs) in MAIN_CALLS.items():
        old = getattr(mods[mod], fn)
        new = getattr(importlib.import_module(f"plo_tpu_torch.ops.{mod}"), fn)
        before, after = (lambda f=f: f(*args, **kwargs) for f in (old, new))
        differ = _rows_differ(before(), after())
        b1, a1, a2, b2 = cuda_ms(before), cuda_ms(after), cuda_ms(after), cuda_ms(before)
        print(f"baseline {label}: {differ} rows differ from this tree's; in turns: baseline "
              f"{b1:.4f} / {b2:.4f} ms, this tree {a1:.4f} / {a2:.4f} ms; baseline one call "
              f"{call_ms(before):.4f} ms", flush=True)


def _bound(ops, nbytes):
    """The least time the card could take: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations")


def make_sequence(n_scans=N_SCANS, azimuth_steps=AZIMUTH_STEPS):
    """5 frames (HDL-64 x 900 by default) of a structure-rich world: the
    identity-init reference regime needs walls around the ground plane to
    pin x/y (as tests/test_odometry.py's RANSAC/DRPM test)."""
    from plo_tpu_torch.io import synthetic
    t0 = time.perf_counter()
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=n_scans, azimuth_steps=azimuth_steps,
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


def phase_path(dev, name, cfg, scans, gt, expect, jax_ate=None):
    """One path: the frames through the port's Odometry, with every launch
    count set to 0 just before and read just after; `expect(icp_iterations)`
    gives the launch counts the path must show (icp_iterations: the sum over
    frames 2-5). The ATE must be below ATE_BOUND_M unless plo_tpu's own ATE
    `jax_ate` is JAX_ATE_GATE_M or more; then every ICP frame must find
    correspondences. Returns the launch counts."""
    import numpy as np
    import torch
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.utils import evaluate

    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_nn.reset_launches()
    wall = time.perf_counter()
    iters, corr = [], []
    for s in scans:
        t = time.perf_counter()
        f = odo.process_scan(s)
        torch.cuda.synchronize()
        iters.append(f.iterations)
        corr.append(f.n_correspondences)
        print(f"  {name} frame {f.index}: {1e3 * (time.perf_counter() - t):.1f} ms, "
              f"{f.iterations} ICP iterations, {f.n_correspondences} correspondences, "
              f"{int(f.stats['n_sampled'])} sampled", flush=True)
    wall = time.perf_counter() - wall
    launches = dict(cuda_nn.LAUNCHES)
    est = odo.poses()
    if not np.isfinite(est).all():
        raise AssertionError(f"{name}: non-finite pose")
    ate = evaluate.ate_rmse(est, np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt), align=False)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ATES[name] = ate
    gated = jax_ate is None or jax_ate < JAX_ATE_GATE_M
    print(f"{name}: {wall:.2f} s for {len(scans)} frames, ATE {ate:.4f} m (plo_tpu's on the "
          f"CPU: {jax_ate if jax_ate is not None else 'not measured'}; "
          f"{'bound ' + str(ATE_BOUND_M) + ' m' if gated else 'capability only'}), "
          f"ICP iterations {iters}, launches {launches}, peak device memory {peak:.2f} GiB",
          flush=True)
    if launches != expect(sum(iters[1:])):
        raise AssertionError(f"{name}: launches {launches}, expected {expect(sum(iters[1:]))}")
    if gated and not ate < ATE_BOUND_M:
        raise AssertionError(f"{name}: ATE {ate} m >= {ATE_BOUND_M} m")
    if not gated and min(corr[1:]) <= 0:
        raise AssertionError(f"{name}: an ICP frame found no correspondence: {corr}")
    return launches


def phase_headline(dev, scans, gt):
    """Phase 6 (see the module docstring). Returns the launch counts."""
    import numpy as np
    import torch
    from plo_tpu_torch.bench import CAPACITY as HEADLINE_CAPACITY, headline_config
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.utils import evaluate

    cfg = headline_config(N_SCANS, 360.0 / AZIMUTH_STEPS)
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    torch.cuda.synchronize()
    cuda_nn.reset_launches()
    for transfer in ("int16", "grid16"):
        odo = Odometry(cfg, capacity=HEADLINE_CAPACITY, seed=0, device=dev, async_mode=True,
                       transfer=transfer)
        walls = []
        for part in (scans[:1], scans[1:]):   # frame 0 alone, then frames 2-5 as one batch
            t = time.perf_counter()
            odo.process_scans(part, batch=HEADLINE_BATCH)
            odo.sync()
            walls.append(1e3 * (time.perf_counter() - t))
        frames = odo.finalize()
        est = odo.poses()
        if not np.isfinite(est).all():
            raise AssertionError(f"headline {transfer}: non-finite pose")
        ate = evaluate.ate_rmse(est, gt_rel, align=False)
        print(f"headline {transfer}: frame 0 {walls[0]:.1f} ms, frames 2-5 (one batch) "
              f"{walls[1]:.1f} ms = {walls[1] / (len(scans) - 1):.1f} ms a frame; ATE {ate:.4f} m, "
              f"ICP iterations {[f.iterations for f in frames]}, "
              f"sampled {[int(f.stats['n_sampled']) for f in frames]}", flush=True)
        if not ate < ATE_BOUND_M:
            raise AssertionError(f"headline {transfer}: ATE {ate} m >= {ATE_BOUND_M} m")
    loop = Odometry(cfg, capacity=HEADLINE_CAPACITY, seed=0, device=dev, transfer="float32")
    for s in scans:
        loop.process_scan(s)
    batched = Odometry(cfg, capacity=HEADLINE_CAPACITY, seed=0, device=dev, async_mode=True,
                       transfer="float32")
    batched.process_scans(scans, batch=HEADLINE_BATCH)
    same = np.array_equal(batched.poses(), loop.poses()) and all(
        (a.iterations, a.n_correspondences, a.stats) == (b.iterations, b.n_correspondences, b.stats)
        for a, b in zip(batched.trajectory, loop.trajectory))
    print(f"headline float32: process_scans {'bit-identical' if same else 'DIFFERS from'} "
          f"the process_scan loop", flush=True)
    if not same:
        raise AssertionError("headline: float32 process_scans differs from the process_scan loop")
    launches = dict(cuda_nn.LAUNCHES)
    print(f"headline: launches {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError(f"headline: the path launched a kernel: {launches}")
    return launches


def slice_c_configs(cfgmod, root):
    """Phase 7's configs C1-C7 built on a config module with the port's
    config API (plo_tpu_torch.config here; tests/reference_ate.py passes
    plo_tpu.config), the JSON files read from under `root`."""
    import dataclasses as dc
    hdl = cfgmod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZIMUTH_STEPS)
    vlp = cfgmod.SensorConfig(n_scans=32, azimuth_resolution=360.0 / VLP32_AZIMUTH_STEPS)
    load = lambda path, sensor=hdl: cfgmod.load(os.path.join(root, path), sensor=sensor)

    def with_lo(cfg, **kw):
        return dc.replace(cfg, laser_odometry=dc.replace(cfg.laser_odometry, **kw))

    c1 = load(IMLS_WLS)
    mm = c1.laser_odometry.matching_method
    c2 = with_lo(c1, matching_method=dc.replace(mm, imls=dc.replace(
        mm.imls, use_projected_distance=dc.replace(mm.imls.use_projected_distance,
                                                   enabled=True))))
    b1 = load(ALOAM)
    sv = b1.laser_odometry.solve_method
    c4 = with_lo(b1, solve_method=dc.replace(sv, method="ICP"))
    c5 = with_lo(b1, solve_method=dc.replace(sv, method="Teaser", teaser=dc.replace(
        sv.teaser, use_max_clique=True)))

    def default_with(sample):
        return cfgmod.Config(
            laser_odometry=cfgmod.LaserOdometryConfig(motion_prior=False),
            scan_registration=cfgmod.ScanRegistrationConfig(sample_method=sample),
            sensor=hdl)
    c6 = default_with(cfgmod.SampleConfig(
        method="normal", normal=cfgmod.NormalSampleConfig(sampling_strategy="FPS")))
    c7 = default_with(cfgmod.SampleConfig(
        method="major_axis", major_axis=cfgmod.MajorAxisConfig(sampling_strategy="random")))
    return {"C1": c1, "C2": c2, "C3": load(TENSOR_VOTING, vlp), "C4": c4,
            "C5": c5, "C6": c6, "C7": c7}


def slice_d_configs(cfgmod, root):
    """Phase 9's configs D1-D7 (D4 with undistort on, "D4 off" without)
    built on a config module with the port's config API (plo_tpu_torch.
    config here; tests/reference_ate.py passes plo_tpu.config)."""
    import dataclasses as dc
    hdl = cfgmod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / AZIMUTH_STEPS)
    load = lambda path: cfgmod.load(os.path.join(root, path), sensor=hdl)

    def with_lo(cfg, **kw):
        return dc.replace(cfg, laser_odometry=dc.replace(cfg.laser_odometry, **kw))

    def with_normals(cfg, method):
        sr = cfg.scan_registration
        return dc.replace(cfg, scan_registration=dc.replace(sr, compute_normal_method=dc.replace(
            sr.compute_normal_method, method=method)))

    def map_mode(search):   # tools/bench_map_mode.py's config
        return cfgmod.Config(
            scan_registration=cfgmod.ScanRegistrationConfig(
                compute_normal_method=cfgmod.ComputeNormalConfig(format="range_image",
                                                                 method="pca"),
                presample_method=cfgmod.PresampleConfig(method="geometric_features"),
                sample_method=cfgmod.SampleConfig(
                    method="random", random=cfgmod.RandomSampleConfig(max_points=2000))),
            laser_odometry=cfgmod.LaserOdometryConfig(
                target_mode="map",
                map=cfgmod.MapConfig(voxel_size=0.3, capacity=65536, search=search),
                refresh_correspondences=False,
                matching_method=cfgmod.MatchingConfig(method="IMLS"),
                solve_method=cfgmod.SolveConfig(
                    method="RANSAC", iterations=30,
                    ransac=cfgmod.RANSACConfig(max_iterations=1000, distance_threshold=0.2,
                                               final_solve_method="DRPM"))),
            sensor=hdl)

    b1 = load(ALOAM)
    fals = load(DRPM_RANGE_IMAGE)
    return {"D1": map_mode("dense"), "D2": map_mode("grid_hash"),
            "D3": with_lo(b1, target_mode="map"),
            "D4": with_lo(b1, motion_prior=True, undistort=True),
            "D4 off": with_lo(b1, motion_prior=True, undistort=False),
            "D5": fals, "D6": with_normals(fals, "SRI"),
            "D7": with_normals(b1, "cross_product")}


def make_swept_sequence():
    """Phase 9 D4's frames: phase 3's world and sensor at the motion of
    tests/test_odometry.py's undistortion test (0.8 m and 0.02 rad a frame),
    each point moved as the sensor's sweep saw it (synthetic.distort_sequence).
    At phase 3's 0.5 m and 0.01 rad the sweep's distortion is below the
    trajectory's other errors, and compensating it does not lower plo_tpu's
    own ATE there (PERF.md, Findings)."""
    from plo_tpu_torch.io import synthetic
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    scans, gt = synthetic.synthetic_sequence(N_FRAMES, n_scans=N_SCANS,
                                             azimuth_steps=AZIMUTH_STEPS, speed=0.8,
                                             yaw_rate=0.02, seed=3, world=world)
    return synthetic.distort_sequence(scans, gt, N_SCANS), gt


def make_vlp32_sequence():
    """Phase 7 C3's frames: the corridor sequence on a VLP-32C at 0.2 deg."""
    return make_sequence(32, VLP32_AZIMUTH_STEPS)


def phase_slice_c(dev, scans, gt):
    """Phase 7 (see the module docstring). Returns {path: launch counts}."""
    from plo_tpu_torch import config as cfgmod
    cfgs = slice_c_configs(cfgmod, os.path.dirname(os.path.abspath(__file__)))
    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    frames = N_FRAMES - 1
    expect = {"C1": lambda it: zero, "C2": lambda it: {**zero, "projected_argmin": it},
              "C3": lambda it: zero, "C4": lambda it: {**zero, "nearest": 31 * it},
              "C5": lambda it: {**zero, "nearest": it},
              "C6": lambda it: {**zero, "fps_ranks": N_FRAMES},
              "C7": lambda it: {**zero, "cylinder_stats": frames}}
    vlp32 = make_vlp32_sequence()
    out = {}
    for name, cfg in cfgs.items():
        seq_scans, seq_gt = vlp32 if name == "C3" else (scans, gt)
        out[name] = phase_path(dev, name, cfg, seq_scans, seq_gt, expect[name],
                               jax_ate=JAX_ATE_M[name])
    return out


def _map_runs(dev, name, cfg, scans, gt):
    """Phase 9's D1 or D2: the frames through process_scan (float32), then
    through process_scans(batch=MAP_BATCH) with grid16 (frame 0 alone, the
    rest as one batch); each run's poses finite, ATE below ATE_BOUND_M and
    det(R) of the device world pose within DET_TOLERANCE of 1. Returns (the
    two runs' poses, launch counts)."""
    import numpy as np
    import torch
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.utils import evaluate

    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_nn.reset_launches()
    poses = {}
    for run in ("process_scan", "process_scans"):
        if run == "process_scan":
            odo = Odometry(cfg, capacity=MAP_CAPACITY, seed=0, device=dev, transfer="float32")
            walls = []
            for s in scans:
                t = time.perf_counter()
                odo.process_scan(s)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t))
            timing = "frames " + ", ".join(f"{w:.1f}" for w in walls) + " ms"
        else:
            odo = Odometry(cfg, capacity=MAP_CAPACITY, seed=0, device=dev, async_mode=True,
                           transfer="grid16")
            walls = []
            for part in (scans[:1], scans[1:]):
                t = time.perf_counter()
                odo.process_scans(part, batch=MAP_BATCH)
                odo.sync()
                walls.append(1e3 * (time.perf_counter() - t))
            timing = (f"frame 0 {walls[0]:.1f} ms, frames 2-5 (one batch) {walls[1]:.1f} ms "
                      f"= {walls[1] / (len(scans) - 1):.1f} ms a frame")
        frames = odo.finalize()
        est = odo.poses()
        if not np.isfinite(est).all():
            raise AssertionError(f"{name} {run}: non-finite pose")
        ate = evaluate.ate_rmse(est, gt_rel, align=False)
        det = float(torch.linalg.det(odo._world_dev[:3, :3].double()))
        print(f"  {name} {run}: {timing}; ATE {ate:.4f} m, ICP iterations "
              f"{[f.iterations for f in frames]}, correspondences "
              f"{[f.n_correspondences for f in frames]}, map {int(odo._device_map.valid.sum())} "
              f"points, det(R) - 1 = {det - 1:.2e}", flush=True)
        if not ate < ATE_BOUND_M:
            raise AssertionError(f"{name} {run}: ATE {ate} m >= {ATE_BOUND_M} m")
        if not abs(det - 1.0) < DET_TOLERANCE:
            raise AssertionError(f"{name} {run}: det(R) of the world pose {det}")
        poses[run] = est
        ATES[f"{name} {run}"] = ate
    launches = dict(cuda_nn.LAUNCHES)
    print(f"{name}: launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    if any(launches.values()):
        raise AssertionError(f"{name}: the path launched a kernel: {launches}")
    return poses, launches


def phase_slice_d(dev, scans, gt):
    """Phase 9 (see the module docstring). Returns {path: launch counts}."""
    import numpy as np
    from plo_tpu_torch import bench, config as cfgmod
    cfgs = slice_d_configs(cfgmod, os.path.dirname(os.path.abspath(__file__)))
    if cfgs["D1"] != bench.map_config("dense", N_SCANS, 360.0 / AZIMUTH_STEPS):
        raise AssertionError("D1's config is not bench.map_config('dense')")
    t0 = time.perf_counter()
    out = {}
    poses = {}
    for name in ("D1", "D2"):
        poses[name], out[name] = _map_runs(dev, name, cfgs[name], scans, gt)
    for run in poses["D1"]:
        dt = np.linalg.norm(poses["D2"][run][:, :3, 3] - poses["D1"][run][:, :3, 3], axis=1)
        print(f"D2 {run}: positions within {dt.max():.2e} m of D1's", flush=True)
        if not dt.max() < MAP_GRID_HASH_M:
            raise AssertionError(f"D2 {run}: grid_hash positions {dt.max()} m from dense")
    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    per_iteration = lambda it: {**zero, "nearest": it}
    swept = make_swept_sequence()
    for name in ("D3", "D4", "D4 off", "D5", "D6", "D7"):
        seq_scans, seq_gt = swept if name.startswith("D4") else (scans, gt)
        out[name] = phase_path(dev, name, cfgs[name], seq_scans, seq_gt, per_iteration,
                               jax_ate=JAX_ATE_M.get(name))
    print(f"D4: ATE {ATES['D4']:.4f} m with undistortion, {ATES['D4 off']:.4f} m without",
          flush=True)
    if not ATES["D4"] < ATES["D4 off"]:
        raise AssertionError("D4: undistortion did not lower the ATE")
    print(f"slice D: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def slice_e_configs(cfgmod, root):
    """Phase 10's configs built on a config module with the port's config
    API (plo_tpu_torch.config here; tests/reference_ate.py passes
    plo_tpu.config): "E1 off" / "E1 on", tests/test_ba.py's BA rescue config
    with BA off and on; E2, its _ba_cfg; E3, configs/aloam_kitti00.json with
    BA on (window 4); E4, tests/test_loopclosure.py's headline-like config;
    "E5 DRPM" / "E5 WLS", tests/test_planetary.py's config with each final
    solve."""
    import dataclasses as dc
    small = cfgmod.SensorConfig(n_scans=32, azimuth_resolution=360.0 / SMALL_AZIMUTH_STEPS)

    def ransac(max_iterations=300, final="DRPM"):
        return cfgmod.SolveConfig(method="RANSAC", iterations=30, ransac=cfgmod.RANSACConfig(
            max_iterations=max_iterations, distance_threshold=0.2, final_solve_method=final))

    def random_imls(max_points, solve=None, **lo):
        return cfgmod.Config(
            scan_registration=cfgmod.ScanRegistrationConfig(sample_method=cfgmod.SampleConfig(
                method="random", random=cfgmod.RandomSampleConfig(max_points=max_points))),
            laser_odometry=cfgmod.LaserOdometryConfig(
                matching_method=cfgmod.MatchingConfig(method="IMLS"),
                solve_method=solve or ransac(), **lo),
            sensor=small)

    def ba(on, max_correspondences):
        return cfgmod.BAConfig(enabled=on, window=BA_WINDOW, iterations=4,
                               max_correspondences=max_correspondences)

    b1 = cfgmod.load(os.path.join(root, ALOAM), sensor=cfgmod.SensorConfig(
        n_scans=N_SCANS, azimuth_resolution=360.0 / AZIMUTH_STEPS))
    lo = b1.laser_odometry
    loop = cfgmod.Config(
        scan_registration=cfgmod.ScanRegistrationConfig(
            compute_normal_method=cfgmod.ComputeNormalConfig(format="range_image", method="pca"),
            presample_method=cfgmod.PresampleConfig(method="geometric_features"),
            sample_method=cfgmod.SampleConfig(
                method="random", random=cfgmod.RandomSampleConfig(max_points=2000))),
        laser_odometry=cfgmod.LaserOdometryConfig(
            refresh_correspondences=False, matching_method=cfgmod.MatchingConfig(method="IMLS"),
            solve_method=ransac(1000)),
        sensor=small)
    return {"E1 off": random_imls(1500, motion_prior=False, ba=ba(False, 600)),
            "E1 on": random_imls(1500, motion_prior=False, ba=ba(True, 600)),
            "E2": random_imls(1200, ba=ba(True, 512)),
            "E3": dc.replace(b1, laser_odometry=dc.replace(
                lo, ba=dc.replace(lo.ba, enabled=True, window=BA_WINDOW))),
            "E4": loop,
            "E5 DRPM": random_imls(1500, ransac(final="DRPM")),
            "E5 WLS": random_imls(1500, ransac(final="Weighted LS"))}


def slice_e_sequence(name, workers=1):
    """Phase 10's frames, at 32 x 450 (E3 runs phase 3's own): E1 the
    corridor at 1 m and 0.005 rad a frame, 12 frames (tests/test_ba.py's
    rescue); E2 the corridor at 0.5 m and 0.01 rad, 10 frames; E4 the
    136-frame rectangle loop of tests/test_loopclosure.py around its own
    world; E5 the planetary world at 0.5 m a frame, 8 frames, and "E5
    corridor" 2 corridor frames at that motion, the structure-rich contrast
    of tests/test_planetary.py. Returns (scans, ground truth)."""
    from plo_tpu_torch.io import synthetic
    small = dict(n_scans=32, azimuth_steps=SMALL_AZIMUTH_STEPS, workers=workers)
    corridor = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    if name == "E1":
        return synthetic.synthetic_sequence(12, speed=1.0, yaw_rate=0.005, seed=11,
                                            world=corridor, **small)
    if name == "E2":
        return synthetic.synthetic_sequence(10, speed=0.5, yaw_rate=0.01, seed=3,
                                            world=corridor, **small)
    if name == "E4":
        speeds, yaw_rates = synthetic.rectangle_loop_profile(n_straight=10, n_turn=24, speed=1.0)
        return synthetic.synthetic_sequence(len(speeds), speed=speeds, yaw_rate=yaw_rates,
                                            seed=23, **small)
    if name == "E5":
        return synthetic.synthetic_sequence(
            8, speed=0.5, yaw_rate=0.0, seed=3,
            world=synthetic.SyntheticWorld.planetary(seed=5, n_rocks=8, extent=50.0), **small)
    if name == "E5 corridor":
        return synthetic.synthetic_sequence(2, speed=0.5, yaw_rate=0.0, seed=3, world=corridor,
                                            **small)
    raise ValueError(name)


def relative_gt(gt):
    """Ground-truth poses relative to the first."""
    import numpy as np
    return np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)


def _frames(dev, name, odo, scans):
    """The scans through odo.process_scan, each timed on the host clock up
    to a synchronize; prints and returns the frame times (ms)."""
    import numpy as np
    import torch
    ms = []
    for s in scans:
        t = time.perf_counter()
        odo.process_scan(s)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t))
    frames = odo.finalize()
    if not np.isfinite(odo.poses()).all():
        raise AssertionError(f"{name}: non-finite pose")
    print(f"  {name}: frames {', '.join(f'{m:.1f}' for m in ms)} ms, ICP iterations "
          f"{[f.iterations for f in frames]}, every pose finite", flush=True)
    return ms


def _batched(dev, name, odo, scans, batch):
    """The scans through odo.process_scans(batch) (frame 0 alone, then the
    batches); prints the wall time and returns it (ms)."""
    import numpy as np
    import torch
    t = time.perf_counter()
    odo.process_scans(scans, batch=batch)
    frames = odo.finalize()
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t)
    if not np.isfinite(odo.poses()).all():
        raise AssertionError(f"{name}: non-finite pose")
    print(f"  {name}: {len(scans)} frames in {ms:.1f} ms through process_scans(batch={batch}), "
          f"ICP iterations {[f.iterations for f in frames]}, every pose finite", flush=True)
    return ms


def _no_launch(name, zero):
    """Fails where a path that reaches none of the kernels launched one."""
    from plo_tpu_torch.ops import cuda_nn
    launches = dict(cuda_nn.LAUNCHES)
    if launches != zero:
        raise AssertionError(f"{name}: the path launched a kernel: {launches}")
    return launches


def _ate(est, gt):
    from plo_tpu_torch.utils import evaluate
    return evaluate.ate_rmse(est, relative_gt(gt), align=False)


def phase_slice_e(dev, scans, gt):
    """Phase 10 (see the module docstring). Returns {path: launch counts}."""
    import numpy as np
    import torch
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.models.loopclosure import close_loops
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.parallel import ba as ba_ops

    cfgs = slice_e_configs(cfgmod, os.path.dirname(os.path.abspath(__file__)))
    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    t0 = time.perf_counter()
    out = {}

    # E1: BA rescues the identity-init regime at 1 m a frame.
    e1_scans, e1_gt = slice_e_sequence("E1", workers=8)
    ate = {}
    for key in ("E1 off", "E1 on"):
        odo = Odometry(cfgs[key], capacity=BA_CAPACITY, seed=0, device=dev)
        torch.cuda.synchronize(dev)
        cuda_nn.reset_launches()
        _frames(dev, key, odo, e1_scans)
        out[key] = _no_launch(key, zero)
        ate[key] = _ate(odo.poses(), e1_gt)
    window = odo.ba_window(odo.frame_count - 1)
    refine = lambda: ba_ops.refine_window(*window[1])
    refine_ms, refine_call_ms = cuda_ms(refine), call_ms(refine)
    print(f"E1: ATE {ate['E1 off']:.4f} m with BA off, {ate['E1 on']:.4f} m with BA on "
          f"(plo_tpu on the CPU: {JAX_E['E1 off']:.4f}, {JAX_E['E1 on']:.4f}); refine_window "
          f"(window {BA_WINDOW}, 5 pairs x {window[1][1].shape[1]} correspondences, "
          f"{cfgs['E1 on'].laser_odometry.ba.iterations} Gauss-Newton steps) {refine_ms:.3f} ms "
          f"device time, {refine_call_ms:.3f} ms one call", flush=True)
    if not ate["E1 on"] * 2.0 < ate["E1 off"]:
        raise AssertionError(f"E1: BA did not halve the ATE: {ate}")

    # E2: the batched driver records in its loop and refines at the drain.
    e2_scans, e2_gt = slice_e_sequence("E2", workers=8)
    cuda_nn.reset_launches()
    per_frame = Odometry(cfgs["E2"], capacity=BA_CAPACITY, seed=0, device=dev)
    _frames(dev, "E2 per frame", per_frame, e2_scans)
    _no_launch("E2 per frame", zero)
    cuda_nn.reset_launches()
    batched = Odometry(cfgs["E2"], capacity=BA_CAPACITY, seed=0, device=dev, async_mode=True)
    _batched(dev, "E2 batched", batched, e2_scans, BA_BATCH)
    out["E2"] = _no_launch("E2", zero)
    p_pf, p_b = per_frame.poses(), batched.poses()
    gap = float(np.linalg.norm(p_b[:, :3, 3] - p_pf[:, :3, 3], axis=1).max())
    ate_pf, ate_b = _ate(p_pf, e2_gt), _ate(p_b, e2_gt)
    print(f"E2: ATE {ate_pf:.4f} m per frame, {ate_b:.4f} m batched, positions within "
          f"{gap:.4f} m (plo_tpu: {JAX_E['E2']:.4f}, {JAX_E['E2 batched']:.4f}, "
          f"{JAX_E['E2 gap']:.4f})", flush=True)
    if not (gap < BA_GAP_M and ate_b < max(2 * ate_pf, BA_GAP_M)):
        raise AssertionError(f"E2: batched BA {gap} m from per frame, ATE {ate_b} / {ate_pf}")

    # E3: B1 with BA: nearest in the ICP loop and in the recorder, one match
    # for the consecutive record from frame 2 on and one for the skip record
    # from frame 3 on.
    records = (N_FRAMES - 1) + (N_FRAMES - 2)
    out["E3"] = phase_path(dev, "E3", cfgs["E3"], scans, gt,
                           lambda it: {**zero, "nearest": it + records},
                           jax_ate=JAX_E["E3"])

    # E4: odometry around the rectangle loop, then loop closure.
    e4_scans, e4_gt = slice_e_sequence("E4", workers=8)
    gtr = relative_gt(e4_gt)
    cuda_nn.reset_launches()
    odo = Odometry(cfgs["E4"], capacity=LOOP_CAPACITY, seed=0, device=dev, async_mode=True)
    odo_ms = _batched(dev, "E4 odometry", odo, e4_scans, LOOP_BATCH)
    poses = odo.poses()
    t = time.perf_counter()
    fixed, edges = close_loops(cfgs["E4"], e4_scans, poses, min_gap=LOOP_MIN_GAP,
                               radius=LOOP_RADIUS, capacity=LOOP_CAPACITY, device=dev)
    loop_s = time.perf_counter() - t
    out["E4"] = _no_launch("E4", zero)
    end = lambda p: float(np.linalg.norm(p[-1, :3, 3] - gtr[-1, :3, 3]))
    ate_before, ate_after = _ate(poses, e4_gt), _ate(fixed, e4_gt)
    print(f"E4: odometry {odo_ms / 1e3:.2f} s for {len(e4_scans)} frames, close_loops "
          f"{loop_s:.2f} s; edges {[(i, j, n) for i, j, _, n in edges]}; ATE {ate_before:.4f} -> "
          f"{ate_after:.4f} m, endpoint {end(poses):.4f} -> {end(fixed):.4f} m (plo_tpu: edges "
          f"{JAX_E['E4 edges']}, ATE {JAX_E['E4 before']:.4f} -> {JAX_E['E4 after']:.4f}, "
          f"endpoint {JAX_E['E4 end before']:.4f} -> {JAX_E['E4 end after']:.4f})", flush=True)
    if not edges:
        raise AssertionError("E4: no loop edge on the closed course")
    if not (end(fixed) < end(poses) / 3 and ate_after < 0.7 * ate_before):
        raise AssertionError(f"E4: loop closure did not correct the drift: ATE {ate_before} -> "
                             f"{ate_after}, endpoint {end(poses)} -> {end(fixed)}")
    if not np.array_equal(fixed[0], poses[0]):
        raise AssertionError("E4: loop closure moved pose 0")

    # E5: the planetary world, DRPM against Weighted LS.
    out.update(phase_planetary(dev, cfgs, zero))
    print(f"slice E: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_planetary(dev, cfgs, zero):
    """Phase 10's E5: tests/test_planetary.py's three claims on the card.
    Returns {path: launch counts}."""
    import numpy as np
    import torch
    from plo_tpu_torch.models.odometry import (GeneratorDraws, Odometry, match_once,
                                               prepare_target)
    from plo_tpu_torch.models.pipeline import FrontEnd
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.solvers.drpm import solve_drpm

    e5_scans, e5_gt = slice_e_sequence("E5", workers=8)
    gtr = relative_gt(e5_gt)
    probs = [f"drpm_prob_{i}" for i in range(6)]
    thr = cfgs["E5 DRPM"].laser_odometry.solve_method.ransac.drpm_threshold
    cuda_nn.reset_launches()
    runs = {}
    for key in ("E5 DRPM", "E5 WLS"):
        runs[key] = Odometry(cfgs[key], capacity=BA_CAPACITY, seed=0, device=dev)
        _frames(dev, key, runs[key], e5_scans)
    batched = Odometry(cfgs["E5 DRPM"], capacity=BA_CAPACITY, seed=0, device=dev,
                       async_mode=True)
    _batched(dev, "E5 DRPM batched", batched, e5_scans, BA_BATCH)

    def min_prob(scans):
        """tests/test_planetary.py's min_prob_on: frame 2 matched against
        frame 1, the least DRPM probability of one solve."""
        cfg = cfgs["E5 DRPM"]
        r = cfg.laser_odometry.solve_method.ransac
        fe = FrontEnd(cfg, capacity=BA_CAPACITY, device=dev)
        draws = GeneratorDraws(torch.Generator(device=dev).manual_seed(0), dev)
        prev = fe.process(scans[0], draws.frontend(fe.n_draws(True), fe.filtered_capacity),
                          None, True)
        cur = fe.process(scans[1], draws.frontend(fe.n_draws(False), fe.filtered_capacity),
                         prev.filtered, False)
        tgt_n, tgt_ok = prepare_target(cfg, prev.filtered, False)
        res = match_once(cfg, cur.flat, prev.filtered, tgt_n, tgt_ok)
        w = res.valid.to(torch.float32)
        w = w / w.sum().clamp_min(1.0)
        return float(solve_drpm(cur.flat.xyz, res.y, res.normal, res.valid, w, r.drpm_threshold,
                                r.drpm_stdev_points, r.drpm_stdev_normals)[2].min())

    p_flat, p_rich = min_prob(e5_scans), min_prob(slice_e_sequence("E5 corridor")[0])
    launches = _no_launch("E5", zero)
    est = {k: o.poses() for k, o in runs.items()}
    cross = {k: float(np.abs(p[:, 1, 3] - gtr[:, 1, 3]).max()) for k, p in est.items()}
    ate = {k: _ate(p, e5_gt) for k, p in est.items()}
    min_pf = min(min(f.stats[k] for k in probs) for f in runs["E5 DRPM"].trajectory[1:])
    min_b = min(min(f.stats[k] for k in probs) for f in batched.trajectory[1:])
    first_ones = all(runs["E5 DRPM"].trajectory[0].stats[k] == 1.0 for k in probs)
    end_drpm = float(np.linalg.norm(est["E5 DRPM"][-1, :3, 3] - gtr[-1, :3, 3]))
    total = float(np.linalg.norm(gtr[-1, :3, 3]))
    print(f"E5: ATE DRPM {ate['E5 DRPM']:.4f} m, WLS {ate['E5 WLS']:.4f} m; cross-track DRPM "
          f"{cross['E5 DRPM']:.3g} m, WLS {cross['E5 WLS']:.3f} m; least DRPM probability "
          f"{min_pf:.3g} per frame, {min_b:.3g} batched (threshold {thr}); SNR probe "
          f"{p_flat:.3g} planetary, {p_rich:.4f} corridor (plo_tpu: ATE {JAX_E['E5 DRPM']:.4f} / "
          f"{JAX_E['E5 WLS']:.4f}, cross-track {JAX_E['E5 cross DRPM']:.3g} / "
          f"{JAX_E['E5 cross WLS']:.3f}, SNR {JAX_E['E5 snr planetary']} / "
          f"{JAX_E['E5 snr corridor']:.4f})", flush=True)
    claims = {
        "WLS hallucinates lateral motion": cross["E5 WLS"] > 1.0,
        "DRPM holds still": cross["E5 DRPM"] < 0.10 and ate["E5 DRPM"] < 0.7 * ate["E5 WLS"]
        and end_drpm <= total + 0.1,
        "DRPM probabilities in the stats": first_ones and min_pf < thr and min_b < thr,
        "the SNR branch is scene-driven": p_flat < thr < p_rich,
    }
    failed = [c for c, ok in claims.items() if not ok]
    if failed:
        raise AssertionError(f"E5: claims failed: {failed}")
    return {"E5": launches}


def phase_matrix(dev):
    """Phase 8: the 36 combinations of plo_tpu_torch.method_matrix on the card."""
    from plo_tpu_torch import method_matrix
    t0 = time.perf_counter()
    rows = method_matrix.run_matrix(dev, MATRIX_FRAMES, MATRIX_ATE_M)
    fail = method_matrix.report(rows, MATRIX_FRAMES, MATRIX_ATE_M)
    print(f"matrix: {time.perf_counter() - t0:.1f} s for {len(rows)} combinations", flush=True)
    if fail:
        raise AssertionError(f"matrix: {fail} of {len(rows)} combinations did not converge")


def kitti_drill(synthetic, root, workers=1):
    """tests/test_kitti_density.py's sequence: 4 frames of the corridor world
    (seed 7, 140 boxes, 150 m) at HDL-64 x 1900, 1.0 m and 0.005 rad a frame,
    scan seed 3, written in the KITTI layout under `root` with
    `synthetic.write_kitti_layout` (tests/reference_ate.py passes the same
    module). Returns the scans' point counts."""
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=150.0)
    scans, gt = synthetic.synthetic_sequence(KITTI_FRAMES, n_scans=N_SCANS,
                                             azimuth_steps=KITTI_AZIMUTH_STEPS, speed=1.0,
                                             yaw_rate=0.005, seed=3, world=world,
                                             **({"workers": workers} if workers > 1 else {}))
    synthetic.write_kitti_layout(root, scans, gt)
    return [len(s) for s in scans]


def cli_argv(name, root, out):
    """Phase 11's command lines of plo_tpu_torch.cli (plo_tpu.cli takes the
    same): F1 the KITTI-density drill of tests/test_kitti_density.py (its
    JSON config written to <root>/cfg.json, the layout under `root`) with
    artifacts and a checkpoint every 2 frames; "F2 first" its first 2
    frames, checkpointed; "F2 resume" the last 2 from that checkpoint
    (<root>/f2/ckpt.npz); F3 the CLI's own synthetic sequence at its
    defaults."""
    if name == "F3":
        return ["--dataset", "synthetic", "--frames", str(CLI_FRAMES), "--eval-gt",
                "--output", out]
    cfg = os.path.join(root, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({
            "scan_registration": {
                "compute_normal_method": {"format": "pointcloud", "method": "pca"},
                "presample_method": {"method": "geometric_features"},
                "sample_method": {"method": "random", "random": {"max_points": ICP_QUERIES}},
            },
            "laser_odometry": {
                "matching_method": {"method": "plane_ICP"},
                "solve_method": {"method": "LS", "iterations": 30},
                "motion_prior": True,
            },
        }, f)
    base = ["--config", cfg, "--dataset", "kitti", "--kitti-root", root, "--seq", "00",
            "--capacity", str(CAPACITY), "--azimuth-resolution", str(360.0 / KITTI_AZIMUTH_STEPS),
            "--output", out, "--eval-gt"]
    if name == "F1":
        return base + ["--frames", str(KITTI_FRAMES), "--save-artifacts",
                       "--checkpoint-every", str(CKPT_EVERY)]
    if name == "F2 first":
        return base + ["--frames", str(CKPT_EVERY), "--checkpoint-every", str(CKPT_EVERY)]
    if name == "F2 resume":
        return base + ["--resume", os.path.join(root, "f2", "ckpt.npz"), "--start",
                       str(CKPT_EVERY), "--frames", str(KITTI_FRAMES - CKPT_EVERY)]
    raise ValueError(name)


def _cli_run(name, argv):
    """One in-process run of plo_tpu_torch.cli.main(argv) on the card, with
    every launch count set to 0 just before and read just after. Echoes the
    CLI's stdout lines prefixed with `name`. Returns (launches, the eval JSON
    or None, the truncation warnings, seconds)."""
    import contextlib
    import io
    import warnings
    import torch
    from plo_tpu_torch import cli
    from plo_tpu_torch.ops import cuda_nn
    torch.cuda.synchronize()
    cuda_nn.reset_launches()
    buf = io.StringIO()
    t = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(buf):
        warnings.simplefilter("always")
        rc = cli.main(argv)
    seconds = time.perf_counter() - t
    launches = dict(cuda_nn.LAUNCHES)
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  {name}: {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"{name}: the CLI returned {rc}")
    evals = [json.loads(line) for line in lines if line.startswith("{")]
    truncated = [str(w.message) for w in caught if "exceeds capacity" in str(w.message)]
    return launches, (evals[-1] if evals else None), truncated, seconds


def _table(path, columns):
    """The rows of a whitespace-separated text file, each of `columns`
    values."""
    import numpy as np
    with open(path) as f:
        rows = [line.split() for line in f.read().splitlines()]
    if not rows or any(len(r) != columns for r in rows):
        raise AssertionError(f"{path}: not rows of {columns} columns")
    return np.array(rows, dtype=np.float64)


def _iterations(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["iterations"] for line in f]


class _SaverClock:
    """Wraps the saver's writers so the seconds they take are summed."""

    def __init__(self):
        from plo_tpu_torch.utils import saver
        self.saver, self.seconds, self.saved = saver, 0.0, {}
        for name in ("save_point_cloud_txt", "save_normal_markers_obj", "save_pose_tum",
                     "save_matched_points"):
            self.saved[name] = getattr(saver, name)
            setattr(saver, name, self._timed(self.saved[name]))

    def _timed(self, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t
        return timed

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.saver, name, fn)


def phase_cli(dev):
    """Phase 11 (see the module docstring). Returns {path: launch counts}."""
    import shutil
    import tempfile
    import numpy as np
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch import native
    from plo_tpu_torch.io import synthetic
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.utils import DeviceTrace

    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="plo_cli_")
    out = {}
    try:
        counts = kitti_drill(synthetic, root, workers=8)
        print(f"F1 sequence: {KITTI_FRAMES} scans of {counts} points written in the KITTI "
              f"layout in {time.perf_counter() - t0:.1f} s", flush=True)
        if min(counts) <= KITTI_MIN_POINTS or max(counts) > CAPACITY:
            raise AssertionError(f"F1: scans of {counts} points, not KITTI-class within "
                                 f"{CAPACITY}")
        vdir = os.path.join(root, "sequences", "00", "velodyne")
        paths = [os.path.join(vdir, f) for f in sorted(os.listdir(vdir))]
        native.library()
        t = time.perf_counter()
        pf = native.ScanPrefetcher(paths, CAPACITY)
        read = [n for _, n in pf]
        pf.close()
        print(f"prefetcher: {1e3 * (time.perf_counter() - t) / len(paths):.2f} ms a scan "
              f"({len(paths)} .bin files of {read} points, read and padded to {CAPACITY})",
              flush=True)

        # F1: the KITTI-density drill with artifacts and checkpoints.
        f1 = os.path.join(root, "f1")
        clock = _SaverClock()
        try:
            launches, ev, truncated, secs = _cli_run("F1", cli_argv("F1", root, f1))
        finally:
            clock.restore()
        it = _iterations(f1)
        artifacts = [os.path.join(d, f) for d, _, fs in os.walk(f1) for f in fs
                     if not f.endswith((".npz", ".jsonl")) and f not in
                     ("trajectory_tum.txt", "odometry_times.txt")]
        size = sum(os.path.getsize(p) for p in artifacts)
        print(f"F1: {secs:.1f} s, eval {json.dumps(ev)} (plo_tpu's ATE on the CPU: "
              f"{JAX_F['F1']:.4f} m), ICP iterations {it}, launches {launches}; artifacts "
              f"{len(artifacts)} files, {size / 2**20:.1f} MiB, written in "
              f"{clock.seconds:.2f} s", flush=True)
        out["F1"] = launches
        if truncated:
            raise AssertionError(f"F1: truncation: {truncated}")
        if launches != {**zero, "nearest": sum(it[1:])}:
            raise AssertionError(f"F1: launches {launches}, ICP iterations {it}")
        for rel, cols in (("pcl_cloud/000000.txt", 8), ("imls_results.txt", 8),
                          ("matched_points/f000001_i00.txt", 6), ("iter_poses.txt", 8),
                          ("trajectory_tum.txt", 8)):
            _table(os.path.join(f1, rel), cols)
        with open(os.path.join(f1, "pca_markers", "000000.obj")) as f:
            obj = f.read().splitlines()
        if not obj or {line.split()[0] for line in obj} != {"v", "l"}:
            raise AssertionError("F1: pca_markers/000000.obj holds no OBJ v/l records")
        f1_tum = _table(os.path.join(f1, "trajectory_tum.txt"), 8)
        if len(f1_tum) != KITTI_FRAMES or not np.isfinite(f1_tum).all():
            raise AssertionError(f"F1: trajectory of {len(f1_tum)} rows, or not finite")
        if not ev["ate_m"] < KITTI_ATE_BOUND_M:
            raise AssertionError(f"F1: ATE {ev['ate_m']} m >= {KITTI_ATE_BOUND_M} m")

        # F2: the first 2 frames checkpointed, the last 2 resumed.
        f2 = os.path.join(root, "f2")
        l_first, _, _, s_first = _cli_run("F2 first", cli_argv("F2 first", root, f2))
        f2r = os.path.join(root, "f2r")
        l_resume, _, _, s_resume = _cli_run("F2 resume", cli_argv("F2 resume", root, f2r))
        resumed = _table(os.path.join(f2r, "trajectory_tum.txt"), 8)
        gap = float(np.linalg.norm(resumed[:, 1:4] - f1_tum[CKPT_EVERY:, 1:4], axis=1).max())
        it2 = _iterations(f2)[1:] + _iterations(f2r)
        out["F2"] = {k: l_first[k] + l_resume[k] for k in zero}
        print(f"F2: {s_first:.1f} s + {s_resume:.1f} s; the resumed positions within {gap:.3g} m "
              f"of F1's frames {CKPT_EVERY}-{KITTI_FRAMES - 1}; ICP iterations {it2}, "
              f"launches {out['F2']}", flush=True)
        if not (len(resumed) == KITTI_FRAMES - CKPT_EVERY and gap < RESUME_GAP_M):
            raise AssertionError(f"F2: {len(resumed)} resumed frames, {gap} m from F1's")
        if out["F2"] != {**zero, "nearest": sum(it2)}:
            raise AssertionError(f"F2: launches {out['F2']}, ICP iterations {it2}")

        # F3: the CLI's own defaults on its synthetic sequence.
        f3 = os.path.join(root, "f3")
        launches, ev, _, secs = _cli_run("F3", cli_argv("F3", root, f3))
        tum = _table(os.path.join(f3, "trajectory_tum.txt"), 8)
        gated = JAX_F["F3"] < JAX_ATE_GATE_M
        print(f"F3: {secs:.1f} s, eval {json.dumps(ev)} (plo_tpu's ATE on the CPU: "
              f"{JAX_F['F3']:.4f} m; {'bound ' + str(ATE_BOUND_M) + ' m' if gated else 'capability only'}), "
              f"ICP iterations {_iterations(f3)}, launches {launches}", flush=True)
        out["F3"] = launches
        if launches != {**zero, "cylinder_stats": CLI_FRAMES - 1, "fps_ranks": CLI_FRAMES - 1}:
            raise AssertionError(f"F3: launches {launches}")
        if len(tum) != CLI_FRAMES or not np.isfinite(tum).all():
            raise AssertionError(f"F3: trajectory of {len(tum)} rows, or not finite")
        if gated and not ev["ate_m"] < ATE_BOUND_M:
            raise AssertionError(f"F3: ATE {ev['ate_m']} m >= {ATE_BOUND_M} m")
        with open(os.path.join(f3, "metrics.jsonl")) as f:
            corr = [json.loads(line)["correspondences"] for line in f]
        if not gated and min(corr[1:]) <= 0:
            raise AssertionError(f"F3: an ICP frame found no correspondence: {corr}")

        # A DeviceTrace of one F1 frame holds the nearest kernel's device event.
        sensor = cfgmod.SensorConfig(n_scans=N_SCANS, azimuth_resolution=360.0 / KITTI_AZIMUTH_STEPS)
        odo = Odometry(cfgmod.load(os.path.join(root, "cfg.json"), sensor=sensor),
                       capacity=CAPACITY, seed=0, device=dev)
        scans = [native.load_bin_padded(p, CAPACITY) for p in paths]
        odo.process_scan(scans[0][0][:scans[0][1]])
        for attempt, (scan, n) in enumerate(scans[1:3]):
            trace_dir = os.path.join(root, f"trace{attempt}")
            with DeviceTrace(trace_dir) as tr:
                odo.process_scan(scan[:n])
            with open(tr.path) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            hits = [e for e in kernels if "nearest_kernel" in e.get("name", "")]
            print(f"DeviceTrace: {tr.path} ({os.path.getsize(tr.path) / 2**20:.1f} MiB), "
                  f"{len(kernels)} kernel events, {len(hits)} of nearest_kernel "
                  f"({sum(e.get('dur', 0) for e in hits) / 1e3:.3f} ms)", flush=True)
            if hits:
                break
        else:
            raise AssertionError("DeviceTrace: no nearest_kernel device event in two traces")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def multidevice_sequence(workers=8):
    """Phase 12 G1's frames: phase 3's world and motion (make_sequence), for
    G_FRAMES frames."""
    from plo_tpu_torch.io import synthetic
    world = synthetic.SyntheticWorld.corridor(seed=7, n_boxes=140, extent=60.0)
    return synthetic.synthetic_sequence(G_FRAMES, n_scans=N_SCANS, azimuth_steps=AZIMUTH_STEPS,
                                        speed=0.5, yaw_rate=0.01, seed=3, world=world,
                                        workers=workers)


def _sharded_frames(dev, name, sodo, scans, save=None):
    """The scans through sodo.process_scan, each timed up to a synchronize;
    with save=(after, path), save_sharded after frame `after`. Prints the
    frame times; returns the poses."""
    import numpy as np
    import torch
    from plo_tpu_torch.utils import checkpoint
    ms = []
    for s in scans:
        t = time.perf_counter()
        f = sodo.process_scan(s)
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t))
        if save is not None and f.index == save[0]:
            checkpoint.save_sharded(sodo, save[1])
    poses = sodo.poses()
    if not np.isfinite(poses).all():
        raise AssertionError(f"{name}: non-finite pose")
    print(f"  {name}: frames {', '.join(f'{m:.1f}' for m in ms)} ms, ICP iterations "
          f"{[f.iterations for f in sodo.trajectory]}", flush=True)
    return poses


def phase_sharded_map(dev, tmp):
    """Phase 12 G1 and G4 (see the module docstring). Returns (G1's scans, its
    config, the per-frame sharded poses, G1's launch counts)."""
    import numpy as np
    import torch
    from plo_tpu_torch import bench
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.parallel import get_mesh
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry
    from plo_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    scans, gt = multidevice_sequence()
    print(f"G1 sequence: {len(scans)} scans generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = bench.map_config("dense", N_SCANS, 360.0 / AZIMUTH_STEPS)
    mesh = get_mesh(SHARDS, device=dev)
    zero = {k: 0 for k in cuda_nn.LAUNCHES}
    torch.cuda.synchronize(dev)
    cuda_nn.reset_launches()
    single = Odometry(cfg, capacity=MAP_CAPACITY, seed=0, device=dev, transfer="float32")
    _frames(dev, "G1 single device", single, scans)
    _no_launch("G1 single device", zero)
    path = os.path.join(tmp, "g4.npz")
    cuda_nn.reset_launches()
    sodo = ShardedMapOdometry(cfg, mesh, capacity=MAP_CAPACITY, seed=0)
    per_frame = _sharded_frames(dev, "G1 8 shards per frame", sodo, scans, (G_SAVE_AFTER, path))
    batched = ShardedMapOdometry(cfg, mesh, capacity=MAP_CAPACITY, seed=0, defer_fetch=True)
    t = time.perf_counter()
    batched.process_scans(scans, batch=G_BATCH)
    batched.sync()
    batch_ms = 1e3 * (time.perf_counter() - t)
    launches = _no_launch("G1", zero)
    p1, pb = single.poses(), batched.poses()
    gap = float(np.linalg.norm(per_frame[:, :3, 3] - p1[:, :3, 3], axis=1).max())
    ate_s, ate_1 = _ate(per_frame, gt), _ate(p1, gt)
    total = int(sodo.store.global_cloud().valid.sum())
    per_device = sodo.map_points_per_device()
    print(f"G1: batched {batch_ms:.1f} ms for {len(scans)} frames (frame 0, then batches of "
          f"{G_BATCH}), poses {'equal to' if np.array_equal(pb, per_frame) else 'DIFFER from'} "
          f"per frame; positions within {gap:.2e} m of the single device, ATE {ate_s:.4f} m "
          f"sharded, {ate_1:.4f} m single device; map {total} points, at most {per_device} a "
          f"shard (bound {max(2 * total // SHARDS, 1024)}), "
          f"single device {int(single._device_map.valid.sum())}; launches {launches}", flush=True)
    if not np.array_equal(pb, per_frame):
        raise AssertionError("G1: batched sharded poses differ from per frame")
    if not (gap < G_SINGLE_GAP_M and abs(ate_s - ate_1) < G_ATE_GAP_M and ate_s < ATE_BOUND_M):
        raise AssertionError(f"G1: gap {gap} m, ATE {ate_s} against {ate_1} m")
    if not per_device < max(2 * total // SHARDS, 1024):
        raise AssertionError(f"G1: a shard holds {per_device} of {total} map points")

    # G4: resume on 8 shards and, elastic, on 4.
    for n, bound in ((SHARDS, G_RESUME_M), (SHARDS // 2, G_ELASTIC_M)):
        res = ShardedMapOdometry(cfg, get_mesh(n, device=dev), capacity=MAP_CAPACITY, seed=0)
        checkpoint.load_sharded(res, path)
        cuda_nn.reset_launches()
        resumed = _sharded_frames(dev, f"G4 {n} shards", res, scans[G_SAVE_AFTER + 1:])
        _no_launch("G4", zero)
        d = float(np.linalg.norm(resumed[:, :3, 3] - per_frame[G_SAVE_AFTER + 1:, :3, 3],
                                 axis=1).max())
        print(f"G4: saved after frame {G_SAVE_AFTER + 1} of {len(scans)}, resumed on {n} shards "
              f"({res.store.per_shard} rows a shard): positions within {d:.2e} m of the "
              f"uninterrupted run (bound {bound} m)", flush=True)
        if not d < bound:
            raise AssertionError(f"G4: resumed on {n} shards {d} m from the uninterrupted run")
    return scans, cfg, per_frame, launches


def phase_sharded_icp(dev, scans):
    """Phase 12 G2 (see the module docstring). Returns the launch counts of
    the 8-shard step."""
    import numpy as np
    import torch
    from plo_tpu_torch.models.odometry import GeneratorDraws, icp_loop
    from plo_tpu_torch.models.pipeline import FrontEnd
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.parallel import sharding

    _, b1, _ = configs()
    fe = FrontEnd(b1, capacity=CAPACITY, device=dev)
    # One generator for the front-end; each ICP run its own of one seed a
    # frame, so the single-device and sharded runs draw the same numbers.
    draws = GeneratorDraws(torch.Generator(device=dev).manual_seed(0), dev)
    icp_draws = lambda k: GeneratorDraws(torch.Generator(device=dev).manual_seed(k), dev)
    steps = {"8 shards": sharding.make_sharded_icp_step(b1, sharding.get_mesh(SHARDS, device=dev)),
             "2 x 4": sharding.make_sharded_icp_step_2d(
                 b1, sharding.get_mesh_2d(2, SHARDS // 2, device=dev))}
    calls = []
    real = cuda_nn.nearest

    def recording(query, target, valid, radius=float("inf")):
        out = real(query, target, valid, radius)
        calls.append(((query, target, valid, radius), out))
        return out

    last = None
    counts = {k: 0 for k in cuda_nn.LAUNCHES}
    single_ms, step_ms = [], {k: [] for k in steps}
    for k, scan in enumerate(scans):
        out = fe.process(scan, draws.frontend(fe.n_draws(k == 0), fe.filtered_capacity), last,
                         k == 0)
        if last is not None:
            t = time.perf_counter()
            r1, i1, c1, _, _ = icp_loop(b1, out.flat, last, icp_draws(k), None, dev, False)
            torch.cuda.synchronize(dev)
            single_ms.append(1e3 * (time.perf_counter() - t))
            for name, step in steps.items():
                calls.clear()
                cuda_nn.reset_launches()
                cuda_nn.nearest = recording
                try:
                    t = time.perf_counter()
                    r8, i8, c8, _, _ = step(out.flat, last, icp_draws(k))
                    torch.cuda.synchronize(dev)
                    step_ms[name].append(1e3 * (time.perf_counter() - t))
                finally:
                    cuda_nn.nearest = real
                launches = dict(cuda_nn.LAUNCHES)
                differ = sum(int((a != b).sum()) for args, got in calls
                             for a, b in zip(got, cuda_nn.nearest_plain(*args)))
                err = float((r8 - r1).abs().max())
                print(f"  G2 frame {k + 1} {name}: {i8} ICP iterations, {int(c8)} "
                      f"correspondences, rPose within {err:.2e} of the single device "
                      f"({i1} iterations, {int(c1)}), nearest {launches['nearest']} launches "
                      f"of {calls[0][0][0].shape[0]} queries, {differ} outputs differ from "
                      f"nearest_plain", flush=True)
                if not (err < G_ICP_ATOL and int(c8) == int(c1)):
                    raise AssertionError(f"G2 {name}: rPose {err} from the single device, "
                                         f"correspondences {int(c8)} against {int(c1)}")
                if launches != {**{n: 0 for n in launches}, "nearest": SHARDS * i8}:
                    raise AssertionError(f"G2 {name}: launches {launches}, expected nearest "
                                         f"{SHARDS} x {i8}")
                if differ:
                    raise AssertionError(f"G2 {name}: {differ} nearest outputs differ from "
                                         "the plain version on their shard")
                if name == "8 shards":
                    counts = {n: counts[n] + launches[n] for n in counts}
        last = out.filtered
    args = calls[0][0]
    shard_ms = cuda_ms(lambda: cuda_nn.nearest(*args))
    print(f"G2: icp_loop {', '.join(f'{m:.1f}' for m in single_ms)} ms; "
          + "; ".join(f"{n} {', '.join(f'{m:.1f}' for m in v)} ms" for n, v in step_ms.items())
          + f"; nearest on one shard ({args[0].shape[0]} queries, {args[1].shape[0]} targets) "
          f"{shard_ms:.4f} ms device time", flush=True)
    return counts


def phase_distributed_refine(dev, scans):
    """Phase 12 G3 (see the module docstring)."""
    import torch
    from plo_tpu_torch import config as cfgmod
    from plo_tpu_torch.models.odometry import Odometry
    from plo_tpu_torch.parallel import ba, sharding

    cfg = slice_e_configs(cfgmod, os.path.dirname(os.path.abspath(__file__)))["E3"]
    odo = Odometry(cfg, capacity=CAPACITY, seed=0, device=dev)
    for s in scans:
        odo.process_scan(s)
    _, (poses, src, ref, nrm, val, k, iters, damping, pairs, _) = odo.ba_window(
        odo.frame_count - 1)
    single = lambda: ba.refine_window(poses, src, ref, nrm, val, k, iters, damping, pairs)
    refine = ba.make_distributed_refine(sharding.get_mesh(SHARDS, device=dev), k, iters,
                                        damping=damping, pairs=pairs)
    sharded = lambda: refine(poses, src, ref, nrm, val)
    err = float((sharded() - single()).abs().max())
    ms, sharded_ms = cuda_ms(single), cuda_ms(sharded)
    print(f"G3: window {k}, {len(pairs)} pairs x {src.shape[1]} correspondences, {iters} "
          f"Gauss-Newton steps: make_distributed_refine on {SHARDS} shards within {err:.2e} of "
          f"refine_window; {sharded_ms:.3f} ms against {ms:.3f} ms device time", flush=True)
    if not err < G_BA_ATOL:
        raise AssertionError(f"G3: the distributed refine is {err} from refine_window")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_nccl(dev, scans, cfg, per_frame):
    """Phase 12 G5 (see the module docstring). Returns the launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from plo_tpu_torch.ops import cuda_nn
    from plo_tpu_torch.parallel import distributed, sharding
    from plo_tpu_torch.parallel.odometry import ShardedMapOdometry

    distributed.initialize(f"localhost:{_free_port()}", 1, 0, local_shards=SHARDS, device=dev)
    try:
        mesh = distributed.global_mesh()
        cuda_nn.reset_launches()
        sodo = ShardedMapOdometry(cfg, mesh, capacity=MAP_CAPACITY, seed=0)
        poses = _sharded_frames(dev, f"G5 {dist.get_backend()} group of "
                                f"{dist.get_world_size()}, {mesh.size} shards", sodo, scans)
        launches = _no_launch("G5", {k: 0 for k in cuda_nn.LAUNCHES})
        gloo = sharding.Mesh(mesh.devices, dist.new_group(backend="gloo"))
        try:
            sharding.all_gather(gloo, [torch.ones(2, device=dev)])
            refused = False
        except RuntimeError as err:
            refused = "gloo" in str(err)
        print(f"G5: poses {'equal to' if np.array_equal(poses, per_frame) else 'DIFFER from'} "
              f"G1's per-frame run; a CUDA tensor on a gloo group "
              f"{'raises' if refused else 'DID NOT raise'}; two NCCL ranks on two cards: not "
              f"run by this script (tests/test_torch_gpu.py runs them where there are two "
              f"cards; {torch.cuda.device_count()} here)", flush=True)
        if not np.array_equal(poses, per_frame):
            raise AssertionError("G5: the NCCL group's poses differ from G1's")
        if not refused:
            raise AssertionError("G5: a CUDA tensor on a gloo group did not raise")
    finally:
        distributed.shutdown()
    return launches


def phase_multidevice(dev, scans):
    """Phase 12 (see the module docstring). Returns {path: launch counts}."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="plo_sharded_")
    try:
        g_scans, cfg, per_frame, g1 = phase_sharded_map(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"G1": g1, "G2": phase_sharded_icp(dev, scans)}
    phase_distributed_refine(dev, scans)
    out["G5"] = phase_nccl(dev, g_scans, cfg, per_frame)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of plo_tpu_torch on one CUDA card.")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="an older checkout whose functions of the timed calls' names are "
                         "timed beside this tree's, in turns")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    phase_card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    phase_build()
    dev = torch.device("cuda")
    records = phase_kernels(dev)
    phase_knn(dev, torch.Generator(device=dev).manual_seed(2))
    if args.baseline is not None:
        phase_baseline(os.path.abspath(args.baseline))
    scans, gt = make_sequence()
    default, b1, b2 = configs()
    zero = {"nearest": 0, "projected_argmin": 0, "cylinder_stats": 0, "fps_ranks": 0}
    frames = N_FRAMES - 1  # frames 2-5 run ICP and major-axis sampling
    by_path = {
        "default": phase_path(dev, "default", default, scans, gt,
                              lambda it: {**zero, "cylinder_stats": frames, "fps_ranks": frames}),
        "B1": phase_path(dev, "B1", b1, scans, gt, lambda it: {**zero, "nearest": it}),
        "B2": phase_path(dev, "B2", b2, scans, gt, lambda it: {**zero, "projected_argmin": it}),
        "headline": phase_headline(dev, scans, gt),
        **phase_slice_c(dev, scans, gt),
    }
    phase_matrix(dev)
    by_path.update(phase_slice_d(dev, scans, gt))
    by_path.update(phase_slice_e(dev, scans, gt))
    by_path.update(phase_cli(dev))
    by_path.update(phase_multidevice(dev, scans))
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
