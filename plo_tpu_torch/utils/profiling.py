"""Wall-clock stage timing, per-frame metrics and device traces — the port
of plo_tpu/utils/profiling.py.

TicToc mirrors the reference's stopwatch (tic_toc.h:8-42) with its
`tocAndLog` text format ("<step>: <ms> ms"); MetricsLog writes one JSON
record a frame; DeviceTrace records a torch.profiler trace (with the CUDA
kernels' device events on the card) and writes it as a Chrome trace.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self):
        self._start = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._start) * 1000.0

    def toc_and_log(self, step_name: str, filename: str) -> float:
        ms = self.toc()
        with open(filename, "a") as f:
            f.write(f"{step_name}: {ms:.3f} ms\n")
        return ms


class MetricsLog:
    """Append-mode JSONL metrics writer (one dict per frame)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records = []

    def log(self, record: Dict[str, Any]):
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


class DeviceTrace:
    """A torch.profiler trace of everything run inside the context, written
    to `<log_dir>/trace.json` (Chrome trace format) on exit. Where there is a
    CUDA card its activity is recorded too, and the card is synchronized
    before the trace stops, so every kernel queued inside the context is in
    it.

    Usage:
        with DeviceTrace("/tmp/trace") as tr:
            odo.process_scan(scan)
        tr.path, tr.profile.key_averages()
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.cuda = torch.cuda.is_available()
        self.path = os.path.join(log_dir, "trace.json")
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.profile.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile.export_chrome_trace(self.path)
        return False
