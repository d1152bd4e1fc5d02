"""Per-stage timing and device traces (port of rgbdslam_tpu/utils/profiling.py).

Replaces the reference's minimal tracing (cv::TickMeter around the frame
loop + mean-time HUD, main.cpp:38-47) with named stage timers and optional
torch.profiler traces with NVTX ranges.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage. With `sync=True` a stage that
    ran on a card ends with `torch.cuda.synchronize`, so its time includes
    the device work it enqueued; with `sync=False` (the default) the timer
    adds no host synchronisation."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        """`sync_result`: a tensor the stage produced; with `sync` its device
        is synchronised before the clock stops (the JAX timer's
        block_until_ready)."""
        t0 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if (self.sync and isinstance(sync_result, torch.Tensor)
                    and sync_result.device.type == "cuda"):
                torch.cuda.synchronize(sync_result.device)
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.total[name] / max(self.count[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            lines.append(f"{name:24s} {self.mean_ms(name):8.2f} ms/call "
                         f"x{self.count[name]:5d} = {self.total[name]:7.2f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace scope writing a Chrome trace under `log_dir`
    (no-op when log_dir is None). The StageTimer's NVTX ranges mark the
    stages on a card."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
