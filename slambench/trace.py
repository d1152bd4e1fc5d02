"""The device trace of one profiled session, read from torch.profiler's
Kineto records as they stand (torch's own event parse costs the host tens of
microseconds a record, seconds for a session).

Only the device is traced (CUDA activity: the device's kernels, copies and
fills, and the host's CUDA runtime calls): recording every host-side
operator as well doubled a session's wall time on an H100 and made the idle
share read high. An idle gap on the device is named by the runtime call the
host was in, or "python" where it was in none: host work between launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

#: how the profiler names the kernels of the program's csrc/ (a template's
#: name starts with its return type)
OWN_KERNEL_PREFIXES = ("(anonymous namespace)::", "void (anonymous namespace)::")


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


def own_name(name: str) -> Optional[str]:
    """A kernel of the program's csrc/ by its function's name, else None
    (PyTorch keeps some kernels in an anonymous namespace too, with
    at::native in their template arguments)."""
    if not name.startswith(OWN_KERNEL_PREFIXES) or "at::native" in name:
        return None
    return name.split("(anonymous namespace)::")[1].split("(")[0].split("<")[0]


def profiler():
    """The device's trace; on a machine without a card (the benchmark's own
    tests) the host's operators instead, and no device record."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if torch.cuda.is_available() else act.CPU])


def records(prof) -> tuple:
    """(host records, device records) of a finished profiler window."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)() or e.name() == "[memory]":
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            device.append(Record(e.name(), e.start_ns(), e.end_ns()))
        else:
            host.append(Record(e.name(), e.start_ns(), e.end_ns()))
    return host, device


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(device: List[Record]) -> list:
    """(start_ns, end_ns) of the gaps between the device's busy intervals."""
    gaps, cur_e = [], None
    for r in sorted(device, key=lambda r: r.start_ns):
        if cur_e is not None and r.start_ns > cur_e:
            gaps.append((cur_e, r.start_ns))
        cur_e = r.end_ns if cur_e is None else max(cur_e, r.end_ns)
    return gaps


def is_kernel(r: Record) -> bool:
    return not r.name.startswith(("Memcpy", "Memset"))


@dataclass
class Summary:
    """The profiled session: its wall seconds (host clock), frames, the
    records, and the program's launch counters over the session."""

    window_s: float
    frames: int
    host: list
    device: list
    counters: dict

    @property
    def busy_s(self) -> float:
        return union_ns((r.start_ns, r.end_ns) for r in self.device) / 1e9

    def kernels(self, name: str) -> list:
        """The records of the program's own kernel `name`."""
        return [r for r in self.device if own_name(r.name) == name]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the idle time summed
        by the host's runtime call that spans each gap's middle (the latest
        to start; "python" where none spans it)."""
        ops = {}
        for r in self.device:
            ops[r.name] = ops.get(r.name, 0.0) + (r.end_ns - r.start_ns) / 1e9
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host, key=lambda r: r.start_ns)
        hs = np.array([r.start_ns for r in host], np.int64)
        by = {}
        for s, e in idle_gaps(self.device):
            mid = (s + e) // 2
            i = int(np.searchsorted(hs, mid, side="right")) - 1
            name = host[i].name if i >= 0 and host[i].end_ns >= mid else "python"
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        idle = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in device_ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}


def summarize(prof, window_s: float, frames: int, counters: dict) -> Summary:
    host, device = records(prof)
    return Summary(window_s=window_s, frames=frames, host=host, device=device,
                   counters=counters)
