"""Sessions back to back through the entry a traffic mix names, closed loop,
with the host-clock record of every frame.

A session is one recorded sequence processed by a fresh system (`make`),
ending in `finish()`. The batched entry dispatches batch i+1 before it
completes batch i (double buffering); the ring hands in frame i + 1 when the
call for frame i returns, and frame i's pose comes back from that call or
from the flush. The window is whole sessions: it closes when the first
session to end after its time is up has finished, so every window holds
the same kinds of work (a cut session would leave out its loop solves and
`finish()`, which come late in a sequence).

At its end a session's counters and camera trajectory are copied to its
record and its system is let go, but for the first `KEEP` sessions, whose
keyframes the check samples.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


#: sessions whose systems stay alive until the check
KEEP = 3


@dataclass
class SessionRecord:
    index: int
    pool_index: int
    system: object = None              # None once let go
    t_start: float = 0.0
    t_end: float = 0.0
    setup_ms: float = 0.0              # construction and vocabulary load
    t_in: dict = field(default_factory=dict)    # frame -> hand-in time
    t_out: dict = field(default_factory=dict)   # frame -> pose back on the host
    finish_ms: float = 0.0
    kf_backend_ms: list = field(default_factory=list)   # the program's counters
    loop_solve_ms: list = field(default_factory=list)
    keyframes: int = 0
    loops_closed: int = 0
    trajectory: tuple = ()             # (timestamps, Twc) after finish()
    profiled: bool = False
    counters: dict = field(default_factory=dict)  # launches, over a profiled session
    verify_rows: list = field(default_factory=list)  # rows used, a verification launch

    @property
    def latencies_ms(self) -> list:
        return [1e3 * (self.t_out[i] - self.t_in[i]) for i in sorted(self.t_out)]


@dataclass
class RunRecord:
    """What a run measured: the metric readers take it."""

    window_s: float
    sessions: list
    setup_s: float
    trace: object = None              # trace.Summary of the profiled session
    config: dict = None               # the configuration file

    @property
    def frames_returned(self) -> int:
        return sum(len(s.t_out) for s in self.sessions)

    @property
    def counted(self) -> list:
        """The sessions the counter metrics read: all but the profiled one."""
        return [s for s in self.sessions if not s.profiled]


def run_session(make: Callable, seq, rec: SessionRecord, traffic: dict,
                keep: bool = True) -> SessionRecord:
    """One session of `seq` through the mix's entry, its record filled; the
    system is let go at the end unless `keep`."""
    rec.t_start = time.perf_counter()
    system = rec.system = make(rec.index)
    rec.setup_ms = 1e3 * (time.perf_counter() - rec.t_start)
    n = len(seq.timestamps)
    fps_ts = {float(t): i for i, t in enumerate(seq.timestamps)}
    if traffic["entry"] == "ring":
        for i in range(n):
            rec.t_in[i] = time.perf_counter()
            out = system.track_pipelined(seq.timestamps[i], seq.grays[i], seq.depths[i])
            if out is not None:
                rec.t_out[fps_ts[float(out[0])]] = time.perf_counter()
        out = system.track_pipelined_flush()
        if out is not None:
            rec.t_out[fps_ts[float(out[0])]] = time.perf_counter()
    elif traffic["entry"] == "batched":
        B, pending = traffic["batch"], None
        for i0 in range(0, n, B):
            idx = range(i0, min(i0 + B, n))
            t = time.perf_counter()
            h = system.track_batch_dispatch([seq.timestamps[i] for i in idx],
                                            [seq.grays[i] for i in idx],
                                            [seq.depths[i] for i in idx])
            for i in idx:
                rec.t_in[i] = t
            if pending is not None:
                _complete(system, pending, rec)
            pending = (h, idx)
        if pending is not None:
            _complete(system, pending, rec)
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}: 'batched' or 'ring'")
    t = time.perf_counter()
    system.finish()
    rec.finish_ms = 1e3 * (time.perf_counter() - t)
    rec.t_end = time.perf_counter()
    rec.kf_backend_ms = list(system.kf_backend_ms)
    rec.loop_solve_ms = list(system.loop_solve_ms)
    rec.keyframes, rec.loops_closed = system.store.count, system.loops_closed
    rec.trajectory = system.camera_trajectory()
    rec.verify_rows = ([system.bench_rows[k] for k in sorted(system.bench_rows)]
                       + list(system.bench_reloc_rows))
    if not keep:
        rec.system = None
    return rec


def _complete(system, pending, rec: SessionRecord) -> None:
    h, idx = pending
    Tcw = system.track_batch_complete(h)
    t = time.perf_counter()
    if len(Tcw) == len(idx):
        for i in idx:
            rec.t_out[i] = t
    else:                             # fewer poses than frames: the first ones count
        for i in list(idx)[:len(Tcw)]:
            rec.t_out[i] = t


def run_window(make: Callable, pool: list, traffic: dict, seconds: float,
               profiler: Optional[Callable] = None,
               counters: Callable[[], dict] = dict) -> tuple:
    """Whole sessions back to back until `seconds` have passed. With
    `profiler` (a context manager factory), the first session runs under
    it, and `counters()`'s change over it is kept. Returns (window seconds,
    sessions, the profiler object or None)."""
    if traffic.get("loop", "closed") != "closed":
        raise ValueError(f"loop {traffic['loop']!r}: only a closed loop is driven")
    sessions, prof = [], None
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() < t0 + seconds:
        rec = SessionRecord(index=k, pool_index=k % len(pool))
        seq = pool[rec.pool_index]
        if profiler is not None and k == 0:
            rec.profiled = True
            before = counters()
            with profiler() as prof:
                run_session(make, seq, rec, traffic, k < KEEP)
            rec.counters = {n: v - before[n] for n, v in counters().items()}
        else:
            run_session(make, seq, rec, traffic, k < KEEP)
        sessions.append(rec)
        k += 1
    return sessions[-1].t_end - t0, sessions, prof
