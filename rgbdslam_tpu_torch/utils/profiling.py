"""The package's span recorder (port of rgbdslam_tpu/utils/profiling.py's
stage timer, which replaces the reference's cv::TickMeter around the frame
loop, main.cpp:38-47).

A span is a named interval of the host's work: its name, start and end in
ns, the thread that ran it, the span that encloses it on that thread, and
the frame or keyframe index where one applies. The tracker, the keyframe
backend and the loop solve open spans where their host work happens, so a
device trace's idle gaps can be put down to the layer the host was in.

Spans are recorded only while a torch.profiler session is active in the
process (`torch.autograd.profiler._is_profiler_enabled`) or while
`SPANS.forced` is set (the CLI's `--profile`). Off, a span reads that flag
and no clock. There is one recorder a process, as there is one profiler.
A span goes to the session that was open when it opened: `new_session()`
hands its caller a new list, which the spans opened from then on fill, and
the recorder lets go of the last one. Each `SlamSystem` starts a session
and holds its list, so its spans are told apart from those of systems made
before or beside it, and are freed with it.

The clock is `time.time_ns`: Unix ns, the axis torch.profiler converts its
records to. On an H100 (torch 2.11, CUDA activity only) every CUDA runtime
call of a profiled window fell inside the span around it, 1.2-2 us from the
nearer edge at the least: the spans and the trace agree to within a few us.

`timed` spans also feed the system's counters (`kf_backend_ms`,
`loop_solve_ms`, `local_ba_ms`, `global_ba_ms`), which are kept whether the
recorder is on or not: off, such a block reads `time.perf_counter_ns` twice
and records nothing; on, its duration is its span's.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

#: the spans' clock (module attribute, so a test can replace it)
clock = time.time_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int          # threading.get_ident() of the thread that ran it
    id: int
    parent: int          # id of the enclosing span on the same thread, -1 at the top
    index: int           # frame or keyframe index, -1 where none applies


class _Off:
    """A span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "index", "id", "parent", "stack", "out", "start", "end")

    def __init__(self, rec: "SpanRecorder", name: str, index: int):
        self.rec, self.name, self.index = rec, name, index

    def __enter__(self):
        stack = self.stack = self.rec._stack()
        self.parent = stack[-1] if stack else -1
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.out = self.rec.records       # the session open now
        self.start = clock()
        return self

    def __exit__(self, *exc):
        self.end = clock()
        self.stack.pop()
        self.out.append(Span(self.name, self.start, self.end, threading.get_ident(),
                             self.id, self.parent, self.index))
        return False


class _Timed:
    """A span that is also a counter: `ms` holds its duration once it has
    closed, whether the recorder was on or not."""

    __slots__ = ("span", "t0", "ms")

    def __init__(self, rec: "SpanRecorder", name: str, index: int):
        self.span = _Open(rec, name, index) if rec.on() else None

    def __enter__(self):
        if self.span is None:
            self.t0 = time.perf_counter_ns()
        else:
            self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.span is None:
            self.ms = (time.perf_counter_ns() - self.t0) / 1e6
        else:
            self.span.__exit__(*exc)
            self.ms = (self.span.end - self.span.start) / 1e6
        return False


class SpanRecorder:
    def __init__(self):
        self.records: list = []     # the open session's Spans, in the order they ended
        self.forced = False
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        """The ids of this thread's open spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def on(self) -> bool:
        return self.forced or _profiler._is_profiler_enabled

    def span(self, name: str, index: int = -1):
        """A context manager: a span `name` while the recorder is on."""
        if not (self.forced or _profiler._is_profiler_enabled):
            return _OFF
        return _Open(self, name, index)

    def timed(self, name: str, index: int = -1) -> _Timed:
        """A context manager that times its block (`.ms`), a span too while
        the recorder is on."""
        return _Timed(self, name, index)

    def new_session(self) -> list:
        """Open a session: the list the spans opened from now on go to."""
        self.records = []
        return self.records

    def report(self) -> str:
        """Count, mean and total ms by name of the open session's spans, the
        largest total first."""
        by = {}
        for s in self.records:
            n, t = by.get(s.name, (0, 0))
            by[s.name] = (n + 1, t + s.end_ns - s.start_ns)
        return "\n".join(
            f"{name:24s} {t / n / 1e6:10.3f} ms/call x{n:6d} = {t / 1e9:8.3f} s"
            for name, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1]))


#: the process's recorder
SPANS = SpanRecorder()


def spanned(name: str):
    """Decorator: the function runs inside a span `name` of `SPANS`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with SPANS.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
