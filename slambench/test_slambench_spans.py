"""The span readers (`spans.py` and the five metrics that use it) on made-up
spans and trace records: the idle split and the rest add up to
`device_idle_pct`, the innermost span decides, launches count only inside
the tracker's enqueue spans, another thread's spans count for nothing, and
every reader reads None where the program recorded no span."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import pytest

from slambench import drive, spans, trace
from slambench.manifest import load_module

HERE = Path(__file__).resolve().parent
READERS = ("idle_pct.tracker", "idle_pct.keyframe_backend", "idle_pct.loop_solve",
           "dispatch_us_per_launch", "read_wait_ms")


class Span(NamedTuple):          # the program's record (utils/profiling.py)
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int
    index: int = -1


class System:
    def __init__(self, spans_):
        self.spans = spans_


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py")


def _spans():
    """A ring frame, a keyframe whose completion closes a loop, and
    `finish()`, on thread 1; a worker's span over all of it on thread 2."""
    rows = [("session.init", 0, 50, -1), ("tracker.ring", 100, 600, -1),
            ("tracker.enqueue", 120, 300, 1), ("tracker.build", 130, 200, 2),
            ("tracker.complete", 300, 590, 1), ("tracker.read", 310, 400, 4),
            ("backend.complete", 400, 580, 4), ("loop.optimize", 450, 560, 6),
            ("lm.linearize", 460, 500, 7), ("loop.finish", 620, 1000, -1)]
    out = [Span(n, s, e, 1, i, p) for i, (n, s, e, p) in enumerate(rows)]
    return out + [Span("export.write", 0, 1000, 2, 99, -1)]


def _run(spans_=None, system=True, traced=True):
    """A profiled session of 1 us wall (0-1,000 ns on the trace's axis),
    two frames, the device busy 130 ns of it."""
    device = [trace.Record("k", 140, 160), trace.Record("k", 350, 360),
              trace.Record("k", 700, 800)]
    host = [trace.Record("cudaLaunchKernel", 125, 126),     # enqueue
            trace.Record("cudaLaunchKernel", 135, 136),     # build, inside the enqueue
            trace.Record("cudaGraphLaunch", 250, 251),      # enqueue
            trace.Record("cudaMemcpyAsync", 150, 151),      # not a launch
            trace.Record("cudaLaunchKernel", 455, 456),     # the loop solve's
            trace.Record("cudaLaunchKernel", 610, 611)]     # outside every span
    s = drive.SessionRecord(index=0, pool_index=0, profiled=True)
    s.system = System(_spans() if spans_ is None else spans_) if system else None
    summary = trace.Summary(window_s=1e-6, frames=2, host=host, device=device, counters={})
    return drive.RunRecord(window_s=1.0, sessions=[s], setup_s=0.0,
                           trace=summary if traced else None)


def test_the_split_and_the_rest_add_up_to_the_idle_share():
    run = _run()
    idle = metric("device_idle_pct").read(run)
    assert idle == pytest.approx(87.0)
    got = {name: metric(name).read(run) for name in READERS[:3]}
    assert got == pytest.approx({"idle_pct.tracker": 29.0, "idle_pct.keyframe_backend": 7.0,
                                 "idle_pct.loop_solve": 39.0})
    rest = spans.split(run).idle_ns
    assert rest[None] == 70 and rest["set-up"] == 50
    assert sum(got.values()) + 100.0 * (rest[None] + rest["set-up"]) / 1000 == \
        pytest.approx(idle)


def test_the_innermost_span_decides():
    """The read inside the completion is the tracker's, the loop solve
    inside the keyframe's completion (and the solver's span inside it) the
    loop solve's, and a span of no layer takes its parent's."""
    run = _run()
    assert metric("idle_pct.loop_solve").read(run) == pytest.approx(39.0)
    flat = [s._replace(parent=-1) if s.name == "lm.linearize" else s for s in _spans()]
    run = _run(flat)
    # lm.linearize without a parent has no layer: its 40 ns leave the loop solve
    assert metric("idle_pct.loop_solve").read(run) == pytest.approx(35.0)
    assert spans.split(run).idle_ns[None] == 110


def test_launches_count_only_inside_enqueue_spans():
    run = _run()
    sp = spans.split(run)
    assert sp.launches == 3 and sp.enqueue_ns == 180
    assert metric("dispatch_us_per_launch").read(run) == pytest.approx(0.18 / 3)
    assert metric("read_wait_ms").read(run) == pytest.approx(90 / 1e6 / 2)
    assert (sp.calls, sp.calls_inside) == (6, 5)


@pytest.mark.parametrize("case", ["no spans", "no attribute", "system let go", "no trace"])
def test_every_reader_reads_none_without_spans(case):
    if case == "no spans":
        run = _run([])
    elif case == "no attribute":
        run = _run()
        run.sessions[0].system = object()
    elif case == "system let go":
        run = _run(system=False)
    else:
        run = _run(traced=False)
    for name in READERS:
        assert metric(name).read(run) is None, name
