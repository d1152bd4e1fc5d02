"""The program's spans of the profiled session on the device trace's axis:
the device's idle time put down to the layer the host was in, the host's
enqueue time over the launches it made, and the host's waits on the card.

The profiled session is the window's first, whose system `drive.KEEP`
keeps alive until the metrics are read; its spans are `system.spans`
(rgbdslam_tpu_torch/utils/profiling.py: name, start and end in Unix ns,
thread, id, parent id, index). They share the trace's clock. A program
without spans (no such attribute, or none recorded) reads None.

Only the thread that made the system counts (a live-export worker's spans
are its own). Its spans nest; at each instant the innermost open one
decides. A span's layer is its name's first word where that names one
(LAYERS), else its parent's: the solver's `lm.*` spans count as the loop
solve inside `loop.optimize`. The session's wall on this axis runs from its
first span (the system's construction) to its last (`finish()`).
"""

from __future__ import annotations

import sys

from slambench.trace import idle_gaps

#: a span name's first word -> its layer (PERF.md's list of layers);
#: "set-up" is the session's construction and vocabulary load
LAYERS = {"tracker": "tracker", "backend": "keyframe backend", "loop": "loop solve",
          "session": "set-up"}
#: the tracker's enqueue spans: a batch's dispatch, a frame's enqueue, and
#: inside them the build, the fused estimate and the dense-ICP polish
ENQUEUE = frozenset({"tracker.dispatch", "tracker.enqueue", "tracker.build",
                     "tracker.estimate", "tracker.polish"})
#: the tracker's device-to-host reads
READ = "tracker.read"
#: the host's launch calls, as the trace names them
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                      "cuLaunchKernel", "cuLaunchKernelEx"})


class Split:
    """What the readers take from the profiled session's spans and trace,
    worked out once: the idle ns by layer, the enqueue ns and launches, the
    read ns, and the runtime calls inside spans."""

    def __init__(self, spans: list, trace):
        first = min(spans, key=lambda s: s.start_ns)
        self.spans = [s for s in spans if s.thread == first.thread]
        self.lo = first.start_ns
        self.hi = max(s.end_ns for s in self.spans)
        layer = {}                    # a parent starts before its children
        for s in sorted(self.spans, key=lambda s: s.start_ns):
            layer[s.id] = LAYERS.get(s.name.split(".")[0]) or layer.get(s.parent)
        cut = pieces(self.spans)

        #: device idle ns in the session's wall by the innermost span's layer
        #: (None: outside every span, or in a span of no layer)
        self.idle_ns = {}
        gaps = [(self.lo, self.hi)]
        if trace.device:
            gaps = ([(self.lo, min(r.start_ns for r in trace.device))] + idle_gaps(trace.device)
                    + [(max(r.end_ns for r in trace.device), self.hi)])
        for (s, e, span), ns in overlaps(cut, clip(gaps, self.lo, self.hi)):
            key = layer[span.id] if span is not None else None
            self.idle_ns[key] = self.idle_ns.get(key, 0) + ns

        #: host ns inside the enqueue spans, and the launch calls starting there
        self.enqueue_ns = sum(e - s for s, e, span in cut
                              if span is not None and span.name in ENQUEUE)
        launches = sorted(r.start_ns for r in trace.host if r.name in LAUNCHES)
        self.launches = sum(k for (s, e, span), k in overlaps(cut, points(launches))
                            if span is not None and span.name in ENQUEUE)
        self.read_ns = sum(s.end_ns - s.start_ns for s in self.spans if s.name == READ)
        #: the trace's runtime calls in the session's wall, and those inside spans
        calls = sorted(r.start_ns for r in trace.host
                       if r.name.startswith("cu") and self.lo <= r.start_ns < self.hi)
        self.calls = len(calls)
        self.calls_inside = sum(k for (s, e, span), k in overlaps(cut, points(calls))
                                if span is not None)
        #: the frames of the second-reference retries and relocalizations
        self.retried = [s.index for s in self.spans if s.name == "tracker.retry"]
        self.relocalized = [s.index for s in self.spans if s.name == "tracker.relocalize"]


def points(starts: list) -> list:
    """1 ns intervals at sorted instants: `overlaps` then counts them."""
    return [(t, t + 1) for t in starts]


def pieces(spans: list) -> list:
    """(start, end, innermost span or None) covering the spans' extent, in
    order; the spans nest."""
    events = []
    for s in spans:
        events.append((s.start_ns, 1, -s.end_ns, s))
        events.append((s.end_ns, 0, -s.start_ns, s))
    events.sort(key=lambda ev: ev[:3])
    out, stack, t_prev = [], [], None
    for t, kind, _, s in events:
        if t_prev is not None and t > t_prev:
            out.append((t_prev, t, stack[-1] if stack else None))
        t_prev = t
        if kind:
            stack.append(s)
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is s:
                    del stack[i]
                    break
    return out


def clip(intervals: list, lo: int, hi: int) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def overlaps(pieces_: list, intervals: list):
    """(piece, ns of it inside `intervals`) for each piece that meets them;
    both lists sorted by start, the pieces free of overlaps."""
    j = 0
    for p in pieces_:
        s, e = p[0], p[1]
        while j < len(intervals) and intervals[j][1] <= s:
            j += 1
        k, ns = j, 0
        while k < len(intervals) and intervals[k][0] < e:
            ns += min(e, intervals[k][1]) - max(s, intervals[k][0])
            k += 1
        if ns > 0:
            yield p, ns


def split(run):
    """The run's Split, or None without a trace or spans: worked out by the
    first reader and kept on the run for the others."""
    if not hasattr(run, "_span_split"):
        s0 = next((s for s in run.sessions if s.profiled), None)
        spans = getattr(s0.system, "spans", None) if s0 is not None and s0.system else None
        run._span_split = (Split(spans, run.trace) if run.trace is not None and spans
                           else None)
    return run._span_split


def idle_pct(run, layer: str):
    """The device's idle share of the session's wall inside `layer`'s spans."""
    sp = split(run)
    if sp is None or not run.trace.device:
        return None
    return 100.0 * sp.idle_ns.get(layer, 0) / (run.trace.window_s * 1e9)


def log(run) -> None:
    """The whole split on stderr, for PERF.md: every layer's idle share,
    the rest, how many of the trace's runtime calls fell inside spans, and
    the frames the tracker retried or relocalized. `idle_pct.tracker`'s
    reader prints it, once a run."""
    sp = split(run)
    if sp is None:
        return
    shares = {k or "outside": round(100.0 * v / (run.trace.window_s * 1e9), 3)
              for k, v in sp.idle_ns.items()}
    print(f"[spans] {len(sp.spans)} spans, wall {(sp.hi - sp.lo) / 1e9:.3f} s on the trace's "
          f"axis; idle % by layer {shares}; runtime calls inside spans {sp.calls_inside} of "
          f"{sp.calls}; enqueue {sp.enqueue_ns / 1e6:.1f} ms over {sp.launches} launches; "
          f"retried frames {sp.retried}, relocalized {sp.relocalized}",
          file=sys.stderr, flush=True)
