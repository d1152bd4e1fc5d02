"""Device kernel launches of the profiled session, over its frames."""

from slambench.trace import is_kernel

NAME, UNIT, BETTER, SOURCE = "launches_per_frame", "launches/frame", "lower", "device_trace"
LAYER, MOVES = "device", "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    n = sum(1 for r in run.trace.device if is_kernel(r))
    return n / run.trace.frames if n else None
