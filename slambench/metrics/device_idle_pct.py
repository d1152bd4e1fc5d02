"""The device's idle share of the profiled session: 1 - the union of its
busy intervals over the session's wall time."""

NAME, UNIT, BETTER, SOURCE = "device_idle_pct", "%", "lower", "device_trace"
LAYER, MOVES = "device", "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
