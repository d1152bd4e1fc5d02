"""The tracker's host cost of a launch: host us inside its enqueue spans
(where one is the innermost open span) over the launch calls of the trace
that start there (`spans.py`), in the profiled session."""

from slambench.spans import split

NAME, UNIT, BETTER, SOURCE = "dispatch_us_per_launch", "us/launch", "lower", "program_span"
LAYER, MOVES = "tracker", "frames_per_s"


def read(run):
    sp = split(run)
    if sp is None:
        return None
    return sp.enqueue_ns / 1e3 / sp.launches if sp.launches else None
