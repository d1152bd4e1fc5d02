"""How long the host waits for the card: ms inside the tracker's
device-to-host reads (`tracker.read` spans) over the profiled session's
frames (`spans.py`)."""

from slambench.spans import split

NAME, UNIT, BETTER, SOURCE = "read_wait_ms", "ms/frame", "lower", "program_span"
LAYER, MOVES = "tracker", "frames_per_s"


def read(run):
    sp = split(run)
    if sp is None or not run.trace.frames:
        return None
    return sp.read_ns / 1e6 / run.trace.frames
