"""The device's idle share of the profiled session's wall while the host
was in the tracker's spans (the innermost open span decides; `spans.py`).
Its reader also prints the whole split (`spans.log`)."""

from slambench.spans import idle_pct, log

NAME, UNIT, BETTER, SOURCE = "idle_pct.tracker", "%", "lower", "program_span"
LAYER, MOVES = "tracker", "frames_per_s"


def read(run):
    log(run)
    return idle_pct(run, "tracker")
