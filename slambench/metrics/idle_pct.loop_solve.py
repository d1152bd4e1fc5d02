"""The device's idle share of the profiled session's wall while the host
was in the loop solve's spans: the pose-graph solves of loop closures and
`finish()` (the innermost open span decides; `spans.py`)."""

from slambench.spans import idle_pct

NAME, UNIT, BETTER, SOURCE = "idle_pct.loop_solve", "%", "lower", "program_span"
LAYER, MOVES = "loop solve", "frames_per_s"


def read(run):
    return idle_pct(run, "loop solve")
