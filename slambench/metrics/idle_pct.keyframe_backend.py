"""The device's idle share of the profiled session's wall while the host
was in the keyframe backend's spans, the loop solves inside them excluded
(the innermost open span decides; `spans.py`)."""

from slambench.spans import idle_pct

NAME, UNIT, BETTER, SOURCE = "idle_pct.keyframe_backend", "%", "lower", "program_span"
LAYER, MOVES = "keyframe backend", "frames_per_s"


def read(run):
    return idle_pct(run, "keyframe backend")
