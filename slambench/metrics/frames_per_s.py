"""Throughput of full SLAM: every frame whose pose came back in the window,
over the window's seconds (whole sessions, `finish()` included)."""

NAME, UNIT, BETTER, SOURCE = "frames_per_s", "frames/s", "higher", "host_clock"


def read(run):
    return run.frames_returned / run.window_s
