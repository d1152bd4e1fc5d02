"""Live latency: the 95th percentile over every frame of the window of the
time from its hand-in to the entry until its pose is back on the host."""

import numpy as np

NAME, UNIT, BETTER, SOURCE = "frame_ms_p95", "ms", "lower", "host_clock"


def read(run):
    lat = [x for s in run.sessions for x in s.latencies_ms]
    return float(np.percentile(lat, 95)) if lat else None
