"""The gated 2-NN Hamming matcher (csrc/hamming.cu K2 and its gate kernel)
against its roofline: the least time of the profiled session's matches over
the device time of K2's and the gates' launches.

An unbatched launch matches one frame (the tracking estimate, a keyframe's
track extension). A batched launch verifies candidates against a keyframe
or a lost frame, padded to a fixed count; only the rows whose results the
program uses count as work: a keyframe's proximity candidates, its valid
loop candidates when its loop gate is open, a relocalization's candidates
(`observe.py`, `SessionRecord.verify_rows`). Read only where the trace holds
every launch counted and the rows come one a batched launch."""

from slambench.peaks import match_bound_s

NAME, UNIT, BETTER, SOURCE = "roofline_pct.match", "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    if run.trace is None:
        return None
    k2 = run.trace.kernels("hamming_kernel")
    gates = run.trace.kernels("match_gate_kernel")
    c = run.trace.counters
    rows = c.get("rows", [])
    if not k2 or len(k2) != len(gates) or len(k2) != c.get("k2") \
            or len(rows) != c.get("k2_batched"):
        return None
    n = run.config["slam_config"]["extractor"]["num_features"]
    least = ((c["k2"] - c["k2_batched"]) * match_bound_s(1, n, n)
             + sum(match_bound_s(r, n, n) for r in rows))
    device = sum(r.end_ns - r.start_ns for r in k2 + gates) / 1e9
    return 100.0 * least / device
