"""The half-sample detection (csrc/detect.cu kernels A and B) against its
roofline: the least time of the profiled session's detections on the cell's
shapes over the device time of their launches."""

from slambench.peaks import detect_bound_s

NAME, UNIT, BETTER, SOURCE = "roofline_pct.detect", "%", "higher", "device_trace"
LAYER, MOVES = "kernels", "frames_per_s"


def read(run):
    if run.trace is None:
        return None
    a = run.trace.kernels("detect_cells_kernel")
    b = run.trace.kernels("detect_select_kernel")
    if not a or len(a) != len(b):
        return None
    sensor, ex = run.config["sensor"], run.config["slam_config"]["extractor"]
    least = len(a) * detect_bound_s(sensor["height"], sensor["width"], ex["num_levels"],
                                    ex["cell_size"], ex["num_features"])
    device = sum(r.end_ns - r.start_ns for r in a + b) / 1e9
    return 100.0 * least / device
