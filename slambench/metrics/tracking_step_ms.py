"""The tracking step a frame: the counted sessions' wall time less their
construction, keyframe backend (`SlamSystem.kf_backend_ms`, its loop solves
included) and `finish()` calls, over their frames."""

NAME, UNIT, BETTER, SOURCE = "tracking_step_ms", "ms/frame", "lower", "program_counter"
LAYER, MOVES = "tracker", "frames_per_s"


def read(run):
    frames = sum(len(s.t_out) for s in run.counted)
    if not frames:
        return None
    ms = sum(1e3 * (s.t_end - s.t_start) - s.setup_ms - sum(s.kf_backend_ms)
             - s.finish_ms for s in run.counted)
    return ms / frames
