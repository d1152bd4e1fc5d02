"""The keyframe backend a keyframe: `SlamSystem.kf_backend_ms` less the loop
solves inside it, over the counted sessions' keyframes."""

NAME, UNIT, BETTER, SOURCE = "keyframe_backend_ms", "ms/keyframe", "lower", "program_counter"
LAYER, MOVES = "keyframe backend", "frames_per_s"


def read(run):
    kfs = sum(len(s.kf_backend_ms) for s in run.counted)
    if not kfs:
        return None
    return sum(sum(s.kf_backend_ms) - sum(s.loop_solve_ms)
               for s in run.counted) / kfs
