"""The pose-graph solve: the loop-closure solves (`SlamSystem.loop_solve_ms`)
and the sessions' `finish()` calls, over their count."""

NAME, UNIT, BETTER, SOURCE = "loop_solve_ms", "ms/solve", "lower", "program_counter"
LAYER, MOVES = "loop solve", "frames_per_s"


def read(run):
    solves = [x for s in run.counted for x in s.loop_solve_ms]
    solves += [s.finish_ms for s in run.counted]
    return sum(solves) / len(solves) if solves else None
