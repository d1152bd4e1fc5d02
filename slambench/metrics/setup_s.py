"""Set-up: process start to the first timed frame (imports, the kernel
library's load or build, the frames and noise, the vocabulary, the warm
session)."""

NAME, UNIT, BETTER, SOURCE = "setup_s", "s", "lower", "host_clock"


def read(run):
    return run.setup_s
