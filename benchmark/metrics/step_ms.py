"""step_ms: the window's wall time over the closed-loop steps it
completed (ms), host clock."""

from benchmark.readings import per_step_ms


def read(run):
    return per_step_ms(run)
