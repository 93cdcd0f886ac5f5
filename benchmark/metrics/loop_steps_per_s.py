"""loop_steps_per_s: plants x closed-loop steps completed, over the
window's wall time, host clock."""

from benchmark.readings import loop_steps_per_s


def read(run):
    return loop_steps_per_s(run)
