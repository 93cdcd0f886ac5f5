"""step_ms_p95: the 95th percentile (nearest rank) of the wall time of
every step of the window (ms), host clock; a step runs from the end of
the step before it, so episode starts count."""

from benchmark.readings import percentile


def read(run):
    p = percentile(run.step_s, 95)
    return None if p is None else p * 1e3
