"""regulator_ms.latency: the harness's span around the port's regulator
call (hempc.regulator), ending in the copy of the move to the host, mean
per step (ms), host clock."""

from benchmark.readings import mean


def read(run):
    m = mean(run.regulator_s)
    return None if m is None else m * 1e3
