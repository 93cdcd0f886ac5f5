"""device_idle_share.serve: as device_idle_share.latency, in the cells
that serve a batch of plants (%)."""

from benchmark.readings import idle_share


def read(run):
    return idle_share(run)
