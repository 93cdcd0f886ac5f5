"""device_idle_share.latency: 100 (1 - busy / window) over the traced
episodes (%): busy is the union of the device operations on the
device's timeline, window the harness's spans from the first episode
start to the last episode end."""

from benchmark.readings import idle_share


def read(run):
    return idle_share(run)
