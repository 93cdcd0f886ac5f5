"""plant_estimator_ms.latency: a step's wall time minus its regulator
span, mean per step (ms): control.simulate's estimator, target selector
and plant, and the episode starts, host clock."""

from benchmark.readings import mean


def read(run):
    m = mean(run.step_s - run.regulator_s)
    return None if m is None else m * 1e3
