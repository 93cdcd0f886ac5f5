"""The arithmetic the metric readers share, on a ``harness.Run``.

Each returns None where the run holds nothing to read (an untraced run,
no device operation of the kind, no step), never 0 for a share.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import yardstick

# the port's kernel names, as the profiler reports them
NTT_KERNELS = ("ntt_fwd_kernel", "ntt_inv_kernel")
KEYSWITCH_KERNELS = ("base_convert_kernel", "key_inner_product_kernel",
                     "mod_down_tail_kernel")


def percentile(values, q: float) -> float | None:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return None
    return float(v[max(math.ceil(q / 100 * v.size), 1) - 1])


def mean(values) -> float | None:
    v = np.asarray(values, dtype=np.float64)
    return float(v.mean()) if v.size else None


def per_step_ms(run) -> float | None:
    """The window's wall time over its closed-loop steps, in ms."""
    return run.window_s / run.steps * 1e3 if run.steps else None


def loop_steps_per_s(run) -> float | None:
    """Plants x closed-loop steps completed, over the window's wall time."""
    return run.plants * run.steps / run.window_s if run.steps else None


def idle_share(run) -> float | None:
    """100 (1 - busy / window) of the traced window, in %."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def device_seconds(run, names) -> tuple[int, float] | None:
    """(operations, device seconds) of the traced operations whose name
    holds one of `names`; None where there are none."""
    t = run.trace
    if t is None:
        return None
    count, seconds = 0, 0.0
    for name, (n, s) in t.device_ops.items():
        if any(k in name for k in names):
            count += n
            seconds += s
    return (count, seconds) if count else None


def ntt_roofline(run) -> float | None:
    """100 x the K1/K2 launches' least time (``yardstick.ntt_least_s`` over
    the shapes the port counted) over their device time, in %."""
    t = run.trace
    got = device_seconds(run, NTT_KERNELS)
    if got is None or not t.ntt_shapes:
        return None
    least = sum(n * yardstick.ntt_least_s(shape)
                for (_, shape), n in t.ntt_shapes.items())
    return 100.0 * least / got[1]
