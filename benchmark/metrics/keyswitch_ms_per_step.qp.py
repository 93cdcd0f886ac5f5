"""keyswitch_ms_per_step.qp: device time of the key-switch kernels K6-K8
(base_convert_kernel, key_inner_product_kernel, mod_down_tail_kernel)
over the closed-loop steps traced, ms: the rotations' and the
relinearisations' key switches, 2 special primes and 2 primes a digit."""

from benchmark.readings import KEYSWITCH_KERNELS, device_seconds


def read(run):
    got = device_seconds(run, KEYSWITCH_KERNELS)
    t = run.trace
    if got is None or not t.steps:
        return None
    return got[1] / t.steps * 1e3
