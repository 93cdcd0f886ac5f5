"""ntt_roofline.serve: the K1/K2 launches' least time over their device
time in the traced episodes (%): least time from the shapes the port
counts (ops.ntt_cuda.LAUNCH_SHAPES) through yardstick.ntt_least_s."""

from benchmark.readings import ntt_roofline


def read(run):
    return ntt_roofline(run)
