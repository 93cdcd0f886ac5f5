"""ntt_roofline.qp: as ntt_roofline.serve, in the constrained cell, whose
K1/K2 launches run at the 32 + 2 primes of N = 2^15 and at the digit
stacks of its key switches (%)."""

from benchmark.readings import ntt_roofline


def read(run):
    return ntt_roofline(run)
