"""The benchmark's frozen yardstick: the card's published peaks, the
least time of a kernel launch, and the HE standard's security table.

Nothing here reads the card: every constant is from a data sheet or a
standard, so a roofline share means the same on every machine.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
# The H100 SXM's 132 SMs at its 1,980 MHz boost clock; compute capability
# 9.0 issues 64 32-bit integer multiply(-add)s a clock on each SM (CUDA C
# Programming Guide, arithmetic instruction throughput).  A lazy Shoup
# multiply mod a 30-bit prime is three of them (IMAD.HI, IMUL, IMAD).
SMS = 132
SM_CLOCK_HZ = 1.98e9
IMAD_PER_CLOCK_PER_SM = 64
IMAD_PER_LAZY_MULT = 3
LAZY_MULT_PER_S = SMS * IMAD_PER_CLOCK_PER_SM * SM_CLOCK_HZ / IMAD_PER_LAZY_MULT

# HomomorphicEncryption.org Security Standard (Nov 2018), Table 1: the
# largest log2(QP) at ring degree 2^logn for 128-bit security against
# classical attacks, ternary secret, sigma 3.2.
HE_STANDARD_MAX_LOGQP = {128: {10: 27, 11: 54, 12: 109, 13: 218, 14: 438,
                               15: 881}}


def ntt_least_s(shape) -> float:
    """The least time in seconds of one K1/K2 launch (forward or inverse
    negacyclic NTT) over an int64 tensor [..., L, N]: each input read once
    (the rows, the L primes' twiddle and companion tables as int32, the
    primes) and each output written once, at the HBM bandwidth, against
    N log2 N / 2 lazy Shoup multiplies a row at the multiply peak; the
    larger of the two."""
    *lead, limbs, n = (int(d) for d in shape)
    rows = limbs
    for d in lead:
        rows *= d
    logn = n.bit_length() - 1
    nbytes = rows * n * 8 * 2 + limbs * (n * 4 * 2 + 4)
    mults = rows * logn * (n // 2)
    return max(nbytes / HBM_BYTES_PER_S, mults / LAZY_MULT_PER_S)
