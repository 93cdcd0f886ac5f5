"""Double-double (compensated float64-pair) arithmetic.

CKKS decode must recover centered values x mod Q with x/Delta accurate
to ~1e-12 while Q ~ 2^110, beyond float64's 53 bits; decode evaluates
the fractional-CRT sum x/Q = frac(sum_i c_i / p_i) in double-double
(~106 effective bits), as ``hectr_tpu/ckks/dd.py`` does.

Classic error-free transforms (Dekker/Knuth).  Each product and sum is
written as its own operation: a fused multiply-add (``addcmul`` and the
like) would break the error-free transforms.  All functions take and
return (hi, lo) pairs of float64 tensors (or Python floats).
"""

from __future__ import annotations

import torch

_SPLITTER = 134217729.0  # 2^27 + 1


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo each 26/27-bit."""
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(x, y):
    """(hi,lo) + (hi,lo)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + xl + yl
    return quick_two_sum(s, e)


def dd_add_f(x, b):
    """(hi,lo) + float."""
    xh, xl = x
    s, e = two_sum(xh, b)
    e = e + xl
    return quick_two_sum(s, e)


def dd_mul(x, y):
    """(hi,lo) * (hi,lo)."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + xh * yl + xl * yh
    return quick_two_sum(p, e)


def dd_div_ff(a, b):
    """float / float -> dd, accurate to ~2^-104."""
    q1 = a / b
    p, e = two_prod(q1, b)
    r = (a - p) - e
    q2 = r / b
    return quick_two_sum(q1, q2)


def dd_neg(x):
    return -x[0], -x[1]


def dd_round(x):
    """Round dd to the nearest integer (ties to even, as jnp.round)."""
    xh, xl = x
    r = torch.round(xh)
    frac = (xh - r) + xl
    adj = torch.round(frac)
    return r + adj


def dd_to_float(x):
    return x[0] + x[1]
