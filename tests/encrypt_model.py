"""The CPU's stand-in for K14 (``ops.encrypt_cuda._launch``): its
floor-mod on int64 words and its arithmetic, for the tests that run the
kernel's route without a card (tests/test_torch_encrypt_kernel.py and,
with the JAX package's draws, tests/test_torch_scheme.py).  Imports
neither jax nor the JAX package."""

import numpy as np
import torch

from hectr_tpu_torch.ckks.modmath import add_mod_plain, mul_add_mod_plain
from hectr_tpu_torch.ckks.ntt import ntt_plain
from hectr_tpu_torch.ops import encrypt_cuda as EC


def floor_mod_model(x: torch.Tensor, p: int) -> torch.Tensor:
    """csrc/encrypt.cu FloorMod on int64 words, in uint64 numpy words: q
    the high 64 bits of u m (u the word as unsigned, m = floor((2^64 - 1)
    / p)), r = u - q p in 32 bits, two corrections, then R = 2^64 mod p
    off a negative word."""
    M = np.uint64(0xFFFFFFFF)
    u = x.numpy().view(np.uint64)
    m = (2 ** 64 - 1) // p
    R = ((2 ** 64 - 1) - m * p + 1) % p
    uh, ul = u >> np.uint64(32), u & M
    mh, ml = np.uint64(m >> 32), np.uint64(m & 0xFFFFFFFF)
    lh, hl = ul * mh, uh * ml
    mid = ((ul * ml) >> np.uint64(32)) + (lh & M) + (hl & M)
    q = uh * mh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (
        mid >> np.uint64(32))
    r = (ul - (q & M) * np.uint64(p)) & M
    for _ in range(2):
        r = np.where(r >= p, r - np.uint64(p), r)
    neg = x.numpy() < 0
    r = np.where(neg, np.where(r >= R, r - np.uint64(R),
                               r + np.uint64(p - R)), r)
    return torch.from_numpy(r.astype(np.int64))


def kernel_model(operands, out, t, rows, geom):
    """A stand-in for ``encrypt_cuda._launch`` on the CPU with K14's
    arithmetic: each draw floor-modded by the kernel's rule, transformed
    (K1's words are the plain transform's), combined by the plain
    primitives' formula; written into out."""
    v, e0, e1, m, pk = operands
    k = len(t.primes)
    assert rows == m.numel() // t.n and geom == EC.geometry(
        t.n.bit_length() - 1)
    assert all(x.is_contiguous() for x in operands)
    res = [torch.stack([floor_mod_model(x, p) for p in t.primes], dim=-2)
           for x in (v, e0, e1)]
    vh, e0h, e1h = (ntt_plain(r, t) for r in res)
    out[..., 0, :, :] = add_mod_plain(mul_add_mod_plain(
        vh, pk[0, :k], e0h, t.p, t.mu, t.k), m, t.p)
    out[..., 1, :, :] = mul_add_mod_plain(vh, pk[1, :k], e1h, t.p, t.mu, t.k)
