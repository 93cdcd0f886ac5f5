"""Vectorized modular arithmetic over RNS limb tensors.

The contracts of ``hectr_tpu/ckks/modmath.py``, evaluated on int64
tensors.  PyTorch implements neither add nor shift nor compare for
uint32, but every modulus is below 2^30, so each intermediate below
stays exact in signed int64 and no wrapping-u32 trick is needed:

  * Barrett with per-limb (mu, k): q = ((ab >> (k-2)) * mu) >> (k+2),
    mu = floor(4^k / p), k = bitlen(p).  For ab < p^2 the product
    (ab >> (k-2)) * mu is below 2^(2k+3) <= 2^63 at k <= 30; at most two
    correction subtractions.  DOMAIN: both operands reduced mod p.
  * Shoup for precomputed constants: q = (a * w') >> 32,
    r = a*w - q*p with w' = floor(w * 2^32 / p); r lies in [0, 2p) for
    a < p (one correction) and in [0, 3p) for any a < 2^31 (two).

Residues are int64 tensors of shape [..., L, N]; per-limb constants are
int64 tensors [L, 1] on the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def barrett_constants(primes: list[int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-limb (p, mu, k) int64 arrays shaped [L, 1].
    mu = floor(4^k / p), k = bitlen(p)."""
    ps, mus, ks = [], [], []
    for p in primes:
        if not 2 < p < (1 << 30):
            raise ValueError(f"modulus {p} out of supported range")
        k = p.bit_length()
        ps.append(p)
        mus.append((1 << (2 * k)) // p)
        ks.append(k)
    shape = (len(primes), 1)
    return (np.array(ps, dtype=np.int64).reshape(shape),
            np.array(mus, dtype=np.int64).reshape(shape),
            np.array(ks, dtype=np.int64).reshape(shape))


def shoup(w: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Shoup companions w' = floor(w * 2^32 / p) (exact, host-side
    object ints); values < 2^32 for w < p, held as int64."""
    return ((w.astype(object) << 32) // p.astype(object)).astype(np.int64)


def i64(a, device) -> torch.Tensor:
    """Host constants (any integer array-like) -> int64 tensor on
    `device`."""
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def add_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p elementwise; a, b already reduced."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p elementwise; a, b already reduced."""
    d = a + p - b
    return torch.where(d >= p, d - p, d)


def neg_mod(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(-a) mod p elementwise."""
    return torch.where(a == 0, torch.zeros_like(a), p - a)


def _barrett(prod: torch.Tensor, p, mu, k) -> torch.Tensor:
    """Reduce 0 <= prod < 4^k mod p (< 2^30) via Barrett."""
    q = ((prod >> (k - 2)) * mu) >> (k + 2)
    r = prod - q * p
    r = torch.where(r >= p, r - p, r)
    return torch.where(r >= p, r - p, r)


def mul_mod(a: torch.Tensor, b: torch.Tensor, p, mu, k) -> torch.Tensor:
    """(a * b) mod p elementwise via Barrett."""
    return _barrett(a * b, p, mu, k)


def sum_mod(a: torch.Tensor, dim: int, p, mu, k) -> torch.Tensor:
    """Sum reduced residues along `dim`, then one Barrett pass.  Valid
    while (dim size) * p < 4^k, i.e. fewer than ~2^(k-1) terms -- any
    realistic digit count."""
    return _barrett(a.sum(dim), p, mu, k)


def mul_mod_shoup(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p with w' = floor(w*2^32/p); requires w < p and
    a < p."""
    q = (a * w_shoup) >> 32
    r = a * w - q * p
    return torch.where(r >= p, r - p, r)


def mul_mod_shoup_wide(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p for any 0 <= a < 2^31, not necessarily reduced mod
    p (base conversion multiplies residues of one prime by constants
    mod a different, possibly smaller, prime -- outside Barrett's
    domain).  The Shoup quotient errs by < a/2^32 + 1, so r < 3p and
    two corrections suffice."""
    q = (a * w_shoup) >> 32
    r = a * w - q * p
    r = torch.where(r >= p, r - p, r)
    return torch.where(r >= p, r - p, r)


def mul_mod_shoup_lazy(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p + {0, p} in [0, 2p) with no correction, for any
    0 <= a < 2^31 (e.g. a lazy value in [0, 2p)) and w < p: the
    primitive of the CUDA kernels' butterflies (csrc/modmath.cuh)."""
    q = (a * w_shoup) >> 32
    return a * w - q * p


def to_rns(coeffs_obj, primes) -> torch.Tensor:
    """Host oracle: exact signed big-int coefficients [N] -> int64
    residues [L, N] (CPU), in exact object-integer arithmetic."""
    c = np.asarray(coeffs_obj, dtype=object)
    return torch.from_numpy(np.stack([(c % p).astype(np.int64)
                                      for p in primes]))


def from_rns(res, primes) -> np.ndarray:
    """Host oracle: residues [L, N] (int64 tensor or array) -> exact
    centered big-int coefficients (object array [N]) by CRT."""
    res = np.asarray(res.cpu() if isinstance(res, torch.Tensor) else res)
    q = 1
    for p in primes:
        q *= p
    acc = np.zeros(res.shape[1], dtype=object)
    for i, p in enumerate(primes):
        qi = q // p
        inv = pow(qi % p, -1, p)
        acc = (acc + res[i].astype(object) * inv % p * qi) % q
    return np.where(acc > q // 2, acc - q, acc)
