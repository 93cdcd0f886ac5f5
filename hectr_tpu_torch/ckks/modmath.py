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

Dispatch is by the operands' device, as in ``ckks.ntt``: on a CUDA device
each primitive is one launch of the hand-written kernel K9 and the group
sum ``mod_product_sum`` one pass of K10 (``hectr_tpu_torch.ops.rns_cuda``),
which raise on what they do not take; on the CPU each runs its plain
version, ``<name>_plain`` beside it, the reference the kernels are held
to.  The plain versions of the other kernels (``ntt_plain``,
``grouped_convert_plain``, ...) call the ``_plain`` primitives, so they
stay plain PyTorch on the card too.
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ops import rns_cuda


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


def _on_card(*operands) -> bool:
    """Where a primitive runs: True for operands on a CUDA device (the
    kernels K9/K10, ``hectr_tpu_torch.ops.rns_cuda``, which raise on what
    they do not take), False on the CPU (the plain versions); any other
    device raises.  The first tensor operand decides."""
    for x in operands:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                return True
            if x.is_cpu:
                return False
            raise NotImplementedError(f"no modular arithmetic for device "
                                      f"{x.device}")
    return False


def add_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p elementwise; a, b already reduced."""
    if _on_card(a, b):
        return rns_cuda.rns_map("add_mod", a, b, p)
    return add_mod_plain(a, b, p)


def add_mod_plain(a, b, p):
    """``add_mod`` in plain PyTorch ops."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def add_mod_perm(a: torch.Tensor, perm: torch.Tensor, b: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """add_mod(a.index_select(-1, perm), b, p): a's columns taken through
    the permutation `perm` (int64 [N]; an evaluation-domain Galois
    automorphism), read in place by K9 on the card."""
    if _on_card(a, b):
        return rns_cuda.rns_map("add_mod", a, b, p, perm=perm)
    return add_mod_perm_plain(a, perm, b, p)


def add_mod_perm_plain(a, perm, b, p):
    """``add_mod_perm`` in plain PyTorch ops."""
    return add_mod_plain(a.index_select(-1, perm), b, p)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p elementwise; a, b already reduced."""
    if _on_card(a, b):
        return rns_cuda.rns_map("sub_mod", a, b, p)
    return sub_mod_plain(a, b, p)


def sub_mod_plain(a, b, p):
    """``sub_mod`` in plain PyTorch ops."""
    d = a + p - b
    return torch.where(d >= p, d - p, d)


def neg_mod(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(-a) mod p elementwise."""
    if _on_card(a):
        return rns_cuda.rns_map("neg_mod", a, p)
    return neg_mod_plain(a, p)


def neg_mod_plain(a, p):
    """``neg_mod`` in plain PyTorch ops."""
    return torch.where(a == 0, torch.zeros_like(a), p - a)


def _barrett(prod: torch.Tensor, p, mu, k) -> torch.Tensor:
    """Reduce 0 <= prod < 4^k mod p (< 2^30) via Barrett."""
    q = ((prod >> (k - 2)) * mu) >> (k + 2)
    r = prod - q * p
    r = torch.where(r >= p, r - p, r)
    return torch.where(r >= p, r - p, r)


def mul_mod(a: torch.Tensor, b: torch.Tensor, p, mu, k) -> torch.Tensor:
    """(a * b) mod p elementwise via Barrett."""
    if _on_card(a, b):
        return rns_cuda.rns_map("mul_mod", a, b, p, mu, k)
    return mul_mod_plain(a, b, p, mu, k)


def mul_mod_plain(a, b, p, mu, k):
    """``mul_mod`` in plain PyTorch ops."""
    return _barrett(a * b, p, mu, k)


def mul_add_mod(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, p, mu,
                k) -> torch.Tensor:
    """add_mod(mul_mod(a, b), c): the fused multiply-add of encryption,
    decryption and the ct x ct product, one K9 launch on the card."""
    if _on_card(a, b, c):
        return rns_cuda.rns_map("mul_add_mod", a, b, c, p, mu, k)
    return mul_add_mod_plain(a, b, c, p, mu, k)


def mul_add_mod_plain(a, b, c, p, mu, k):
    """``mul_add_mod`` in plain PyTorch ops."""
    return add_mod_plain(mul_mod_plain(a, b, p, mu, k), c, p)


def sum_mod(a: torch.Tensor, dim: int, p, mu, k) -> torch.Tensor:
    """Sum reduced residues along `dim`, then one Barrett pass.  Valid
    while (dim size) * p < 4^k, i.e. fewer than ~2^(k-1) terms -- any
    realistic digit count."""
    return _barrett(a.sum(dim), p, mu, k)


def mod_product_sum(C: torch.Tensor, w: torch.Tensor, dim: int, p, mu,
                    k) -> torch.Tensor:
    """sum_mod(mul_mod(C, w), dim): the BSGS group sum, one K10 pass on the
    card that never forms the product stack.  p, mu, k must not vary
    along `dim`."""
    if _on_card(C, w):
        return rns_cuda.mod_product_sum(C, w, dim, p, mu, k)
    return mod_product_sum_plain(C, w, dim, p, mu, k)


def mod_product_sum_plain(C, w, dim, p, mu, k):
    """``mod_product_sum`` in plain PyTorch ops."""
    return sum_mod(mul_mod_plain(C, w, p, mu, k), dim, p, mu, k)


def mul_mod_shoup(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p with w' = floor(w*2^32/p); requires w < p and
    a < p."""
    if _on_card(a, w):
        return rns_cuda.rns_map("mul_mod_shoup", a, w, w_shoup, p)
    return mul_mod_shoup_plain(a, w, w_shoup, p)


def mul_mod_shoup_plain(a, w, w_shoup, p):
    """``mul_mod_shoup`` in plain PyTorch ops."""
    q = (a * w_shoup) >> 32
    r = a * w - q * p
    return torch.where(r >= p, r - p, r)


def mul_mod_shoup_wide(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p for any 0 <= a < 2^31, not necessarily reduced mod
    p (base conversion multiplies residues of one prime by constants
    mod a different, possibly smaller, prime -- outside Barrett's
    domain).  The Shoup quotient errs by < a/2^32 + 1, so r < 3p and
    two corrections suffice."""
    if _on_card(a, w):
        return rns_cuda.rns_map("mul_mod_shoup_wide", a, w, w_shoup, p)
    return mul_mod_shoup_wide_plain(a, w, w_shoup, p)


def mul_mod_shoup_wide_plain(a, w, w_shoup, p):
    """``mul_mod_shoup_wide`` in plain PyTorch ops."""
    q = (a * w_shoup) >> 32
    r = a * w - q * p
    r = torch.where(r >= p, r - p, r)
    return torch.where(r >= p, r - p, r)


def mul_mod_shoup_lazy(a: torch.Tensor, w, w_shoup, p) -> torch.Tensor:
    """(a * w) mod p + {0, p} in [0, 2p) with no correction, for any
    0 <= a < 2^31 (e.g. a lazy value in [0, 2p)) and w < p: the
    primitive of the CUDA kernels' butterflies (csrc/modmath.cuh)."""
    if _on_card(a, w):
        return rns_cuda.rns_map("mul_mod_shoup_lazy", a, w, w_shoup, p)
    return mul_mod_shoup_lazy_plain(a, w, w_shoup, p)


def mul_mod_shoup_lazy_plain(a, w, w_shoup, p):
    """``mul_mod_shoup_lazy`` in plain PyTorch ops."""
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
