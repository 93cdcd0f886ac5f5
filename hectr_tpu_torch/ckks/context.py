"""CKKS context: parameter preset -> prime chain and derived tables.

The chain is built exactly as in ``hectr_tpu/ckks/context.py`` (the same
search, the same order), so residues agree bit for bit across the two
packages:

    [ b_0, b_1 | s_0a, s_0b | s_1a, s_1b | ... | P_0 ... ]
      base (~2^30 each)   scale pairs (~2^25 each,     special primes
      decryption headroom  product ~ Delta = 2^50)     (key switching)

A ciphertext at level l carries the first 2 + 2l data limbs.  Scales
are exact Fractions.  Every device-resident table is cached per
(k, device); the numpy constants behind them are built once.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import torch

from hectr_tpu_torch.ckks.modmath import i64, shoup
from hectr_tpu_torch.ckks.ntt import NTTTables, ntt_tables
from hectr_tpu_torch.ckks.primes import find_ntt_primes, find_scale_prime_pairs
from hectr_tpu_torch.config import CKKSPreset, resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class DecodeConstants:
    """Per-limb fractional-CRT constants for a K-limb chain prefix."""

    inv: torch.Tensor       # [K, 1] int64: (Q/p_i)^-1 mod p_i
    p_f64: np.ndarray       # [K, 1] float64: p_i
    q_over_scale_hi: float
    q_over_scale_lo: float


@dataclasses.dataclass(eq=False)
class CKKSContext:
    preset: CKKSPreset
    n: int
    slots: int
    depth: int
    base_primes: tuple[int, ...]
    scale_primes: tuple[int, ...]    # flattened pairs, drop order = reversed
    special_primes: tuple[int, ...]

    @property
    def data_primes(self) -> tuple[int, ...]:
        return self.base_primes + self.scale_primes

    @property
    def full_primes(self) -> tuple[int, ...]:
        return self.data_primes + self.special_primes

    @property
    def delta(self) -> Fraction:
        return Fraction(1 << self.preset.scale_bits)

    @property
    def max_limbs(self) -> int:
        return len(self.data_primes)

    def limbs_at_level(self, level: int) -> int:
        if not 0 <= level <= self.depth:
            raise ValueError(f"level {level} outside 0..{self.depth}")
        return len(self.base_primes) + 2 * level

    def q_at(self, k: int) -> int:
        q = 1
        for p in self.data_primes[:k]:
            q *= p
        return q

    def pair_scale(self, k: int) -> Fraction:
        """Exact product of the trailing scale pair of a K-limb chain:
        what a rescale at this level divides by, and the scale a
        plaintext must carry for scale-neutral ct-pt products."""
        if k <= len(self.base_primes):
            raise ValueError(f"no scale pair left at {k} limbs")
        return Fraction(self.data_primes[k - 1] * self.data_primes[k - 2])

    # ---- hybrid key-switch digit grouping ----------------------------

    @property
    def alpha(self) -> int:
        """Key-switch digit width (limbs per digit group)."""
        return self.preset.digit_width

    def dnum(self, k: int) -> int:
        """Number of digit groups covering the first k data limbs."""
        return -(-k // self.alpha)

    @functools.cache
    def digit_groups(self, k: int) -> tuple[tuple[int, ...], ...]:
        """The primes of each digit group at k data limbs (fixed
        alpha-grid prefixes, so keys made at the top level slice to any
        level)."""
        a = self.alpha
        return tuple(tuple(self.data_primes[j * a:min((j + 1) * a, k)])
                     for j in range(self.dnum(k)))

    @property
    def special_product(self) -> int:
        P = 1
        for sp in self.special_primes:
            P *= sp
        return P

    # ---- cached device tables -----------------------------------------

    def tables(self, k: int, device) -> NTTTables:
        """NTT tables over the first k data limbs."""
        return ntt_tables(self.n, self.data_primes[:k], device)

    def tables_row(self, idx: int, device) -> NTTTables:
        """NTT tables for a single chain limb (data then special)."""
        return ntt_tables(self.n, (self.full_primes[idx],), device)

    def tables_full(self, device) -> NTTTables:
        return ntt_tables(self.n, self.full_primes, device)

    def tables_ks(self, k: int, device) -> NTTTables:
        """Tables over the first k data limbs + the special primes (the
        extended modulus inside key switching)."""
        return ntt_tables(self.n, self.data_primes[:k] + self.special_primes,
                          device)

    def tables_special(self, device) -> NTTTables:
        """Tables over the special primes only (mod-down input rows)."""
        return ntt_tables(self.n, self.special_primes, device)

    def primes_col(self, k: int, device) -> torch.Tensor:
        """[k, 1] int64 data primes."""
        return self.tables(k, device).p

    def decode_constants(self, k: int, scale: Fraction,
                         device) -> DecodeConstants:
        return self._decode_constants(k, scale, resolve_device(device))

    @functools.cache
    def _decode_constants(self, k: int, scale: Fraction,
                          device: torch.device) -> DecodeConstants:
        primes = self.data_primes[:k]
        q = self.q_at(k)
        inv = [pow((q // p) % p, -1, p) for p in primes]
        ratio = Fraction(q) / scale
        hi = float(ratio)
        lo = float(ratio - Fraction(hi))
        return DecodeConstants(
            inv=i64(np.array(inv).reshape(k, 1), device),
            p_f64=np.array(primes, dtype=np.float64).reshape(k, 1),
            q_over_scale_hi=hi, q_over_scale_lo=lo)

    def rescale_constants(self, k: int, device
                          ) -> tuple[torch.Tensor, torch.Tensor, int]:
        """For dropping limb d = k-1: ([d, 1] inverse of p_d mod p_j,
        its Shoup companion, p_d)."""
        return self._rescale_constants(k, resolve_device(device))

    @functools.cache
    def _rescale_constants(self, k: int, device: torch.device):
        d = k - 1
        p_d = self.data_primes[d]
        inv = np.array([pow(p_d % p, -1, p) for p in self.data_primes[:d]],
                       dtype=np.int64).reshape(d, 1)
        pj = np.array(self.data_primes[:d], dtype=np.int64).reshape(d, 1)
        return i64(inv, device), i64(shoup(inv, pj), device), p_d


@functools.lru_cache(maxsize=None)
def make_context(preset: CKKSPreset) -> CKKSContext:
    n = 1 << preset.logn
    two_n = 2 * n
    # special primes are drawn FIRST (the largest 30-bit NTT primes):
    # key-switch noise scales with (digit-group product) / (special
    # product), so the specials must dominate every width-alpha group
    special = tuple(find_ntt_primes(30, preset.special_limbs, two_n))
    base = tuple(find_ntt_primes(30, 2, two_n, avoid=set(special)))
    pairs = find_scale_prime_pairs(preset.scale_bits, preset.mult_depth,
                                   two_n, avoid=set(base) | set(special))
    scale_primes = tuple(q for pair in pairs for q in pair)
    ctx = CKKSContext(
        preset=preset, n=n, slots=preset.slots, depth=preset.mult_depth,
        base_primes=base, scale_primes=scale_primes, special_primes=special,
    )
    P = ctx.special_product
    for grp in ctx.digit_groups(ctx.max_limbs):
        Qj = 1
        for q in grp:
            Qj *= q
        if Qj > P:
            raise ValueError(
                f"digit group product {Qj.bit_length()}b exceeds special "
                f"product {P.bit_length()}b: raise special_limbs or lower "
                f"digit_width (preset {preset.name})")
    return ctx
