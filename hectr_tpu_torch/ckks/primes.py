"""NTT-friendly prime chains and roots of unity (host side, exact ints).

The same search as ``hectr_tpu/ckks/primes.py``, so both packages build
the same chains.  Primality and primitive roots are plain Python here
(deterministic Miller-Rabin, trial-division factoring of p-1), so the
port needs no computer-algebra package; ``primitive_root`` returns the
smallest generator, as the reference's does, which fixes psi and so
every twiddle table.
"""

from __future__ import annotations

# Miller-Rabin with these bases is deterministic below 3.3e24, far
# beyond the < 2^31 moduli used here.
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for b in _MR_BASES:
        if n % b == 0:
            return n == b
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(bits: int, count: int, two_n: int,
                    avoid: set[int] | None = None) -> list[int]:
    """Find `count` primes p ≡ 1 (mod two_n) just below 2**bits,
    scanning downward (deterministic for reproducible contexts)."""
    avoid = avoid or set()
    out = []
    p = (1 << bits) - (1 << bits) % two_n + 1
    while len(out) < count:
        if p < (1 << (bits - 1)):
            raise RuntimeError(f"not enough {bits}-bit NTT primes")
        if p not in avoid and is_prime(p):
            out.append(p)
        p -= two_n
    return out


def find_scale_prime_pairs(scale_bits: int, pairs: int, two_n: int,
                           avoid: set[int] | None = None
                           ) -> list[tuple[int, int]]:
    """Find `pairs` of primes (p, q), each ≡ 1 mod two_n, with p*q as
    close to 2**scale_bits as possible (composite rescaling: dividing a
    ciphertext by p*q drops the scale by ~2**scale_bits)."""
    avoid = set(avoid or set())
    half = scale_bits // 2
    out = []
    target = 1 << scale_bits
    p = (1 << half) + 1  # scan upward from 2^half
    p += (-(p - 1)) % two_n
    while len(out) < pairs:
        # Gather ~32 candidate p's, find each one's closest-prime
        # partner, keep the globally best-balanced pair.
        cands = []
        scan = p
        while len(cands) < 32:
            if scan >= (1 << (half + 2)):
                raise RuntimeError("not enough scale primes")
            if scan not in avoid and is_prime(scan):
                cands.append(scan)
            scan += two_n
        best_pair = None
        for cp in cands:
            q0 = target // cp
            q0 -= (q0 - 1) % two_n
            partner = None
            for delta in range(0, 400):
                for q in (q0 + delta * two_n, q0 - delta * two_n):
                    if q > 2 and q != cp and q not in avoid and is_prime(q):
                        if partner is None or abs(cp * q - target) < abs(cp * partner - target):
                            partner = q
                if partner is not None:
                    break
            if partner is not None:
                err = abs(cp * partner - target)
                if best_pair is None or err < best_pair[0]:
                    best_pair = (err, cp, partner)
        if best_pair is None:
            raise RuntimeError("no balanced scale-prime pair found")
        _, cp, cq = best_pair
        out.append((cp, cq))
        avoid.add(cp)
        avoid.add(cq)
    return out


def _prime_factors(n: int) -> list[int]:
    out = []
    f = 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1 if f == 2 else 2
    if n > 1:
        out.append(n)
    return out


def primitive_root(p: int) -> int:
    """Smallest generator of Z_p^* (p prime)."""
    factors = _prime_factors(p - 1)
    g = 2 if p > 2 else 1
    while any(pow(g, (p - 1) // q, p) == 1 for q in factors):
        g += 1
    return g


def root_of_unity(p: int, order: int) -> int:
    """A primitive `order`-th root of unity mod p (order | p-1)."""
    if (p - 1) % order:
        raise ValueError(f"order {order} does not divide p-1 for p={p}")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w
