"""RNS-CKKS scheme operations (keygen, enc/dec, arithmetic, rescale).

The ``hectr_tpu/ckks/scheme.py`` API on int64 residue tensors:
ciphertexts and plaintexts live in the NTT (evaluation) domain as
[(2,) K, N] tensors, scales are exact Fractions.  Every op runs on the
device of its input tensors.

Randomness comes from a sampler object (``Sampler``): keygen draws a
ternary s, a uniform a and a gaussian e; each encryption draws v, e0
and e1; each switching key draws its a and e.  ``TorchSampler`` draws
from an explicit ``torch.Generator`` on the chosen device; a test can
hand in any other sampler, e.g. one that replays the JAX package's
draws, and then expect bit-identical keys and ciphertexts.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Protocol

import torch

from hectr_tpu_torch.ckks import dd
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.encoding import (
    complex_tensor,
    embed_ri,
    integer_residues,
    unembed,
)
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    mul_mod,
    mul_mod_shoup,
    neg_mod,
    sub_mod,
)
from hectr_tpu_torch.ckks.ntt import intt, ntt
from hectr_tpu_torch.config import resolve_device

SIGMA = 3.2  # RLWE noise standard deviation (standard CKKS choice)


@dataclasses.dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor  # int64 [K, N], NTT domain
    scale: Fraction

    @property
    def limbs(self) -> int:
        return self.data.shape[-2]


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor  # int64 [2, K, N], NTT domain
    scale: Fraction

    @property
    def limbs(self) -> int:
        return self.data.shape[-2]


@dataclasses.dataclass(frozen=True)
class KeySet:
    """Secret/public keys.  sk spans the full chain (data + special) so
    key-switch material can be generated against it."""

    sk: torch.Tensor   # int64 [L_full, N], NTT domain
    pk: torch.Tensor   # int64 [2, L_data_max, N], NTT domain


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


class Sampler(Protocol):
    """Where keygen, encrypt and switching-key generation draw their
    randomness.  Small coefficients are signed int64 [N] (or [dnum, N]);
    uniform residues are int64 [..., K, N] below each row's prime."""

    def keygen(self, ctx: CKKSContext, device
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(s ternary [N], a uniform [K_max, N] NTT domain, e gauss [N])."""

    def encryption(self, ctx: CKKSContext, k: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(v ternary [N], e0 gauss [N], e1 gauss [N])."""

    def switching_key(self, ctx: CKKSContext, dnum: int,
                      primes: tuple[int, ...], device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(a uniform [dnum, len(primes), N], e gauss [dnum, N])."""


class TorchSampler:
    """The default sampler: one explicit torch.Generator on `device`."""

    def __init__(self, seed: int, device):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def ternary(self, n: int) -> torch.Tensor:
        """{-1, 0, +1} with probabilities {1/4, 1/2, 1/4}."""
        r = torch.randint(0, 4, (n,), generator=self.gen, device=self.device)
        return (r == 3).to(torch.int64) - (r == 0).to(torch.int64)

    def gauss(self, *shape: int) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, dtype=torch.float64,
                        device=self.device)
        return torch.round(SIGMA * x).to(torch.int64)

    def uniform(self, primes, *lead: int, n: int) -> torch.Tensor:
        """Uniform residues [*lead, len(primes), n]."""
        rows = [torch.randint(0, p, (*lead, n), generator=self.gen,
                              device=self.device) for p in primes]
        return torch.stack(rows, dim=-2)

    def keygen(self, ctx, device):
        s = self.ternary(ctx.n)
        a = self.uniform(ctx.data_primes, n=ctx.n)
        e = self.gauss(ctx.n)
        return s, a, e

    def encryption(self, ctx, k, device):
        return self.ternary(ctx.n), self.gauss(ctx.n), self.gauss(ctx.n)

    def switching_key(self, ctx, dnum, primes, device):
        return self.uniform(primes, dnum, n=ctx.n), self.gauss(dnum, ctx.n)


def signed_to_residues(x: torch.Tensor, primes_col: torch.Tensor) -> torch.Tensor:
    """Small signed int64 coefficients [..., N] -> residues
    [..., K, N] (floor-mod, as jnp.mod)."""
    return torch.remainder(x[..., None, :], primes_col)


# ---------------------------------------------------------------------------
# keygen / encrypt / decrypt
# ---------------------------------------------------------------------------


def keygen(ctx: CKKSContext, sampler: Sampler, device) -> KeySet:
    """Generate (sk, pk): sk ternary; pk = (-a s + e, a) mod Q_max."""
    device = resolve_device(device)
    s, a, e = (x.to(device) for x in sampler.keygen(ctx, device))
    tf = ctx.tables_full(device)
    sk = ntt(signed_to_residues(s, tf.p), tf)
    td = ctx.tables(ctx.max_limbs, device)
    e = ntt(signed_to_residues(e, td.p), td)
    b = sub_mod(e, mul_mod(a, sk[:ctx.max_limbs], td.p, td.mu, td.k), td.p)
    return KeySet(sk=sk, pk=torch.stack([b, a]))


def encrypt(ctx: CKKSContext, keys: KeySet, pt: Plaintext,
            sampler: Sampler) -> Ciphertext:
    """Public-key encryption: (v pk0 + e0 + m, v pk1 + e1)."""
    k = pt.limbs
    device = pt.data.device
    t = ctx.tables(k, device)
    v, e0, e1 = (ntt(signed_to_residues(x.to(device), t.p), t)
                 for x in sampler.encryption(ctx, k, device))
    pk0 = keys.pk[0, :k]
    pk1 = keys.pk[1, :k]
    c0 = add_mod(add_mod(mul_mod(v, pk0, t.p, t.mu, t.k), e0, t.p),
                 pt.data, t.p)
    c1 = add_mod(mul_mod(v, pk1, t.p, t.mu, t.k), e1, t.p)
    return Ciphertext(data=torch.stack([c0, c1]), scale=pt.scale)


def decrypt(ctx: CKKSContext, keys: KeySet, ct: Ciphertext) -> Plaintext:
    """m = c0 + c1 * s; returns the NTT-domain plaintext."""
    k = ct.limbs
    t = ctx.tables(k, ct.data.device)
    m = add_mod(ct.data[0],
                mul_mod(ct.data[1], keys.sk[:k], t.p, t.mu, t.k), t.p)
    return Plaintext(data=m, scale=ct.scale)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def encode(ctx: CKKSContext, v, k: int,
           scale: Fraction | None = None) -> Plaintext:
    """Slot values [..., slots] -> NTT-domain plaintext over the first k
    limbs at `scale` (default Delta).  v is an (re, im) pair of float64
    tensors or a complex array or tensor (a numpy array encodes on the
    CPU, a tensor on its device)."""
    if isinstance(v, tuple):
        vre, vim = v
    else:
        v = complex_tensor(v)
        vre, vim = v.real, v.imag
    return encode_embedded(ctx, embed_ri(vre, vim, ctx.slots), k, scale)


def encode_embedded(ctx: CKKSContext, m: torch.Tensor, k: int,
                    scale: Fraction | None = None) -> Plaintext:
    """Real subring coefficients m' [..., 2s] (the output of embed_ri) ->
    NTT-domain plaintext [..., k, N]: round(m' * scale), residues,
    spread to stride N/2s, NTT."""
    scale = ctx.delta if scale is None else scale
    stride = ctx.n // (2 * ctx.slots)
    t = ctx.tables(k, m.device)
    y = torch.round(m * float(scale))
    res = integer_residues(y, t.p)                       # [..., k, 2s]
    coeffs = torch.zeros((*res.shape[:-1], ctx.n), dtype=torch.int64,
                         device=m.device)
    coeffs[..., ::stride] = res
    return Plaintext(data=ntt(coeffs, t), scale=scale)


def decode_ri(ctx: CKKSContext, pt: Plaintext) -> tuple[torch.Tensor, torch.Tensor]:
    """NTT-domain plaintext [..., K, N] -> slot values as an (re, im)
    pair of float64 [..., slots] tensors, via the double-double
    fractional CRT over the base chain (limbs beyond it carry no
    information once value*scale < Q_base)."""
    k = min(pt.limbs, len(ctx.base_primes))
    stride = ctx.n // (2 * ctx.slots)
    device = pt.data.device
    t = ctx.tables(k, device)
    coeffs = intt(pt.data[..., :k, :], t)[..., ::stride]  # [..., k, 2s]
    dc = ctx.decode_constants(k, pt.scale, device)
    c = mul_mod(coeffs, dc.inv, t.p, t.mu, t.k)          # CRT digits
    acc_hi = torch.zeros(c[..., 0, :].shape, dtype=torch.float64, device=device)
    acc_lo = torch.zeros_like(acc_hi)
    for i in range(k):
        term = dd.dd_div_ff(c[..., i, :].to(torch.float64),
                            float(dc.p_f64[i, 0]))
        acc_hi, acc_lo = dd.dd_add((acc_hi, acc_lo), term)
    r = dd.dd_round((acc_hi, acc_lo))
    frac = dd.dd_add_f((acc_hi, acc_lo), -r)
    y = dd.dd_mul(frac, (dc.q_over_scale_hi, dc.q_over_scale_lo))
    return unembed(dd.dd_to_float(y), ctx.slots)


def decode(ctx: CKKSContext, pt: Plaintext) -> torch.Tensor:
    """NTT-domain plaintext -> complex128 slot values [..., slots]."""
    re, im = decode_ri(ctx, pt)
    return torch.complex(re, im)


# ---------------------------------------------------------------------------
# homomorphic arithmetic
# ---------------------------------------------------------------------------


def _common(ctx: CKKSContext, a: Ciphertext, b: Ciphertext):
    if a.limbs != b.limbs or a.scale != b.scale:
        raise ValueError(f"operands differ: {a.limbs} vs {b.limbs} limbs, "
                         f"scales {a.scale} vs {b.scale}")
    return ctx.tables(a.limbs, a.data.device)


def add(ctx: CKKSContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    t = _common(ctx, a, b)
    return Ciphertext(data=add_mod(a.data, b.data, t.p), scale=a.scale)


def sub(ctx: CKKSContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    t = _common(ctx, a, b)
    return Ciphertext(data=sub_mod(a.data, b.data, t.p), scale=a.scale)


def neg(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    t = ctx.tables(a.limbs, a.data.device)
    return Ciphertext(data=neg_mod(a.data, t.p), scale=a.scale)


def add_pt(ctx: CKKSContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    if a.limbs != pt.limbs or a.scale != pt.scale:
        raise ValueError("plaintext level or scale differs from ciphertext")
    t = ctx.tables(a.limbs, a.data.device)
    return Ciphertext(
        data=torch.stack([add_mod(a.data[0], pt.data, t.p), a.data[1]]),
        scale=a.scale)


def mul_pt(ctx: CKKSContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """ct x pt product; scales multiply (rescale separately)."""
    if a.limbs != pt.limbs:
        raise ValueError(f"{a.limbs} vs {pt.limbs} limbs")
    t = ctx.tables(a.limbs, a.data.device)
    return Ciphertext(data=mul_mod(a.data, pt.data[None], t.p, t.mu, t.k),
                      scale=a.scale * pt.scale)


def _drop_one(ctx: CKKSContext, data: torch.Tensor) -> torch.Tensor:
    """Exact-rescale one trailing limb of NTT-domain residues
    [..., K, N] -> [..., K-1, N]: (c - [c]_{p_d}) / p_d per limb."""
    k = data.shape[-2]
    d = k - 1
    device = data.device
    inv, inv_sh, p_d = ctx.rescale_constants(k, device)
    t_out = ctx.tables(d, device)
    last = intt(data[..., d:d + 1, :], ctx.tables_row(d, device))
    centered = torch.where(last > p_d // 2, last - p_d, last)   # (-p/2, p/2]
    ext = ntt(torch.remainder(centered, t_out.p), t_out)        # [..., d, N]
    diff = sub_mod(data[..., :d, :], ext, t_out.p)
    return mul_mod_shoup(diff, inv, inv_sh, t_out.p)


def rescale_pair(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    """Divide by the trailing scale-prime pair (one CKKS level)."""
    k = a.limbs
    data = _drop_one(ctx, _drop_one(ctx, a.data))
    return Ciphertext(data=data, scale=a.scale / ctx.pair_scale(k))


def mod_down_pair(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    """Drop the trailing scale pair WITHOUT dividing (he_moddown)."""
    return Ciphertext(data=a.data[..., :-2, :], scale=a.scale)


def mod_down_to(ctx: CKKSContext, a: Ciphertext, k: int) -> Ciphertext:
    """Drop trailing limbs down to k without dividing."""
    if a.limbs < k:
        raise ValueError(f"cannot mod down {a.limbs} limbs to {k}")
    return Ciphertext(data=a.data[..., :k, :], scale=a.scale)
