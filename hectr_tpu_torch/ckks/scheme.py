"""RNS-CKKS scheme operations (keygen, enc/dec, arithmetic, rescale).

The ``hectr_tpu/ckks/scheme.py`` API on int64 residue tensors:
ciphertexts and plaintexts live in the NTT (evaluation) domain as
[..., (2,) K, N] tensors, scales are exact Fractions.  Leading dims are
a batch of independent ciphertexts (the JAX package's vmapped
[B, 2, L, N]): every op takes them, a [K, N] operand (a key, a shared
plaintext) broadcasts over them, and each row gets exactly what the
unbatched op gives it.  Every op runs on the device of its input
tensors.

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
from hectr_tpu_torch.ckks.basecvt import base_conv_constants, base_convert
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.encoding import (
    MATRIX_MAX_SLOTS,
    coefficient_rows,
    coefficient_rows_plain,
    complex_tensor,
    device_embedding,
    encode_rows,
    on_card,
    unembed,
)
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    add_mod_plain,
    mul_add_mod,
    mul_add_mod_plain,
    mul_mod,
    neg_mod,
    sub_mod,
)
from hectr_tpu_torch.ckks.ntt import intt, ntt, ntt_plain
from hectr_tpu_torch.config import resolve_device
from hectr_tpu_torch.ops import codec_cuda, encrypt_cuda
from hectr_tpu_torch.utils import pmu
from hectr_tpu_torch.utils.pmu import span

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
    randomness.  Small coefficients are signed int64 [N] (or [dnum, N],
    [*batch, N]); uniform residues are int64 [..., K, N] below each
    row's prime."""

    def keygen(self, ctx: CKKSContext, device
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(s ternary [N], a uniform [K_max, N] NTT domain, e gauss [N])."""

    def encryption(self, ctx: CKKSContext, k: int, batch: tuple[int, ...],
                   device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(v ternary, e0 gauss, e1 gauss), each [*batch, N]: one
        encryption's draws per row of a batch of `batch` ciphertexts
        (batch () for one)."""

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

    def ternary(self, *shape: int) -> torch.Tensor:
        """{-1, 0, +1} with probabilities {1/4, 1/2, 1/4}."""
        r = torch.randint(0, 4, shape, generator=self.gen, device=self.device)
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

    def encryption(self, ctx, k, batch, device):
        # one draw of each kind for the whole batch: as many launches at
        # every batch size
        return (self.ternary(*batch, ctx.n), self.gauss(*batch, ctx.n),
                self.gauss(*batch, ctx.n))

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


@span("scheme.encrypt")
def encrypt(ctx: CKKSContext, keys: KeySet, pt: Plaintext,
            sampler: Sampler) -> Ciphertext:
    """Public-key encryption: (v pk0 + e0 + m, v pk1 + e1).  A plaintext
    [..., k, N] gives a ciphertext [..., 2, k, N], each row from its own
    draws of `sampler`.  On the card one K14 launch
    (``ops.encrypt_cuda``) for rings up to 2^15; larger rings there
    (counted in ``pmu.COUNTS["scheme.encrypt.composed"]``) and the CPU
    take ``encrypt_composed``."""
    k = pt.limbs
    device = pt.data.device
    t = ctx.tables(k, device)
    v, e0, e1 = (x.to(device) for x in sampler.encryption(
        ctx, k, tuple(pt.data.shape[:-2]), device))
    if on_card(pt.data):
        if t.n <= 1 << encrypt_cuda.MAX_LOGN:
            return Ciphertext(data=encrypt_cuda.encrypt(v, e0, e1, pt.data,
                                                        keys.pk, t),
                              scale=pt.scale)
        pmu.count("scheme.encrypt.composed")
    return Ciphertext(data=encrypt_composed(t, keys.pk, pt.data, v, e0, e1),
                      scale=pt.scale)


def encrypt_composed(t, pk: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """What K14 computes, op by op: the draws [..., N] to residues, their
    NTTs, (v pk0 + e0 + m, v pk1 + e1) stacked [..., 2, k, N].  Each op
    dispatches by device: on the card the NTT is K1 (or the sharded
    transform above 2^15) and the sums K9; on the CPU it is
    ``encrypt_plain``."""
    return _encrypt_with(ntt, add_mod, mul_add_mod, t, pk, m, (v, e0, e1))


def encrypt_plain(t, pk: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                  e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    """``encrypt_composed`` in plain PyTorch ops on any device (the plain
    transform and primitives): what K14 is held to on the card."""
    return _encrypt_with(ntt_plain, add_mod_plain, mul_add_mod_plain, t, pk,
                         m, (v, e0, e1))


def _encrypt_with(ntt_op, add_op, mul_add_op, t, pk, m, draws):
    k = len(t.primes)
    v, e0, e1 = (ntt_op(signed_to_residues(x, t.p), t) for x in draws)
    c0 = add_op(mul_add_op(v, pk[0, :k], e0, t.p, t.mu, t.k), m, t.p)
    c1 = mul_add_op(v, pk[1, :k], e1, t.p, t.mu, t.k)
    return torch.stack([c0, c1], dim=-3)


@span("scheme.decrypt")
def decrypt(ctx: CKKSContext, keys: KeySet, ct: Ciphertext) -> Plaintext:
    """m = c0 + c1 * s; returns the NTT-domain plaintext."""
    k = ct.limbs
    t = ctx.tables(k, ct.data.device)
    m = mul_add_mod(ct.data[..., 1, :, :], keys.sk[:k], ct.data[..., 0, :, :],
                    t.p, t.mu, t.k)
    return Plaintext(data=m, scale=ct.scale)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


@span("scheme.encode")
def encode(ctx: CKKSContext, v, k: int,
           scale: Fraction | None = None) -> Plaintext:
    """Slot values [..., slots] -> NTT-domain plaintext over the first k
    limbs at `scale` (default Delta).  v is an (re, im) pair of float64
    tensors or a complex array or tensor (a numpy array encodes on the
    CPU, a tensor on its device).  On the card: K11 (the embedding fused
    for slots <= 64), then K1."""
    if isinstance(v, tuple):
        vre, vim = v
    else:
        v = complex_tensor(v)
        vre, vim = v.real, v.imag
    scale = ctx.delta if scale is None else scale
    t = ctx.tables(k, vre.device)
    rows = encode_rows(vre, vim, ctx.slots, float(scale), t.p, ctx.n)
    return Plaintext(data=ntt(rows, t), scale=scale)


def encode_embedded(ctx: CKKSContext, m: torch.Tensor, k: int,
                    scale: Fraction | None = None) -> Plaintext:
    """Real subring coefficients m' [..., 2s] (the output of embed_ri) ->
    NTT-domain plaintext [..., k, N]: round(m' * scale), residues,
    spread to stride N/2s, NTT; K11's m' entry and K1 on the card."""
    scale = ctx.delta if scale is None else scale
    t = ctx.tables(k, m.device)
    return Plaintext(data=ntt(coefficient_rows(m, float(scale), t.p, ctx.n),
                              t), scale=scale)


def encode_embedded_plain(ctx: CKKSContext, m: torch.Tensor, k: int,
                          scale: Fraction | None = None) -> Plaintext:
    """``encode_embedded`` with its float64 pass in plain PyTorch ops."""
    scale = ctx.delta if scale is None else scale
    t = ctx.tables(k, m.device)
    return Plaintext(data=ntt(coefficient_rows_plain(m, float(scale), t.p,
                                                     ctx.n), t), scale=scale)


@span("scheme.decode_ri")
def decode_ri(ctx: CKKSContext, pt: Plaintext) -> tuple[torch.Tensor, torch.Tensor]:
    """NTT-domain plaintext [..., K, N] -> slot values as an (re, im)
    pair of float64 [..., slots] tensors, via the double-double
    fractional CRT over the base chain (limbs beyond it carry no
    information once value*scale < Q_base).  On the card: K2, then K12
    on the strided view of its rows (digits, CRT and, for slots <= 64,
    the unembedding in one launch)."""
    k = min(pt.limbs, len(ctx.base_primes))
    stride = ctx.n // (2 * ctx.slots)
    device = pt.data.device
    t = ctx.tables(k, device)
    coeffs = intt(pt.data[..., :k, :], t)[..., ::stride]  # [..., k, 2s]
    dc = ctx.decode_constants(k, pt.scale, device)
    if on_card(coeffs):
        return _crt_decode_card(ctx, coeffs, t.p, dc, (dc.inv, t.mu, t.k))
    c = mul_mod(coeffs, dc.inv, t.p, t.mu, t.k)          # CRT digits
    return crt_decode_plain(ctx, c, dc)


def crt_decode(ctx: CKKSContext, c: torch.Tensor,
               dc) -> tuple[torch.Tensor, torch.Tensor]:
    """CRT digits c [..., k, 2s] (a limb mesh's gathered digits) -> slot
    values (``crt_decode_plain``): K12's digits entry on the card."""
    if on_card(c):
        p = ctx.tables(c.shape[-2], c.device).p
        return _crt_decode_card(ctx, c, p, dc, None)
    return crt_decode_plain(ctx, c, dc)


def _crt_decode_card(ctx: CKKSContext, x: torch.Tensor, p: torch.Tensor, dc,
                     digit_consts) -> tuple[torch.Tensor, torch.Tensor]:
    """One K12 launch: unembedded in the kernel for slots <= 64, through
    the FFT branch's ``unembed`` above."""
    q = (dc.q_over_scale_hi, dc.q_over_scale_lo)
    if ctx.slots <= MATRIX_MAX_SLOTS:
        return codec_cuda.crt_decode(x, p, *q, digit_consts,
                                     device_embedding(ctx.slots, x.device))
    return unembed(codec_cuda.crt_decode(x, p, *q, digit_consts), ctx.slots)


def crt_decode_plain(ctx: CKKSContext, c: torch.Tensor,
                     dc) -> tuple[torch.Tensor, torch.Tensor]:
    """``crt_decode`` in plain PyTorch ops: ``crt_values_plain``,
    unembedded."""
    return unembed(crt_values_plain(c, dc), ctx.slots)


def crt_values_plain(c: torch.Tensor, dc) -> torch.Tensor:
    """CRT digits c [..., k, 2s] -> the coefficients over the scale y
    float64 [..., 2s]: the double-double sum of c_i / p_i over the rows in
    row order, its fractional part times Q/scale."""
    k = c.shape[-2]
    acc_hi = torch.zeros(c[..., 0, :].shape, dtype=torch.float64,
                         device=c.device)
    acc_lo = torch.zeros_like(acc_hi)
    for i in range(k):
        term = dd.dd_div_ff(c[..., i, :].to(torch.float64),
                            float(dc.p_f64[i, 0]))
        acc_hi, acc_lo = dd.dd_add((acc_hi, acc_lo), term)
    r = dd.dd_round((acc_hi, acc_lo))
    frac = dd.dd_add_f((acc_hi, acc_lo), -r)
    y = dd.dd_mul(frac, (dc.q_over_scale_hi, dc.q_over_scale_lo))
    return dd.dd_to_float(y)


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


@span("scheme.add")
def add(ctx: CKKSContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    t = _common(ctx, a, b)
    return Ciphertext(data=add_mod(a.data, b.data, t.p), scale=a.scale)


@span("scheme.sub")
def sub(ctx: CKKSContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    t = _common(ctx, a, b)
    return Ciphertext(data=sub_mod(a.data, b.data, t.p), scale=a.scale)


@span("scheme.neg")
def neg(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    t = ctx.tables(a.limbs, a.data.device)
    return Ciphertext(data=neg_mod(a.data, t.p), scale=a.scale)


@span("scheme.add_pt")
def add_pt(ctx: CKKSContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    if a.limbs != pt.limbs or a.scale != pt.scale:
        raise ValueError("plaintext level or scale differs from ciphertext")
    t = ctx.tables(a.limbs, a.data.device)
    c0 = add_mod(a.data[..., 0, :, :], pt.data, t.p)
    return Ciphertext(
        data=torch.stack([c0, a.data[..., 1, :, :].expand_as(c0)], dim=-3),
        scale=a.scale)


@span("scheme.mul_pt")
def mul_pt(ctx: CKKSContext, a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """ct x pt product; scales multiply (rescale separately)."""
    if a.limbs != pt.limbs:
        raise ValueError(f"{a.limbs} vs {pt.limbs} limbs")
    t = ctx.tables(a.limbs, a.data.device)
    return Ciphertext(data=mul_mod(a.data, pt.data.unsqueeze(-3), t.p, t.mu,
                                   t.k),
                      scale=a.scale * pt.scale)


def _drop_one(ctx: CKKSContext, data: torch.Tensor) -> torch.Tensor:
    """Exact-rescale one trailing limb of NTT-domain residues
    [..., K, N] -> [..., K-1, N]: (c - [c]_{p_d}) / p_d per limb.

    The centred last row is a base conversion from the one prime p_d to
    the first d primes (K6's one-group form on the card): with one source
    prime y = x and v = rint(x / p_d) is 1 exactly when x > p_d / 2 (x /
    p_d is never a tie: 1/(2 p_d) > 2^-31 is far above an ulp of 0.5), so
    x - v p_d mod p_t is the centred value's residue.  Its NTT, then
    (c - ext) p_d^-1 over the first d rows (K8, the mod-down's tail)."""
    from hectr_tpu_torch.ckks.keyswitch import mod_down_tail

    k = data.shape[-2]
    d = k - 1
    device = data.device
    inv, inv_sh, p_d = ctx.rescale_constants(k, device)
    t_out = ctx.tables(d, device)
    last = intt(data[..., d:d + 1, :], ctx.tables_row(d, device))
    consts = base_conv_constants((p_d,), ctx.data_primes[:d], device)
    ext = ntt(base_convert(last, consts), t_out)                # [..., d, N]
    return mod_down_tail(data[..., :d, :], ext, inv, inv_sh, t_out.p)


@span("scheme.rescale_pair")
def rescale_pair(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    """Divide by the trailing scale-prime pair (one CKKS level)."""
    k = a.limbs
    data = _drop_one(ctx, _drop_one(ctx, a.data))
    return Ciphertext(data=data, scale=a.scale / ctx.pair_scale(k))


@span("scheme.mod_down_pair")
def mod_down_pair(ctx: CKKSContext, a: Ciphertext) -> Ciphertext:
    """Drop the trailing scale pair WITHOUT dividing (he_moddown)."""
    return Ciphertext(data=a.data[..., :-2, :], scale=a.scale)


@span("scheme.mod_down_to")
def mod_down_to(ctx: CKKSContext, a: Ciphertext, k: int) -> Ciphertext:
    """Drop trailing limbs down to k without dividing."""
    if a.limbs < k:
        raise ValueError(f"cannot mod down {a.limbs} limbs to {k}")
    return Ciphertext(data=a.data[..., :k, :], scale=a.scale)
