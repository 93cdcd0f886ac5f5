"""Key switching and Galois rotations (hybrid RNS, dnum digit grouping,
ns >= 1 special primes), as ``hectr_tpu/ckks/keyswitch.py``.

  * Digit decomposition: data limbs are grouped on a fixed alpha-grid;
    digit j is the centered representative of c modulo the group
    product Q_j, base-extended to the chain + specials.
  * The switching key for s' -> s has, for digit j,
        ksk_j = ( -a_j s + e_j + gad_j * s',  a_j )   over Q_max * P,
    with gad_j[t] = (P mod p_t) on the limbs of group j, else 0; one key
    made at the top level serves every level by slicing rows.  Keys are
    stored with their Shoup companions, [dnum, 4, K+S, N] with rows
    0:2 = (b, a) and 2:4 = floor((b, a) * 2^32 / p), or in the compact
    layout [dnum, 2, K+S, N] without them (half the memory; the inner
    product then multiplies by Barrett).
  * Key switch: decompose + extend digits, NTT, inner product with the
    key (one sum + one Barrett pass), then divide by P with centered
    rounding.
  * Galois automorphisms X -> X^{5^r} act in the evaluation domain as a
    precomputed index permutation.
  * ct x ct multiplication: tensor product (d0, d1, d2), then d2 is
    switched from s^2 to s with the relinearisation key.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hectr_tpu_torch.ckks.basecvt import (
    base_conv_constants,
    base_convert,
    grouped_conv_constants,
    grouped_convert,
)
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.modmath import (
    add_mod,
    add_mod_perm,
    i64,
    mul_add_mod,
    mul_mod,
    mul_mod_plain,
    mul_mod_shoup_plain,
    shoup,
    sub_mod,
    sub_mod_plain,
    sum_mod,
)
from hectr_tpu_torch.ckks.ntt import bit_reverse_indices, intt, ntt
from hectr_tpu_torch.ckks.scheme import Ciphertext, KeySet, Sampler
from hectr_tpu_torch.config import resolve_device
from hectr_tpu_torch.utils.pmu import span


# ---------------------------------------------------------------------------
# evaluation-domain Galois permutations
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _eval_exponents(n: int) -> np.ndarray:
    """Exponent e_i such that NTT output index i holds m(psi^{e_i}):
    e_i = 2*bitreverse(i) + 1 for the merged-psi CT transform."""
    return (2 * bit_reverse_indices(n) + 1) % (2 * n)


@functools.lru_cache(maxsize=None)
def eval_permutation(n: int, g: int) -> np.ndarray:
    """Permutation perm with NTT(sigma_g(m))[i] = NTT(m)[perm[i]],
    where sigma_g: X -> X^g (g odd)."""
    e = _eval_exponents(n)
    pos = {int(exp): i for i, exp in enumerate(e)}
    return np.array([pos[int(exp) * g % (2 * n)] for exp in e], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _perm_tensor(n: int, g: int, device: torch.device) -> torch.Tensor:
    return i64(eval_permutation(n, g), device)


def permutation(n: int, g: int, device) -> torch.Tensor:
    """eval_permutation as an int64 index tensor on `device` (cached)."""
    return _perm_tensor(n, g, resolve_device(device))


def galois_element(r: int, n: int) -> int:
    """Galois element for a left-rotation by r slots: 5^r mod 2N."""
    return pow(5, r, 2 * n)


def apply_automorphism(data: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply an evaluation-domain Galois permutation to NTT-domain
    residues [..., N]."""
    return data.index_select(-1, perm)


# ---------------------------------------------------------------------------
# switching keys
# ---------------------------------------------------------------------------


@functools.cache
def _gadget_np(ctx: CKKSContext) -> np.ndarray:
    """[dnum, lf, 1]: (P mod p_t) on group-j limbs of digit j."""
    kd = ctx.max_limbs
    ns = len(ctx.special_primes)
    a = ctx.alpha
    P = ctx.special_product
    gad = np.zeros((ctx.dnum(kd), kd + ns, 1), dtype=np.int64)
    for j in range(ctx.dnum(kd)):
        for t in range(j * a, min((j + 1) * a, kd)):
            gad[j, t, 0] = P % ctx.data_primes[t]
    return gad


def _gen_switching_key(ctx: CKKSContext, sk_full: torch.Tensor,
                       s_prime: torch.Tensor, sampler: Sampler,
                       compact: bool = False) -> torch.Tensor:
    """Key switching s' -> s: int64 [dnum, 4, K+S, N] over the full data
    chain + special primes (rows 0:2 = (b, a), 2:4 = their Shoup
    companions), or [dnum, 2, K+S, N] when `compact` (no companions).
    sk_full, s_prime: NTT-domain secrets over the full chain."""
    kd = ctx.max_limbs
    lf = kd + len(ctx.special_primes)
    dnum = ctx.dnum(kd)
    device = sk_full.device
    t = ctx.tables_ks(kd, device)
    chain = ctx.data_primes + ctx.special_primes
    a, e = (x.to(device) for x in
            sampler.switching_key(ctx, dnum, chain, device))
    e_ntt = ntt(torch.remainder(e[:, None, :], t.p), t)   # [dnum, lf, N]
    b = sub_mod(e_ntt, mul_mod(a, sk_full[None, :lf], t.p, t.mu, t.k), t.p)
    gad = i64(_gadget_np(ctx), device)
    b = add_mod(b, mul_mod(s_prime[None, :lf], gad, t.p, t.mu, t.k), t.p)
    ba = torch.stack([b, a], dim=1)                       # [dnum, 2, lf, N]
    if compact:
        return ba
    sh = torch.div(ba << 32, t.p, rounding_mode="floor")
    return torch.cat([ba, sh], dim=1)                     # [dnum, 4, lf, N]


def gen_relin_key(ctx: CKKSContext, keys: KeySet, sampler: Sampler,
                  compact: bool = False) -> torch.Tensor:
    """Switching key for s^2 -> s (ct x ct multiplication), one draw
    from `sampler`."""
    lf = ctx.max_limbs + len(ctx.special_primes)
    t = ctx.tables_ks(ctx.max_limbs, keys.sk.device)
    s2 = mul_mod(keys.sk[:lf], keys.sk[:lf], t.p, t.mu, t.k)
    return _gen_switching_key(ctx, keys.sk, s2, sampler, compact)


def _key_bytes(ctx: CKKSContext, compact: bool = False) -> int:
    """Size of one switching key in bytes: int64 residues, axis-1 factor
    4 ((b, a) and their Shoup companions), 2 when compact."""
    lf = ctx.max_limbs + len(ctx.special_primes)
    return ctx.dnum(ctx.max_limbs) * (2 if compact else 4) * lf * ctx.n * 8


def gen_rotation_keys(ctx: CKKSContext, keys: KeySet, sampler: Sampler,
                      rotations: list[int] | None = None,
                      compact: bool = False) -> dict[int, torch.Tensor]:
    """One switching key per rotation amount (default 1..slots-1, as
    he_genrk; r = 0 needs no key), drawn from `sampler` in order, in
    the compact layout when `compact`."""
    if rotations is None:
        rotations = list(range(ctx.slots))
    rotations = [r for r in rotations if r % ctx.slots != 0]
    lf = ctx.max_limbs + len(ctx.special_primes)
    device = keys.sk.device
    out = {}
    for r in rotations:
        perm = permutation(ctx.n, galois_element(r, ctx.n), device)
        s_rot = apply_automorphism(keys.sk[:lf], perm)
        out[r] = _gen_switching_key(ctx, keys.sk, s_rot, sampler, compact)
    return out


# ---------------------------------------------------------------------------
# key-switch core
# ---------------------------------------------------------------------------


@functools.cache
def _ks_constants_np(ctx: CKKSContext, k: int):
    P = ctx.special_product
    pinv = np.array([pow(P % p, -1, p) for p in ctx.data_primes[:k]],
                    dtype=np.int64).reshape(k, 1)
    pj = np.array(ctx.data_primes[:k], dtype=np.int64).reshape(k, 1)
    return pinv, shoup(pinv, pj)


@functools.cache
def _ks_constants_dev(ctx: CKKSContext, k: int, device: torch.device):
    return tuple(i64(a, device) for a in _ks_constants_np(ctx, k))


def _ks_constants(ctx: CKKSContext, k: int, device):
    """(P^-1 mod p_t, its Shoup companion), [k, 1] int64 on `device`."""
    return _ks_constants_dev(ctx, k, resolve_device(device))


def slice_key(ctx: CKKSContext, ksk: torch.Tensor, k: int) -> torch.Tensor:
    """Slice a top-level switching key [dnum_max, 4 or 2, K_max+S, N] to
    a k-limb operand: first dnum(k) digits, data rows [0,k) + specials."""
    ksk = ksk[:ctx.dnum(k)]
    if k == ctx.max_limbs:
        return ksk
    ns = len(ctx.special_primes)
    rows = torch.cat([torch.arange(k),
                      torch.arange(ctx.max_limbs, ctx.max_limbs + ns)])
    return ksk.index_select(2, rows.to(ksk.device))


@span("keyswitch.modup")
def decompose_digits(ctx: CKKSContext, c1: torch.Tensor) -> torch.Tensor:
    """NTT-domain poly [..., k, N] -> extended NTT-domain digits
    [..., dnum(k), k+S, N]: per-group centered residues base-extended to
    the chain + special modulus.  The hoistable part of rotation."""
    k = c1.shape[-2]
    device = c1.device
    coeff = intt(c1, ctx.tables(k, device))               # [..., k, N]
    dnum, alpha = ctx.dnum(k), ctx.alpha
    pad = dnum * alpha - k
    if pad:
        coeff = torch.cat([coeff, torch.zeros((*coeff.shape[:-2], pad, ctx.n),
                                              dtype=torch.int64,
                                              device=device)], dim=-2)
    grouped = coeff.unflatten(-2, (dnum, alpha))          # [..., dnum, alpha, N]
    consts = grouped_conv_constants(
        ctx.digit_groups(k), ctx.data_primes[:k] + ctx.special_primes, device)
    ext = grouped_convert(grouped, consts)                # [..., dnum, k+S, N]
    return ntt(ext, ctx.tables_ks(k, device))


@span("keyswitch.inner_product")
def _inner_product(ctx: CKKSContext, digits: torch.Tensor, ksk: torch.Tensor,
                   k: int, sliced: bool = False,
                   perm: torch.Tensor | None = None) -> torch.Tensor:
    """sum_j digits[j] * ksk[j] over the extended modulus.  digits
    [..., dnum, k+S, N]; key [dnum, 4, k+S, N] once sliced to this level
    (Shoup products with the stored companions) or [dnum, 2, k+S, N] in
    the compact layout (Barrett products), shared by every leading row;
    then one sum + Barrett pass over the digit axis -> [..., 2, k+S, N].
    With `perm` (an evaluation-domain Galois permutation) the digits are
    taken as ``digits.index_select(-1, perm)``."""
    ksk_l = ksk if sliced else slice_key(ctx, ksk, k)
    return key_inner_product(digits, ksk_l, ctx.tables_ks(k, digits.device),
                             perm)


def key_inner_product(digits: torch.Tensor, ksk_l: torch.Tensor, t,
                      perm: torch.Tensor | None = None) -> torch.Tensor:
    """``_inner_product`` over the rows whose primes `t` holds (p, mu, k
    columns): digits [..., dnum, R, N], key [dnum, 4 or 2, R, N], the
    digits read through `perm` where given.  K7 for a CUDA tensor (the
    permutation read inside the kernel), the plain version for a CPU
    tensor."""
    if digits.device.type == "cuda":
        from hectr_tpu_torch.ops.keyswitch_cuda import key_inner_product_cuda

        return key_inner_product_cuda(digits.contiguous(), ksk_l.contiguous(),
                                      t.p, perm)
    if digits.device.type != "cpu":
        raise NotImplementedError(f"no key inner product for device "
                                  f"{digits.device}")
    if perm is not None:
        digits = digits.index_select(-1, perm)
    return key_inner_product_plain(digits, ksk_l, t)


def key_inner_product_plain(digits: torch.Tensor, ksk_l: torch.Tensor,
                            t) -> torch.Tensor:
    """``key_inner_product`` without a permutation, in plain PyTorch
    ops."""
    d = digits.unsqueeze(-3)                              # [..., dnum, 1, R, N]
    if ksk_l.shape[1] == 4:
        prod = mul_mod_shoup_plain(d, ksk_l[:, :2], ksk_l[:, 2:], t.p)
    else:
        prod = mul_mod_plain(d, ksk_l, t.p, t.mu, t.k)
    return sum_mod(prod, -4, t.p, t.mu, t.k)


@span("keyswitch.mod_down")
def _mod_down_special(ctx: CKKSContext, acc: torch.Tensor, k: int) -> torch.Tensor:
    """Divide the extended result by P = prod(special primes):
    (acc_t - [acc]_P) * P^-1 mod p_t with centered [acc]_P.
    acc [..., k+S, N] -> [..., k, N]."""
    device = acc.device
    pinv, pinv_sh = _ks_constants(ctx, k, device)
    t = ctx.tables(k, device)
    last = intt(acc[..., k:, :], ctx.tables_special(device))   # coeff domain
    consts = base_conv_constants(ctx.special_primes, ctx.data_primes[:k],
                                 device)
    ext = ntt(base_convert(last, consts), t)                   # [..., k, N]
    return mod_down_tail(acc[..., :k, :], ext, pinv, pinv_sh, t.p)


def mod_down_tail(acc_k: torch.Tensor, ext: torch.Tensor, pinv: torch.Tensor,
                  pinv_sh: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(acc_k - ext) * P^-1 mod p over [..., R, N]: the last pass of the
    mod-down, with P^-1's Shoup companion; pinv, pinv_sh, p are [R, 1]
    columns.  K8 for a CUDA tensor (acc_k may be the first rows of the
    extended result), the plain version for a CPU tensor."""
    if acc_k.device.type == "cuda":
        from hectr_tpu_torch.ops.keyswitch_cuda import (lead_stride,
                                                        mod_down_tail_cuda)

        if lead_stride(acc_k) is None:
            acc_k = acc_k.contiguous()
        return mod_down_tail_cuda(acc_k, ext.contiguous(), pinv, pinv_sh, p)
    if acc_k.device.type != "cpu":
        raise NotImplementedError(f"no mod-down for device {acc_k.device}")
    return mod_down_tail_plain(acc_k, ext, pinv, pinv_sh, p)


def mod_down_tail_plain(acc_k: torch.Tensor, ext: torch.Tensor,
                        pinv: torch.Tensor, pinv_sh: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    """``mod_down_tail`` in plain PyTorch ops."""
    diff = sub_mod_plain(acc_k, ext, p)
    return mul_mod_shoup_plain(diff, pinv, pinv_sh, p)


def key_switch(ctx: CKKSContext, poly: torch.Tensor,
               ksk: torch.Tensor) -> torch.Tensor:
    """Switch an NTT-domain poly [..., k, N] (a ct component under s')
    to a 2-component ct under s: returns [..., 2, k, N]."""
    k = poly.shape[-2]
    digits = decompose_digits(ctx, poly)
    acc = _inner_product(ctx, digits, ksk, k)
    return _mod_down_special(ctx, acc, k)


def rotate(ctx: CKKSContext, ct: Ciphertext, r: int,
           rot_keys: dict[int, torch.Tensor]) -> Ciphertext:
    """Left-rotate ciphertext slots by r ([..., 2, k, N])."""
    r = r % ctx.slots
    if r == 0:
        return ct
    device = ct.data.device
    perm = permutation(ctx.n, galois_element(r, ctx.n), device)
    c1r = apply_automorphism(ct.data[..., 1, :, :], perm)
    ks = key_switch(ctx, c1r, rot_keys[r])
    t = ctx.tables(ct.limbs, device)
    c0 = add_mod_perm(ct.data[..., 0, :, :], perm, ks[..., 0, :, :], t.p)
    return Ciphertext(data=torch.stack([c0, ks[..., 1, :, :]], dim=-3),
                      scale=ct.scale)


@span("scheme.mul_ct")
def mul_ct(ctx: CKKSContext, a: Ciphertext, b: Ciphertext,
           relin_key: torch.Tensor) -> Ciphertext:
    """ct x ct multiply + relinearise; scales multiply (rescale
    separately).  Operands [..., 2, k, N] (leading dims broadcast).
    Products are Barrett on int64 residues (< 2^60 since p < 2^30)."""
    if a.limbs != b.limbs:
        raise ValueError(f"operands at {a.limbs} vs {b.limbs} limbs")
    t = ctx.tables(a.limbs, a.data.device)
    a0, a1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
    b0, b1 = b.data[..., 0, :, :], b.data[..., 1, :, :]
    # d0 = a0 b0, d1 = a0 b1 + a1 b0, d2 = a1 b1; d0 and d1 are each added
    # to their half of the switched d2 by a fused multiply-add
    d2 = mul_mod(a1, b1, t.p, t.mu, t.k)
    ks = key_switch(ctx, d2, relin_key)
    d1 = mul_add_mod(a1, b0, mul_mod(a0, b1, t.p, t.mu, t.k), t.p, t.mu, t.k)
    return Ciphertext(data=torch.stack(
        [mul_add_mod(a0, b0, ks[..., 0, :, :], t.p, t.mu, t.k),
         add_mod(d1, ks[..., 1, :, :], t.p)], dim=-3),
                      scale=a.scale * b.scale)
