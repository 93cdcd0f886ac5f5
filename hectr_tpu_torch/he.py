"""GPQHE-style API facade: the reference's he_* surface, name for name,
as ``hectr_tpu/he.py``, over the port's RNS-CKKS engine.

Call-site parity map (SURVEY.md §2.3):
  hectx_init(logn, logq, slots, Delta)   src/ctr.c:514-518
  he_keypair / he_genrk                  src/ctr.c:529,532
  he_ecd / he_dcd                        src/ctr.c:466-470, 489-494
  he_enc_pk / he_dec                     src/ctr.c:471-475, 489
  he_add / he_sub / he_neg               src/hempc.c:253-262
  he_copy_ct / he_moddown                src/hempc.c:264-265
  he_gemv                                src/hempc.c:257-259

Ciphertexts and plaintexts are immutable dataclasses whose tensors no
operation writes in place, so the C API's alloc/free pairs have no
equivalent and he_copy_ct is the identity.  Everything lives on the
context's device; randomness comes from one sampler (by default a
``TorchSampler(seed, device)`` stream), drawn in call order.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from hectr_tpu_torch.ckks import scheme as _s
from hectr_tpu_torch.ckks.context import CKKSContext, make_context
from hectr_tpu_torch.ckks.encoding import complex_tensor
from hectr_tpu_torch.ckks.gemv import make_gemv
from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys
from hectr_tpu_torch.ckks.security import modulus_bits, security_report
from hectr_tpu_torch.config import CKKSPreset, resolve_device


@dataclasses.dataclass
class HEContext:
    ctx: CKKSContext
    device: torch.device
    sampler: _s.Sampler
    keys: Optional[_s.KeySet] = None
    rot_keys: Optional[dict] = None
    _gemv_cache: dict = dataclasses.field(default_factory=dict)
    # realized-modulus report (filled by hectx_init): the RNS chain
    # rounds the requested logq, and the caller deserves to know what
    # it actually got (src/ctr.c:514-518 just trusts its bignum q)
    requested_logq: int = 0
    realized_logq: int = 0      # ceil bits of prod(data primes)
    realized_logqp: int = 0     # incl. key-switch special primes
    depth: int = 0              # realized rescale depth
    security_bits: float = 0.0  # HE-standard interpolated estimate


def hectx_init(logn: int, logq: int, slots: int, delta_bits: int,
               seed: int = 0, verbose: bool = False, *, device,
               sampler: _s.Sampler | None = None) -> HEContext:
    """Initialise a CKKS context on `device`.  The reference passes
    q = 2^109 as a bignum (src/ctr.c:515-516); here logq sizes the RNS
    chain: depth = max(1, (logq - 60) // delta_bits) scale pairs over a
    ~2^60 base.

    The realized modulus is reported, not silently rounded: the context
    carries realized_logq / realized_logqp / depth / security_bits; pass
    verbose=True (or set HECTR_VERBOSE=1) for a one-line stderr report.
    Quiet by default.  Draws come from `sampler`, by default
    TorchSampler(seed, device)."""
    verbose = verbose or os.environ.get("HECTR_VERBOSE") == "1"
    device = resolve_device(device)
    depth = max(1, (logq - 60) // delta_bits)
    preset = CKKSPreset(name=f"he-{logn}-{logq}", logn=logn, slots=slots,
                        scale_bits=delta_bits, limb_bits=25,
                        mult_depth=depth)
    log_q, log_qp = modulus_bits(preset)
    rep = security_report(preset)
    hc = HEContext(ctx=make_context(preset), device=device,
                   sampler=_s.TorchSampler(seed, device) if sampler is None
                   else sampler,
                   requested_logq=logq, realized_logq=log_q,
                   realized_logqp=log_qp, depth=depth,
                   security_bits=rep.est_bits)
    if verbose:
        print(f"hectx_init: logn={logn} requested logq={logq} -> "
              f"realized logQ={log_q} (logQP={log_qp} with key-switch "
              f"specials), depth={depth} rescale "
              f"level{'s' if depth != 1 else ''}, estimated security "
              f"~{rep.est_bits:.0f}-bit (HE-standard 128-bit ceiling: "
              f"logQP<={rep.max_logqp_128} at this degree)",
              file=sys.stderr)
    return hc


def he_keypair(hc: HEContext) -> None:
    hc.keys = _s.keygen(hc.ctx, hc.sampler, hc.device)


def he_genrk(hc: HEContext) -> None:
    """Rotation keys for amounts 1..slots-1 (src/ctr.c:521-532)."""
    if hc.keys is None:
        raise ValueError("he_keypair first")
    hc.rot_keys = gen_rotation_keys(hc.ctx, hc.keys, hc.sampler)


def he_ecd(hc: HEContext, v, scale=None) -> _s.Plaintext:
    """Complex slot values -> plaintext at the top level."""
    return _s.encode(hc.ctx, complex_tensor(v).to(hc.device),
                     hc.ctx.max_limbs, scale=scale)


def he_dcd(hc: HEContext, pt: _s.Plaintext) -> torch.Tensor:
    """Plaintext -> complex128 slot values on the context's device."""
    return _s.decode(hc.ctx, pt)


def he_enc_pk(hc: HEContext, pt: _s.Plaintext) -> _s.Ciphertext:
    return _s.encrypt(hc.ctx, hc.keys, pt, hc.sampler)


def he_dec(hc: HEContext, ct: _s.Ciphertext) -> _s.Plaintext:
    return _s.decrypt(hc.ctx, hc.keys, ct)


def he_add(hc, a, b):
    return _s.add(hc.ctx, a, b)


def he_sub(hc, a, b):
    return _s.sub(hc.ctx, a, b)


def he_neg(hc, a):
    return _s.neg(hc.ctx, a)


def he_copy_ct(hc, a):
    return a  # immutable: copy is identity


def he_moddown(hc, a):
    return _s.mod_down_pair(hc.ctx, a)


def he_gemv(hc: HEContext, M, ct: _s.Ciphertext) -> _s.Ciphertext:
    """Plaintext-matrix x ciphertext-vector product (consumes one level;
    the reference pairs it with he_moddown on the unmultiplied operand).
    The gemv materials are built once per (matrix, level), so calling
    this in a loop -- the reference's usage, src/ctr.c:589 ->
    src/hempc.c:257-259 -- pays the build once, not per step."""
    if hc.rot_keys is None:
        raise ValueError("he_genrk first")
    M = np.asarray(M)
    cache_key = (M.tobytes(), M.shape, ct.limbs)
    fn = hc._gemv_cache.get(cache_key)
    if fn is None:
        fn = make_gemv(hc.ctx, M, ct.limbs, hc.rot_keys, hc.device)
        hc._gemv_cache[cache_key] = fn
    return fn(ct)


def hectx_exit(hc: HEContext) -> None:
    hc.keys = None
    hc.rot_keys = None
    hc._gemv_cache.clear()   # materials hold key material
