"""Fused single-ciphertext encrypted regulator, as
``hectr_tpu/hempc/fused.py``.

The reference's per-step dataflow (src/ctr.c:587-590 +
src/hempc.c:253-266) moves four ciphertexts across the trust boundary
and runs 2 he_sub + 2 he_gemv + he_add/he_neg/he_moddown/he_add.  The
algebra allows one packed vector instead:

    u = uhat + du,  du = -(K_A (xhat-xr) + K_B (uhat-ur))
      = (S - K) v1 + K v2

with v1 = [xhat; uhat], v2 = [xr; ur], K = [K_A | K_B] (first nu rows;
only u[:nu] is decoded) and S the selector of uhat in v1.  So a step is
one plaintext matrix on one packed slot vector:

    w  = [v1 at slots 0..d-1 | v2 at slots s/2..s/2+d-1],   d = nx+nu
    M[:nu, 0:d] = S - K,   M[:nu, s/2:s/2+d] = K
    u  = (M w)[:nu]

One encrypt, one hoisted gemv, one decrypt per step.  Depth, scales and
the noise canary are those of the reference-shaped regulator.  Inputs
[..., n] are a batch of loops, packed and encrypted at once.

``fused_du_matrix`` is the packed matrix of the constrained variant: it
computes the full du_unc vector (rows 0..m*horizon-1), optionally in the
QP's w-scaled units.
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.gemv import gemv_apply, gemv_materials
from hectr_tpu_torch.ckks.scheme import KeySet, Sampler
from hectr_tpu_torch.hempc.regulator import broadcast_loops, regulator_gains


def pack_offset(slots: int, d: int) -> int:
    """Slot offset of v2 in the packed vector (v1 at 0..d-1, v2 at
    off..off+d-1): s/2 keeps the halves disjoint and the active gemv
    diagonals in two contiguous runs."""
    off = slots // 2
    if off < d:
        raise ValueError(f"packing needs slots >= 2*(nx+nu): slots={slots}, "
                         f"d={d}")
    return off


def fused_u_matrix(model, plant, horizon: int, slots: int) -> np.ndarray:
    """The packed-gemv matrix of the unconstrained regulator: rows
    0..nu-1 compute u = uhat + du directly."""
    K_A, K_B = regulator_gains(model, plant, horizon)
    nx = K_A.shape[1]
    nu = K_B.shape[1]
    d = nx + nu
    off = pack_offset(slots, d)
    K = np.hstack([K_A, K_B])[:nu]          # [nu, d]
    Ssel = np.zeros((nu, d))
    Ssel[:, nx:] = np.eye(nu)               # uhat selector out of v1
    M = np.zeros((slots, slots))
    M[:nu, :d] = Ssel - K
    M[:nu, off:off + d] = K
    return M


def fused_du_matrix(model, plant, horizon: int, slots: int,
                    gain_scale=None) -> np.ndarray:
    """The packed-gemv matrix of the constrained path: rows
    0..m*horizon-1 compute du_unc = -K (v1 - v2), with the QP's per-row
    w-space normalization diag(gain_scale) folded in when given."""
    K_A, K_B = regulator_gains(model, plant, horizon)
    d = K_A.shape[1] + K_B.shape[1]
    mN = K_A.shape[0]
    off = pack_offset(slots, d)
    K = np.hstack([K_A, K_B])               # [mN, d]
    if gain_scale is not None:
        K = np.asarray(gain_scale)[:, None] * K
    M = np.zeros((slots, slots))
    M[:mN, :d] = -K
    M[:mN, off:off + d] = K
    return M


def make_fused_materials(ctx: CKKSContext, rot_keys: dict, model, plant,
                         horizon: int, device, method: str = "auto") -> dict:
    """Gemv materials of the fused unconstrained regulator matrix at the
    top level, on `device`."""
    M = fused_u_matrix(model, plant, horizon, ctx.slots)
    return gemv_materials(ctx, M, ctx.max_limbs, rot_keys, device, method)


def enc_pack(ctx: CKKSContext, keys: KeySet, xhat, uhat, xr, ur,
             sampler: Sampler, k: int | None = None) -> S.Ciphertext:
    """One encryption of the packed vector w = [xhat,uhat | xr,ur]: the
    fused protocol's whole per-step upload ([..., n] inputs: one
    ciphertext per row)."""
    k = ctx.max_limbs if k is None else k
    nx = xhat.shape[-1]
    d = nx + uhat.shape[-1]
    off = pack_offset(ctx.slots, d)
    z = torch.zeros((*xhat.shape[:-1], ctx.slots), dtype=torch.float64,
                    device=xhat.device)
    z[..., :nx] = xhat
    z[..., nx:d] = uhat
    z[..., off:off + nx] = xr
    z[..., off + nx:off + d] = ur
    return S.encrypt(ctx, keys, S.encode(ctx, (z, torch.zeros_like(z)), k),
                     sampler)


def make_fused_regulator(ctx: CKKSContext, keys: KeySet, model, plant,
                         horizon: int, gemv_mats: dict):
    """Fused unconstrained encrypted regulator for control.simulate,
    with the state of hempc.regulator: (sampler, noise canary).  Per
    step: enc_pack -> one gemv -> decrypt; u = (M w)[:nu]."""
    nu = np.shape(model.B)[1]

    def regulator(state, xhat, uhat, xr, ur):
        sampler, canary = state
        xhat, uhat, xr, ur = broadcast_loops(xhat, uhat, xr, ur)
        ct = enc_pack(ctx, keys, xhat, uhat, xr, ur, sampler)
        ct_u = gemv_apply(ctx, gemv_mats, ct)
        re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, ct_u))
        canary = torch.maximum(canary, torch.abs(im).amax(-1))
        return re[..., :nu], (sampler, canary)

    return regulator
