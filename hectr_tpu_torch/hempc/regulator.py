"""The encrypted MPC regulator, pluggable into the closed-loop step loop.

Mirrors the reference flow (src/ctr.c:587-590 per step), as
``hectr_tpu/hempc/regulator.py``:
  hectr_enc_states: d2z-embed + encode + pk-encrypt (xhat, uhat, xr, ur)
  ctr_hempc:        2x he_sub, 2x he_gemv, he_add, he_neg,
                    he_moddown, he_add     (src/hempc.c:253-266)
  hectr_dec_state:  decrypt + decode, take the first nu slots
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.gemv import gemv_materials, gemv_apply
from hectr_tpu_torch.ckks.scheme import KeySet, Sampler
from hectr_tpu_torch.control.mpc import mpc_gains
from hectr_tpu_torch.control.simulate import LinearModel, Plant
from hectr_tpu_torch.control.stages import weighting_matrices


def regulator_gains(model: LinearModel, plant: Plant, horizon: int):
    """(K_A, K_B): the two plaintext controller gain matrices of the
    encrypted update du = -(K_A (xhat-xr) + K_B (uhat-ur))
    (src/hempc.c:117-196 calc_coeff, computed once, not per step)."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    return mpc_gains(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)


def hempc_init_state(sampler: Sampler, device):
    """Initial regulator state: (encryption sampler, imaginary-residue
    canary).  The canary accumulates max |Im(decode)| over the loop --
    the reference asserts it < 1e-5 on every decode (src/ctr.c:493-494);
    the caller asserts it after the loop."""
    return (sampler, torch.zeros((), dtype=torch.float64, device=device))


def make_hempc_regulator(ctx: CKKSContext, keys: KeySet, rot_keys: dict,
                         model: LinearModel, plant: Plant, horizon: int,
                         bounds=None):
    """Build the encrypted regulator closure; its state is
    (sampler, canary) from `hempc_init_state`: fresh encryption
    randomness every step.  Only the unconstrained regulator is ported;
    `bounds` (the encrypted box-constrained QP) raises."""
    if bounds is not None:
        raise NotImplementedError("the encrypted QP (hempc/qp_enc.py) is "
                                  "not ported yet")
    nu = np.shape(model.B)[1]
    if ctx.slots < nu * horizon:
        raise ValueError(f"{ctx.slots} slots < nu * horizon = {nu * horizon}")
    K_A, K_B = regulator_gains(model, plant, horizon)
    device = keys.sk.device
    k_top = ctx.max_limbs
    # d2z_matrix zero-embedding into the slots x slots layout
    # (src/hempc.c:187,195); diagonal plaintexts and keys built once
    mat_A = gemv_materials(ctx, K_A, k_top, rot_keys, device)
    mat_B = gemv_materials(ctx, K_B, k_top, rot_keys, device)
    zeros = torch.zeros(ctx.slots, dtype=torch.float64, device=device)

    def enc_vec(v, sampler):
        # d2z_vector parity (src/matrices.c:124-131): zero-extend the
        # real vector into the slot space
        zre = torch.cat([v, zeros[v.shape[0]:]])
        return S.encrypt(ctx, keys, S.encode(ctx, (zre, zeros), k_top), sampler)

    def regulator(state, xhat, uhat, xr, ur):
        sampler, canary = state
        ct_xhat = enc_vec(xhat, sampler)
        ct_uhat = enc_vec(uhat, sampler)
        ct_xr = enc_vec(xr, sampler)
        ct_ur = enc_vec(ur, sampler)
        # --- encrypted regulator (server side) -----------------------
        xdiff = S.sub(ctx, ct_xhat, ct_xr)
        udiff = S.sub(ctx, ct_uhat, ct_ur)
        gA = gemv_apply(ctx, mat_A, xdiff)
        gB = gemv_apply(ctx, mat_B, udiff)
        du = S.neg(ctx, S.add(ctx, gA, gB))
        ct_u = S.add(ctx, S.mod_down_to(ctx, ct_uhat, du.limbs), du)
        # --- back across the trust boundary --------------------------
        re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, ct_u))
        # imaginary-residue noise canary (src/ctr.c:493-494 parity)
        canary = torch.maximum(canary, torch.max(torch.abs(im)))
        return re[:nu], (sampler, canary)

    return regulator
