"""The encrypted MPC regulator, pluggable into the closed-loop step loop.

Mirrors the reference flow (src/ctr.c:587-590 per step), as
``hectr_tpu/hempc/regulator.py``:
  hectr_enc_states: d2z-embed + encode + pk-encrypt (xhat, uhat, xr, ur)
  ctr_hempc:        2x he_sub, 2x he_gemv, he_add, he_neg,
                    he_moddown, he_add     (src/hempc.c:253-266)
  hectr_dec_state:  decrypt + decode, take the first nu slots

With du box bounds the server also runs the encrypted projected-gradient
QP (hempc.qp_enc) on du before the final add.

One closure serves one loop or a batch of independent loops (the JAX
package vmaps its regulator over them): inputs [..., n], one batched
encryption, gemv and decryption per step for all of them, keys and gemv
materials shared, one canary per loop.  The encrypted QP takes one loop.
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.gemv import gemv_materials, gemv_apply
from hectr_tpu_torch.ckks.scheme import KeySet, Sampler
from hectr_tpu_torch.control.mpc import mpc_gains, mpc_hessian
from hectr_tpu_torch.control.simulate import LinearModel, Plant
from hectr_tpu_torch.control.stages import weighting_matrices
from hectr_tpu_torch.hempc.qp_enc import make_encrypted_pgd


def regulator_gains(model: LinearModel, plant: Plant, horizon: int):
    """(K_A, K_B): the two plaintext controller gain matrices of the
    encrypted update du = -(K_A (xhat-xr) + K_B (uhat-ur))
    (src/hempc.c:117-196 calc_coeff, computed once, not per step)."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    return mpc_gains(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)


def broadcast_loops(*vs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Vectors [..., n] expanded to their common leading dims, so that an
    input shared by every loop (a setpoint) is encrypted per loop as the
    JAX package's vmap does."""
    lead = torch.broadcast_shapes(*(v.shape[:-1] for v in vs))
    return tuple(v.expand(*lead, -1) for v in vs)


def hempc_init_state(sampler: Sampler, device, batch: tuple[int, ...] = ()):
    """Initial regulator state: (encryption sampler, imaginary-residue
    canary [*batch], one per loop).  The canary accumulates max
    |Im(decode)| over the loop -- the reference asserts it < 1e-5 on
    every decode (src/ctr.c:493-494); the caller asserts it after the
    loop."""
    return (sampler, torch.zeros(batch, dtype=torch.float64, device=device))


def make_hempc_regulator(ctx: CKKSContext, keys: KeySet, rot_keys: dict,
                         model: LinearModel, plant: Plant, horizon: int,
                         bounds=None, relin_key=None, qp_iters: int = 2,
                         qp_degree: int = 7, qp_input_bound=3.0):
    """Build the encrypted regulator closure; its state is
    (sampler, canary) from `hempc_init_state`: fresh encryption
    randomness every step.  The closure maps xhat [..., nx], uhat
    [..., nu], xr, ur to u [..., nu]: leading dims are a batch of loops.

    With `bounds` carrying dumin/dumax (an MPCBounds) and a relin_key,
    the regulator solves the box-constrained QP over ciphertext by
    fixed-iteration projected gradient (hempc.qp_enc) -- beyond the
    reference, whose encrypted path is unconstrained only
    (src/hempc.c:216-266).  Bounds without dumin run the unconstrained
    law."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    if ctx.slots < nu * horizon:
        raise ValueError(f"{ctx.slots} slots < nu * horizon = {nu * horizon}")
    K_A, K_B = regulator_gains(model, plant, horizon)
    device = keys.sk.device
    k_top = ctx.max_limbs
    qp_solve = None
    if bounds is not None and bounds.dumin is not None:
        if relin_key is None:
            raise ValueError("the encrypted QP needs a relinearisation key")
        Q, R = weighting_matrices(plant.xs, plant.us)
        H = mpc_hessian(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
        lb = np.tile(np.asarray(bounds.dumin, dtype=np.float64), horizon)
        ub = np.tile(np.asarray(bounds.dumax, dtype=np.float64), horizon)
        qp_solve, _ = make_encrypted_pgd(
            ctx, relin_key, rot_keys, H, lb, ub, k_in=k_top - 2,
            iters=qp_iters, degree=qp_degree, input_bound=qp_input_bound,
            input_kind="w_scaled")
        # fold the QP's w-space normalization diag(1/hw) into the gains
        # (plaintext, so free): input_kind="w_scaled" saves a rescale pair
        gain_scale = 2.0 / (ub - lb)
        K_A = gain_scale[:, None] * K_A
        K_B = gain_scale[:, None] * K_B
    # d2z_matrix zero-embedding into the slots x slots layout
    # (src/hempc.c:187,195); diagonal plaintexts and keys built once
    mat_A = gemv_materials(ctx, K_A, k_top, rot_keys, device)
    mat_B = gemv_materials(ctx, K_B, k_top, rot_keys, device)
    zeros = torch.zeros(ctx.slots, dtype=torch.float64, device=device)

    def enc_vec(v, sampler):
        # d2z_vector parity (src/matrices.c:124-131): zero-extend the
        # real vector into the slot space
        lead = v.shape[:-1]
        zre = torch.cat([v, zeros[v.shape[-1]:].expand(*lead, -1)], dim=-1)
        return S.encrypt(ctx, keys, S.encode(
            ctx, (zre, zeros.expand(*lead, -1)), k_top), sampler)

    def regulator(state, xhat, uhat, xr, ur):
        sampler, canary = state
        xhat, uhat, xr, ur = broadcast_loops(xhat, uhat, xr, ur)
        if qp_solve is not None and xhat.dim() > 1:
            raise ValueError("the encrypted QP (hempc.qp_enc) takes one "
                             "loop: a batch with du bounds needs a batched "
                             "QP, which is not ported")
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
        if qp_solve is not None:
            du = qp_solve(du)                 # encrypted box projection
        ct_u = S.add(ctx, S.mod_down_to(ctx, ct_uhat, du.limbs), du)
        # --- back across the trust boundary --------------------------
        re, im = S.decode_ri(ctx, S.decrypt(ctx, keys, ct_u))
        # imaginary-residue noise canary (src/ctr.c:493-494 parity)
        canary = torch.maximum(canary, torch.abs(im).amax(-1))
        return re[..., :nu], (sampler, canary)

    return regulator
