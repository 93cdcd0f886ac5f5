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
encryption, gemv, encrypted QP and decryption per step for all of them,
keys, gemv materials and the QP's plaintext constants shared, one
canary per loop.

The step is written once, over an op set: ``ckks.scheme_ops.SchemeOps``
on one device, or a limb mesh's ``parallel.limb_ops.LimbOps``, which
runs it with every ciphertext, key and gemv material sharded by RNS row
(the JAX package's ``key_sharding`` / ``ct_sharding``), bit-identical
to the single device.

On one CUDA device, with the encryption draws from a ``TorchSampler``
there, the closure replays the whole step as one CUDA graph
(``StepGraph``): some 270 launches at one plant cost the host one graph
launch and a few copies.  The sampler's generator is registered with the
graph, so every replay draws what the uncaptured step would, and the
moves, states and canaries are bit-equal to it.  Anywhere else (a limb
mesh, the CPU, an injected sampler, an op set that traces) the step runs
uncaptured.
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.ckks.context import CKKSContext
from hectr_tpu_torch.ckks.scheme import KeySet, Sampler, TorchSampler
from hectr_tpu_torch.ckks.scheme_ops import SchemeOps
from hectr_tpu_torch.control.mpc import mpc_gains, mpc_hessian
from hectr_tpu_torch.control.simulate import LinearModel, Plant
from hectr_tpu_torch.control.stages import weighting_matrices
from hectr_tpu_torch.hempc.qp_enc import make_encrypted_pgd
from hectr_tpu_torch.ops.launches import Replayed
from hectr_tpu_torch.utils import pmu


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


def _zero_extend(v: torch.Tensor, zeros: torch.Tensor):
    """d2z_vector parity (src/matrices.c:124-131): the real vector
    zero-extended into the slot space, as an (re, im) pair."""
    lead = v.shape[:-1]
    zre = torch.cat([v, zeros[v.shape[-1]:].expand(*lead, -1)], dim=-1)
    return zre, zeros.expand(*lead, -1)


class StepGraph:
    """A regulator step (state, xhat, uhat, xr, ur) -> (u, state) as one
    CUDA graph, for one key: the shapes and dtypes of the four inputs
    and the canary, and the sampler's generator.  A call with a new key
    frees the graph it holds, runs the step uncaptured (a real step,
    which also fills every table and plan cache the step reads), then
    captures it with the generator registered; a call with the key
    copies its inputs into the graph's and replays it.  The move and the
    canary it returns are copies, never the graph's own outputs."""

    def __init__(self, step):
        self.step = step
        self.key = None
        self.graph = None
        self.inputs = self.outputs = ()
        self.launches = Replayed()

    def __call__(self, state, *vs):
        sampler, canary = state
        tensors = (*vs, canary)
        key = (sampler.gen, *[(t.shape, t.dtype) for t in tensors])
        if key != self.key:
            return self._capture(key, sampler, tensors)
        pmu.count("regulator.replay")
        with pmu.span("regulator.replay"):
            for held, t in zip(self.inputs, tensors):
                held.copy_(t)
            self.graph.replay()
            self.launches.replay()
            u, c = self.outputs
            return u.clone(), (sampler, c.clone())

    def _capture(self, key, sampler, tensors):
        self.key = self.graph = None
        self.inputs = self.outputs = ()
        pmu.count("regulator.uncaptured")
        out = self.step((sampler, tensors[-1]), *tensors[:-1])
        with pmu.span("regulator.capture"):
            inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                           for t in tensors)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(sampler.gen)
            with self.launches.capture(), torch.cuda.graph(graph):
                u, (_, c) = self.step((sampler, inputs[-1]), *inputs[:-1])
        self.key, self.graph = key, graph
        self.inputs, self.outputs = inputs, (u, c)
        pmu.count("regulator.capture")
        return out


def make_hempc_regulator(ctx: CKKSContext, keys: KeySet, rot_keys: dict,
                         model: LinearModel, plant: Plant, horizon: int,
                         bounds=None, relin_key=None, qp_iters: int = 2,
                         qp_degree: int = 7, qp_input_bound=3.0, ops=None):
    """Build the encrypted regulator closure; its state is
    (sampler, canary) from `hempc_init_state`: fresh encryption
    randomness every step.  The closure maps xhat [..., nx], uhat
    [..., nu], xr, ur to u [..., nu]: leading dims are a batch of loops.

    With `bounds` carrying dumin/dumax (an MPCBounds) and a relin_key,
    the regulator solves the box-constrained QP over ciphertext by
    fixed-iteration projected gradient (hempc.qp_enc) -- beyond the
    reference, whose encrypted path is unconstrained only
    (src/hempc.c:216-266).  Bounds without dumin run the unconstrained
    law.

    `ops` is the op set the step runs on: ``SchemeOps(ctx)``, the single
    device, when None; a ``LimbOps`` over the context and a mesh shards
    the keys, gemv materials and ciphertexts by row, and its counters and
    trace are the caller's to read.  The encrypted QP runs on the single
    device only.

    Where `ops` is the single device's ``SchemeOps`` (not tracing), the
    inputs lie on a CUDA device and the state's sampler is a
    ``TorchSampler`` there, the step replays as one CUDA graph
    (``StepGraph``; one graph a closure, captured again when the inputs'
    shapes or the sampler change); elsewhere it runs uncaptured.  Either
    way ``pmu.COUNTS`` counts the calls: ``regulator.capture``,
    ``regulator.replay`` and ``regulator.uncaptured`` (a capture's first,
    uncaptured step among them).  The uncaptured step is the closure's
    ``uncaptured``."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    if ctx.slots < nu * horizon:
        raise ValueError(f"{ctx.slots} slots < nu * horizon = {nu * horizon}")
    K_A, K_B = regulator_gains(model, plant, horizon)
    device = keys.sk.device
    k_top = ctx.max_limbs
    ops = SchemeOps(ctx) if ops is None else ops
    qp_solve = None
    if bounds is not None and bounds.dumin is not None:
        if not isinstance(ops, SchemeOps):
            raise ValueError("the encrypted QP (hempc.qp_enc) does not run on "
                             "a limb mesh: a regulator with du bounds takes "
                             "the single-device op set (a limb-sharded QP is "
                             "not ported)")
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
    held_keys = ops.shard_keyset(keys)
    mat_A = ops.gemv_materials(K_A, k_top, rot_keys, device)
    mat_B = ops.gemv_materials(K_B, k_top, rot_keys, device)
    zeros = torch.zeros(ctx.slots, dtype=torch.float64, device=device)

    def enc_vec(v, sampler):
        return ops.encrypt(held_keys, ops.encode(_zero_extend(v, zeros),
                                                 k_top), sampler)

    def step(state, xhat, uhat, xr, ur):
        sampler, canary = state
        xhat, uhat, xr, ur = broadcast_loops(xhat, uhat, xr, ur)
        ct_xhat = enc_vec(xhat, sampler)
        ct_uhat = enc_vec(uhat, sampler)
        ct_xr = enc_vec(xr, sampler)
        ct_ur = enc_vec(ur, sampler)
        # --- encrypted regulator (server side) -----------------------
        xdiff = ops.sub(ct_xhat, ct_xr)
        udiff = ops.sub(ct_uhat, ct_ur)
        gA = ops.gemv_apply(mat_A, xdiff)
        gB = ops.gemv_apply(mat_B, udiff)
        du = ops.neg(ops.add(gA, gB))
        if qp_solve is not None:
            du = qp_solve(du)                 # encrypted box projection
        ct_u = ops.add(ops.mod_down_to(ct_uhat, du.limbs), du)
        # --- back across the trust boundary --------------------------
        re, im = ops.decode_ri(ops.decrypt(held_keys, ct_u))
        # imaginary-residue noise canary (src/ctr.c:493-494 parity)
        canary = torch.maximum(canary, torch.abs(im).amax(-1))
        return re[..., :nu], (sampler, canary)

    graph = StepGraph(step) if type(ops) is SchemeOps else None

    def regulator(state, xhat, uhat, xr, ur):
        sampler, canary = state
        # a tracing op set keeps each op's result: only an uncaptured
        # step makes them
        if (graph is not None and ops.trace is None
                and type(sampler) is TorchSampler
                and sampler.device.type == "cuda"
                and all(t.device == sampler.device
                        for t in (xhat, uhat, xr, ur, canary))):
            return graph(state, xhat, uhat, xr, ur)
        pmu.count("regulator.uncaptured")
        return step(state, xhat, uhat, xr, ur)

    regulator.uncaptured = step
    return regulator
