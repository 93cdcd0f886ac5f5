"""Entry points for a compile-and-run check, as the JAX package's
``__graft_entry__.py``.

entry()             -- one encrypted-MPC regulator update (encrypt ->
                       2 x hoisted gemv -> decrypt) at the reference CKKS
                       parameters (logN=12, slots=16, Delta=2^50): the
                       function and example arguments.
dryrun_multichip(n) -- first the JAX dry run's batch x limb step: one
                       full encrypted closed-loop step (measure -> Kalman
                       -> selector -> encrypted regulator -> plant ->
                       estimator) over n/2 loops with the regulator's keys,
                       materials and ciphertexts sharded over 2 limb
                       shards, on tiny shapes, bit-equal to the unsharded
                       batched step; then the coefficient axis over an
                       n-shard local mesh: the sharded rescale on a real
                       ciphertext, the negacyclic product, a rotation and
                       a hoisted gemv at the FLAGSHIP ring, each bit-equal
                       to the single device, and the scaling record.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from hectr_tpu_torch.config import FLAGSHIP, REFERENCE_HEMPC, CKKSPreset

# the JAX dry run's tiny ring (__graft_entry__.py dryrun_multichip)
DRYRUN = CKKSPreset(name="dryrun", logn=8, slots=16, scale_bits=50,
                    limb_bits=25, mult_depth=1)
HORIZON = 4

# NVIDIA's H100 SXM data sheet: NVLink, 900 GB/s per card for both
# directions together, so 450 GB/s each way.  Published, not measured.
NVLINK_GBS_ONE_WAY = 450.0
# what one paired exchange costs before its first byte: an assumption of
# the model, not a measurement
LINK_LATENCY_US = 5.0


def entry(device="cuda"):
    """(fn, example_args): one encrypted MPC regulator step at
    REFERENCE_HEMPC.  ``fn(sampler, xhat, uhat, xr, ur)`` returns the
    decrypted move u; the sampler supplies the step's encryption
    randomness."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator

    device = cli.require_device(device)
    ctx, keys, rot_keys = cli.hempc_keys(REFERENCE_HEMPC, 0, device)
    model, plant = cli.cstr_setup()
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, horizon=4)

    def fn(sampler, xhat, uhat, xr, ur):
        u, _ = reg(hempc_init_state(sampler, device), xhat, uhat, xr, ur)
        return u

    def zeros(n):
        return torch.zeros(n, dtype=torch.float64, device=device)

    return fn, (TorchSampler(7, device), zeros(3), zeros(2), zeros(3),
                zeros(2))


def limb_step(ctx, keys, rot_keys, ops, p: np.ndarray, seed: int,
              device) -> dict:
    """One closed-loop step (``control.simulate.simulate_batch`` over the
    loops of disturbances p [B, 1, np]) with the encrypted regulator on
    the limb mesh of `ops`, then the same step with the unsharded batched
    regulator (``SchemeOps``), both drawing from ``TorchSampler(seed)``
    and both traced.  Raises unless x_next and u are bit-equal and every
    ciphertext and plaintext of the sharded step equals, on each held
    shard's rows, the unsharded one.  The unsharded regulator runs first
    and is dropped before the sharded one is built.  Returns x
    [B, 2, nx], u [B, 1, nu], the sharded regulator and the inputs it
    took (to time it again)."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.ckks.scheme_ops import SchemeOps
    from hectr_tpu_torch.control.simulate import simulate_batch
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator

    model, plant = cli.cstr_setup()
    batch = (p.shape[0],)
    seen = []

    def run(op_set):
        op_set.trace = []
        reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant,
                                   HORIZON, ops=op_set)

        def spy(state, *inputs):
            seen.append(inputs)
            return reg(state, *inputs)

        x, u, _ = simulate_batch(model, plant, p, 1.0, 1, device, spy,
                                 hempc_init_state(TorchSampler(seed, device),
                                                  device, batch), HORIZON)
        trace, op_set.trace = op_set.trace, None
        return x, u, trace, reg

    x1, u1, want = run(SchemeOps(ctx))[:3]    # its regulator is dropped
    x, u, trace, reg_l = run(ops)
    if not (np.array_equal(x, x1) and np.array_equal(u, u1)):
        raise AssertionError("limb-sharded step: x_next or u differs from the "
                             "unsharded batched step")
    for (name, got), (_, ref) in zip(trace, want, strict=True):
        parts = ops.shard_data(ref.data)
        if (got.scale != ref.scale or got.limbs != ref.limbs
                or not all(map(torch.equal, got.parts, parts))):
            raise AssertionError(f"limb-sharded {name} differs from the "
                                 f"unsharded step")
    return {"x": x, "u": u, "regulator": reg_l, "inputs": seen[-1],
            "checked": len(trace)}


def batch_limb_step(n_devices: int, device) -> dict:
    """The JAX dry run's first section: a batch = n/2 x limb = 2 mesh,
    the tiny preset, rotation keys sharded on the extended-limb axis, one
    full closed-loop step over n/2 loops (disturbance 0.01 each), held
    bit-equal to the unsharded batched step (``limb_step``)."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys
    from hectr_tpu_torch.parallel import make_mesh
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"a batch x limb dry run needs an even number of "
                         f"devices, got {n_devices}")
    mesh = make_mesh(batch=n_devices // 2, limb=2, device=device)
    ctx = make_context(DRYRUN)
    keys = S.keygen(ctx, S.TorchSampler(0, device), device)
    rot_keys = gen_rotation_keys(ctx, keys, S.TorchSampler(1, device))
    ops = LimbOps(ctx, mesh)
    p = np.full((mesh.shape["batch"], 1, 1), 0.01)
    res = limb_step(ctx, keys, rot_keys, ops, p, 5, mesh.device)
    _, plant = cli.cstr_setup()
    x_next = res["x"][:, -1] - plant.xs
    print(f"dryrun_multichip({n_devices}): mesh {dict(mesh.shape)}, "
          f"encrypted step executed over {p.shape[0]} loops, bit-equal to the "
          f"unsharded batched step (x_next, u, {res['checked']} ciphertexts "
          f"and plaintexts); gathered {dict(ops.gathered)} B; |x_next| max = "
          f"{np.abs(x_next).max():.3e}")
    return res


def dryrun_multichip(n_shards: int, device="cuda",
                     preset: CKKSPreset = FLAGSHIP) -> dict:
    """Run the batch x limb step (``batch_limb_step``) over n_shards / 2
    loops, then the coefficient-sharded ops once over a local mesh of
    `n_shards` on `device`, assert each bit-equal to the single device,
    print the scaling record as ``MULTICHIP_SCALING {...}`` and return
    it.  `preset` is the large ring (at least 4 slots)."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import make_gemv
    from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys, rotate
    from hectr_tpu_torch.ckks.ntt import negacyclic_mul
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.multihost import ntt_scaling_efficiency
    from hectr_tpu_torch.parallel.ntt_shard import link_efficiency_table

    if n_shards < 2:
        raise ValueError(f"a dry run needs at least 2 shards, got {n_shards}")
    device = cli.require_device(device)
    batch_limb_step(n_shards, device)
    mesh = LocalMesh(n_shards)

    def ones(ctx, value):
        return (torch.full((ctx.slots,), value, dtype=torch.float64,
                           device=device),
                torch.zeros(ctx.slots, dtype=torch.float64, device=device))

    # (a) the real scheme op on a coefficient-sharded REAL ciphertext
    ctx = make_context(DRYRUN)
    keys = S.keygen(ctx, S.TorchSampler(0, device), device)
    k = ctx.max_limbs
    pt2 = S.encode(ctx, ones(ctx, 2.0), k, scale=ctx.pair_scale(k))
    ct0 = S.encrypt(ctx, keys, S.encode(ctx, ones(ctx, 1.0), k),
                    S.TorchSampler(9, device))
    prod = S.mul_pt(ctx, ct0, pt2)
    if not torch.equal(CoeffOps(ctx, mesh).rescale_pair(prod).data,
                       S.rescale_pair(ctx, prod).data):
        raise AssertionError("sharded rescale diverged")

    # (b) the sharded negacyclic product at the large ring, full chain
    fctx = make_context(preset)
    kf = fctx.max_limbs
    cops = CoeffOps(fctx, mesh)
    rng = np.random.default_rng(0)
    pcol = np.array(fctx.data_primes[:kf]).reshape(-1, 1)
    a, b = (torch.from_numpy(rng.integers(0, pcol, size=(kf, fctx.n),
                                          dtype=np.int64)).to(device)
            for _ in range(2))
    if not torch.equal(cops.negacyclic_mul(a, b),
                       negacyclic_mul(a, b, fctx.tables(kf, device))):
        raise AssertionError("sharded negacyclic mul diverged")

    # (c) the coefficient-sharded key switch behind the encrypted
    # controller's hot ops: a rotation and a hoisted gemv
    fkeys = S.keygen(fctx, S.TorchSampler(40, device), device)
    frot = gen_rotation_keys(fctx, fkeys, S.TorchSampler(41, device),
                             rotations=[1, 3])
    vf = torch.linspace(-1.0, 1.0, fctx.slots, dtype=torch.float64,
                        device=device)
    fct = S.encrypt(fctx, fkeys,
                    S.encode(fctx, (vf, torch.zeros_like(vf)), kf),
                    S.TorchSampler(42, device))
    if not torch.equal(cops.rotate(fct, 1, frot).data,
                       rotate(fctx, fct, 1, frot).data):
        raise AssertionError(f"sharded rotate diverged at logN="
                             f"{preset.logn}")
    Mg = np.zeros((fctx.slots, fctx.slots))
    idxs = np.arange(fctx.slots)
    Mg[idxs, idxs] = 0.5
    Mg[idxs, (idxs + 3) % fctx.slots] = -0.25
    if not torch.equal(
            cops.make_gemv(Mg, kf, frot, device)(fct).data,
            make_gemv(fctx, Mg, kf, frot, device, method="diag")(fct).data):
        raise AssertionError(f"sharded gemv diverged at logN={preset.logn}")
    print(f"coeff-shard dryrun over {mesh.describe(device)}: rescale "
          f"bit-exact (logn={ctx.preset.logn}), negacyclic_mul + rotate + "
          f"hoisted gemv bit-exact @ logN={preset.logn} x {kf} limbs")

    # (d) the scaling record
    rep2 = ntt_scaling_efficiency(preset.logn, kf, LocalMesh(2), device)
    repD = ntt_scaling_efficiency(preset.logn, kf, mesh, device)
    rel = (repD["sharded_ntt_per_s"] / rep2["sharded_ntt_per_s"]
           / (n_shards / 2))
    record = {
        "kind": "ntt_scaling_efficiency",
        "mode": "local-mesh",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "caveat": ("every shard lies on one device: the rates say what the "
                   "cross-shard stages cost there, not what a link between "
                   "devices carries; link_prediction is arithmetic from a "
                   "measured kernel time and a published bandwidth"),
        "logn": preset.logn, "limbs": kf,
        "chain_ntt_per_s": {"1dev": repD["single_dev_ntt_per_s"],
                            "2dev": rep2["sharded_ntt_per_s"],
                            f"{n_shards}dev": repD["sharded_ntt_per_s"]},
        "relative_efficiency_2_to_D": round(rel, 4),
        "ppermute_bytes_per_transform":
            repD["ppermute_bytes_per_transform"],
        "ppermute_formula": "log2(D) * N/D * 4B * limbs (butterfly minimum)",
        "link_prediction": link_efficiency_table(
            kf, bw_gbs=NVLINK_GBS_ONE_WAY, latency_us=LINK_LATENCY_US),
        "link": (f"NVLink {NVLINK_GBS_ONE_WAY} GB/s each way (NVIDIA H100 "
                 f"SXM data sheet; published, not measured), "
                 f"{LINK_LATENCY_US} us per exchange (assumed)"),
    }
    print("MULTICHIP_SCALING " + json.dumps(record))
    return record
