"""Batch serving on the card: one regulator over B independent loops.

    python -m hectr_tpu_torch.bench.batch

The counterpart of the JAX package's batch benches, on its protocols:

  * REFERENCE_HEMPC (logN=12, 15 rotation keys), the reference-shaped
    regulator at B = 1, 4, 16, 64: rounds of 16 steps, u fed back, one
    warm round then 2 timed (``bench.py`` ``bench_hempc_batch_curve``);
  * FLAGSHIP (logN=15, BSGS keys), the fused regulator at B = 1, 4, 8,
    16, 32: rounds of 8 steps, one warm then 3 timed
    (``scripts/bench_fused_batch.py``, which stops at 8);
  * enc / reg / dec per phase at REFERENCE_HEMPC, B = 1 and 64
    (``scripts/bench_batch_phases.py``);
  * B = 64 ct x ct multiplies + rescale at logN=14
    (``bench.py`` ``bench_ctct_mult_logn14``);
  * FLAGSHIP_QP (logN=15, 32+2 primes), the constrained regulator (compact
    keys, degree-7 2-iteration encrypted QP, the envelope of
    ``scripts/run_flagship_qp_tpu.py``'s loop) at B = 1, 4, 8, 16, 32:
    rounds of 4 steps, one warm then 2 timed, every u within 1e-4 of the
    batched plaintext mirror on its inputs.

For each B it prints aggregate and per-loop steps/s (host clock around
the timed rounds, ending in a synchronize), the K1/K2 launches per
batched step by shape, every CUDA kernel launch of one profiled step
(torch.profiler) with its device time, and the peak device memory; then
one JSON line with all of it and the card.  No watchdog and no cache of
earlier values: every number is this run's.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import numpy as np
import torch

from hectr_tpu_torch.config import CKKSPreset
from hectr_tpu_torch.utils import pmu

REFERENCE_BATCHES = (1, 4, 16, 64)
FUSED_BATCHES = (1, 4, 8, 16, 32)
QP_BATCHES = (1, 4, 8, 16, 32)
# scripts/run_flagship_qp_tpu.py: the du box, the QP, a 10-step loop
QP_DUMIN, QP_DUMAX = (-0.25, -0.004), (0.25, 0.004)
QP_ITERS, QP_DEGREE, QP_STEPS = 2, 7, 10
# the benchmark configuration cstr-hempc-qp's clip envelope B0, fixed: it
# certifies 40-step episodes of its traffic, inlet-flow steps of 0.5-1.5x
# the published one (worst input certificate 8.73, at 1.5x)
QP_INPUT_BOUND = 12.0
PHASE_BATCHES = (1, 64)
PHASE_REPS = 3
CTCT_BATCH = 64
CTCT_ITERS = 3
HORIZON = 4


def profile_kernels(fn) -> dict:
    """CUDA kernel launches and their device time (ms) in one call of fn,
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return kernel_totals(p.key_averages())


def kernel_totals(averages) -> dict:
    """Launches and device ms of the device operations among
    ``key_averages()`` rows: the ranges the profiler mirrors onto the
    device's timeline (the port's spans) are no launches."""
    us, launches = pmu.device_ops(averages)
    return {"kernel_launches": sum(launches.values()),
            "device_ms": sum(us.values()) / 1e3}


def protocol_inputs(B: int, steps: int, device, seed: int = 0):
    """Per-loop inputs of the serving protocol: xhat [B, steps, 3] and the
    first uhat [B, 2], small deviations, with xr = ur = 0."""
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.uniform(-0.01, 0.01, (B, steps, 3))).to(device)
    u0 = torch.from_numpy(rng.uniform(-0.01, 0.01, (B, 2))).to(device)
    return xs, u0


def run_rounds(reg, state, xs, u, rounds: int):
    """`rounds` rounds of xs.shape[-2] steps, the decoded u of each step
    fed back as the next uhat.  Returns (every u [rounds, B, steps, 2],
    state)."""
    zx = torch.zeros(3, dtype=torch.float64, device=xs.device)
    zu = torch.zeros(2, dtype=torch.float64, device=xs.device)
    out = []
    for _ in range(rounds):
        us = []
        for i in range(xs.shape[-2]):
            u, state = reg(state, xs[..., i, :], u, zx, zu)
            us.append(u)
        out.append(torch.stack(us, dim=-2))
    return torch.stack(out), state


def law_error(law, xs, u0, us) -> float:
    """max |u - law(xhat, uhat)| over every step of `us` ([rounds, *B,
    steps, nu], from ``run_rounds(reg, state, xs, u0, rounds)``), each
    step's uhat the u before it (u0 first), xr = ur = 0: the plaintext
    law (or mirror) the regulator must match, evaluated on the encrypted
    loop's own inputs."""
    rounds, steps = us.shape[0], us.shape[-2]
    flat = us.movedim(0, -3).flatten(-3, -2)             # [*B, T, nu]
    uhat = torch.cat([u0.unsqueeze(-2), flat[..., :-1, :]], dim=-2)
    x = torch.cat([xs] * rounds, dim=-2)
    zx = torch.zeros(xs.shape[-1], dtype=torch.float64, device=xs.device)
    zu = torch.zeros(us.shape[-1], dtype=torch.float64, device=xs.device)
    want, _ = law(None, x, uhat, zx, zu)
    return float((flat - want).abs().max())


def serve(reg, B: int, steps: int, rounds: int, device, law) -> dict:
    """The serving protocol at batch B: one warm round, then `rounds`
    timed rounds; launches per batched step, one profiled step, peak
    device memory, and the largest distance of a timed u from the
    plaintext `law` (``law_error``)."""
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.hempc import hempc_init_state
    from hectr_tpu_torch.ops import ntt_cuda

    xs, u0 = protocol_inputs(B, steps, device)
    state = hempc_init_state(TorchSampler(7, device), device, (B,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _, state = run_rounds(reg, state, xs, u0, 1)
    torch.cuda.synchronize()
    ntt_cuda.reset_launches()
    t0 = time.perf_counter()
    us, state = run_rounds(reg, state, xs, u0, rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = rounds * steps
    shapes = {f"{name} {list(shape)}": c / n
              for (name, shape), c in sorted(ntt_cuda.LAUNCH_SHAPES.items())}
    ntt_per_step = {k: v / n for k, v in ntt_cuda.LAUNCHES.items()}
    prof = profile_kernels(lambda: run_rounds(reg, state, xs[..., :1, :], u0, 1))
    agg = B * n / wall
    err = law_error(law, xs, u0, us)
    return {"B": B, "steps": n, "aggregate_steps_s": agg,
            "per_loop_steps_s": agg / B, "wall_s": wall,
            "ntt_launches_per_step": ntt_per_step,
            "ntt_launches_per_step_by_shape": shapes,
            "kernel_launches_per_step": prof["kernel_launches"],
            "device_ms_per_step": prof["device_ms"],
            "peak_device_bytes": torch.cuda.max_memory_allocated(device),
            "canary_max": float(state[1].max()), "max_err_vs_law": err}


def reference_setup(device):
    """(ctx, keys, rot_keys, model, plant) at REFERENCE_HEMPC, every
    rotation key, as the smoke's phase 3."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.config import REFERENCE_HEMPC

    ctx, keys, rk = cli.hempc_keys(REFERENCE_HEMPC, 0, device)
    return (ctx, keys, rk, *cli.cstr_setup())


def flagship_setup(device):
    """(ctx, keys, rot_keys, model, plant) at FLAGSHIP with the BSGS
    rotation keys, as the smoke's phase 4."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.config import FLAGSHIP

    ctx, keys, rk = cli.hempc_keys(FLAGSHIP, 0, device,
                                   bsgs_rotations(FLAGSHIP.slots))
    return (ctx, keys, rk, *cli.cstr_setup())


def reference_curve(setup, device):
    from hectr_tpu_torch.control.simulate import make_mpc_regulator
    from hectr_tpu_torch.hempc import make_hempc_regulator

    ctx, keys, rk, model, plant = setup
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, HORIZON)
    law = make_mpc_regulator(model, plant, HORIZON, device)
    return [_logged(serve(reg, B, 16, 2, device, law), "reference-hempc")
            for B in REFERENCE_BATCHES]


def fused_curve(setup, device):
    from hectr_tpu_torch.control.simulate import make_mpc_regulator
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)

    ctx, keys, rk, model, plant = setup
    mats = make_fused_materials(ctx, rk, model, plant, HORIZON, device)
    reg = make_fused_regulator(ctx, keys, model, plant, HORIZON, mats)
    law = make_mpc_regulator(model, plant, HORIZON, device)
    return [_logged(serve(reg, B, 8, 3, device, law), "flagship-fused")
            for B in FUSED_BATCHES]


def qp_bounds():
    from hectr_tpu_torch.control.mpc import MPCBounds

    return MPCBounds(dumin=np.array(QP_DUMIN), dumax=np.array(QP_DUMAX))


def qp_disturbance(plant, steps: int = QP_STEPS, scale: float = 1.0):
    """scripts/run_flagship_qp_tpu.py's disturbance: a +10% inlet-flow
    step from k=2, times `scale`."""
    p_seq = np.zeros((steps, 1))
    p_seq[2:, 0] = 0.1 * plant.ps[0] * scale
    return p_seq


def closed_loop(model, plant, p, device, reg, state):
    """One CSTR loop (p [steps, 1], through ``simulate``) or B loops in
    one regulator (p [B, steps, 1], ``simulate_batch``) on `device`:
    (x, u, final regulator state)."""
    from hectr_tpu_torch.control.simulate import simulate, simulate_batch

    if p.ndim == 3:
        return simulate_batch(model, plant, p, 1.0, p.shape[-2], device,
                              regulator=reg, regulator_state=state,
                              horizon=HORIZON)
    return simulate(model, plant, p, 1.0, p.shape[-2], device, regulator=reg,
                    regulator_state=state, horizon=HORIZON, return_state=True)


def qp_envelope(model, plant, p, B0: float = 4.0, runs: int = 6):
    """The plaintext mirror's closed loop on the host over p ([steps, 1],
    or [B, steps, 1] for B loops), the envelope widened from `B0` until
    every loop's input certificate fits under it: a finite certificate
    above B0 takes B0 to its ceiling + 1, as
    scripts/run_flagship_qp_tpu.py does; one that is not finite (the
    clip evaluated outside its fit domain, the loop diverged) doubles
    B0.  Raises a ValueError where `runs` runs never fit.  Returns (B0,
    certificate (per loop), x, u)."""
    from hectr_tpu_torch.hempc.qp_enc import make_pgd_mirror_regulator

    cpu = torch.device("cpu")
    for _ in range(runs):
        mirror = make_pgd_mirror_regulator(model, plant, HORIZON, qp_bounds(),
                                           cpu, iters=QP_ITERS,
                                           degree=QP_DEGREE, input_bound=B0)
        x, u, cert = closed_loop(model, plant, p, cpu, mirror, torch.zeros(
            p.shape[:-2], dtype=torch.float64))
        worst = float(cert.max())
        if worst <= B0:
            return B0, cert.numpy(), x, u
        B0 = float(np.ceil(worst) + 1.0) if np.isfinite(worst) else 2.0 * B0
    raise ValueError(f"no clip envelope fits in {runs} runs: the last "
                     f"certificate read {worst}")


def qp_regulator(device, model, plant, B0: float, compact: bool = True):
    """The constrained regulator at FLAGSHIP_QP as
    scripts/run_flagship_qp_tpu.py builds it: a relinearisation key and
    BSGS rotation keys in the compact layout (with their Shoup
    companions where not `compact`, as the benchmark's cstr-hempc-qp
    keeps them), the du box, degree-7 2-iteration encrypted QP fitted
    for the envelope B0."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ckks.keyswitch import gen_relin_key, gen_rotation_keys
    from hectr_tpu_torch.config import FLAGSHIP_QP
    from hectr_tpu_torch.hempc import make_hempc_regulator

    ctx = make_context(FLAGSHIP_QP)
    keys = S.keygen(ctx, S.TorchSampler(51, device), device)
    relin = gen_relin_key(ctx, keys, S.TorchSampler(52, device),
                          compact=compact)
    rot_keys = gen_rotation_keys(ctx, keys, S.TorchSampler(53, device),
                                 rotations=bsgs_rotations(ctx.slots),
                                 compact=compact)
    return make_hempc_regulator(ctx, keys, rot_keys, model, plant, HORIZON,
                                bounds=qp_bounds(), relin_key=relin,
                                qp_iters=QP_ITERS, qp_degree=QP_DEGREE,
                                qp_input_bound=B0)


def qp_closed_loop(reg, model, plant, p, device):
    """The constrained closed loop on the card over p ([steps, 1], or
    [B, steps, 1] for B loops in one regulator), each regulator step
    timed (host clock, ending in a synchronize).  Returns (x, u, canary
    per loop, step seconds)."""
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.hempc import hempc_init_state

    step_s = []

    def timed(state, *args):
        t = time.perf_counter()
        out = reg(state, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    x, u, (_, canary) = closed_loop(model, plant, p, device, timed,
                                    hempc_init_state(TorchSampler(54, device),
                                                     device, p.shape[:-2]))
    torch.cuda.synchronize()
    return x, u, canary.cpu().numpy(), step_s


def qp_box_ok(u: np.ndarray) -> bool:
    """Every move du of every loop inside the du box, to 1e-4."""
    du = np.diff(u, axis=-2)
    return bool(np.all(du <= np.array(QP_DUMAX) + 1e-4)
                and np.all(du >= np.array(QP_DUMIN) - 1e-4))


def qp_activity(u: np.ndarray) -> float:
    """The largest |du| of the first input over the box's half width: 1
    when the box binds."""
    return float(np.max(np.abs(np.diff(u, axis=-2)[..., 0])) / QP_DUMAX[0])


def qp_curve(device, model, plant, B0: float, reg) -> list[dict]:
    """The constrained regulator `reg` (``qp_regulator``) over B loops:
    the serving protocol (rounds of 4 steps, one warm then 2 timed) at
    each of QP_BATCHES, every u within 1e-4 of the batched mirror.  A B
    that does not fit on the card ends the curve with a record saying
    so."""
    from hectr_tpu_torch.hempc.qp_enc import make_pgd_mirror_regulator

    mirror = make_pgd_mirror_regulator(model, plant, HORIZON, qp_bounds(),
                                       device, iters=QP_ITERS,
                                       degree=QP_DEGREE, input_bound=B0)
    out = []
    for B in QP_BATCHES:
        try:
            rec = serve(reg, B, 4, 2, device, mirror)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[batch] flagship-qp B={B}: out of device memory, the "
                  f"curve stops here ({e})", flush=True)
            out.append({"B": B, "out_of_memory": str(e)})
            torch.cuda.empty_cache()
            break
        rec["input_bound"] = B0
        out.append(_logged(rec, "flagship-qp"))
        if not (rec["max_err_vs_law"] <= 1e-4 and rec["canary_max"] < 1e-5):
            raise AssertionError(f"flagship-qp B={B}: u off the mirror by "
                                 f"{rec['max_err_vs_law']}, canary "
                                 f"{rec['canary_max']}")
    return out


def _logged(rec: dict, label: str) -> dict:
    print(f"[batch] {label} B={rec['B']}: {rec['aggregate_steps_s']:.2f} "
        f"steps/s aggregate, {rec['per_loop_steps_s']:.2f} per loop; NTT "
        f"launches per step {rec['ntt_launches_per_step']}; CUDA kernel "
        f"launches per step {rec['kernel_launches_per_step']} "
        f"({rec['device_ms_per_step']:.3f} device ms); peak device memory "
        f"{rec['peak_device_bytes']} B; max |u - plaintext law| "
        f"{rec['max_err_vs_law']}", flush=True)
    return rec


def phases(setup, device) -> list[dict]:
    """enc (4 encode + encrypt), reg (2 subs, 2 hoisted gemvs, add, neg,
    mod-down, add) and dec (decrypt + decode) of one REFERENCE_HEMPC step
    over B loops: device ms (torch.profiler, mean of PHASE_REPS calls)
    and host ms per phase, and the decoded step's distance from its
    plaintext."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.gemv import gemv_apply, gemv_materials
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.hempc.regulator import regulator_gains

    ctx, keys, rk, model, plant = setup
    k = ctx.max_limbs
    K_A, K_B = regulator_gains(model, plant, HORIZON)
    mat_A = gemv_materials(ctx, K_A, k, rk, device)
    mat_B = gemv_materials(ctx, K_B, k, rk, device)
    sampler = TorchSampler(3, device)
    out = []
    reps = PHASE_REPS
    for B in PHASE_BATCHES:
        v = torch.from_numpy(np.random.default_rng(B).uniform(
            -0.01, 0.01, (4, B, ctx.slots))).to(device)

        def enc():
            return [S.encrypt(ctx, keys, S.encode(
                ctx, (v[i], torch.zeros_like(v[i])), k), sampler)
                for i in range(4)]

        cts = enc()

        def reg():
            du = S.neg(ctx, S.add(
                ctx, gemv_apply(ctx, mat_A, S.sub(ctx, cts[0], cts[2])),
                gemv_apply(ctx, mat_B, S.sub(ctx, cts[1], cts[3]))))
            return S.add(ctx, S.mod_down_to(ctx, cts[1], du.limbs), du)

        ct_u = reg()

        def dec():
            return S.decode_ri(ctx, S.decrypt(ctx, keys, ct_u))

        # the step's plaintext: u = v1 - (K_A (v0 - v2) + K_B (v1 - v3))
        # on the gains' rows, v1 elsewhere
        vn = v.cpu().numpy()
        want = vn[1].copy()
        rows = K_A.shape[0]
        want[:, :rows] -= ((vn[0] - vn[2])[:, :K_A.shape[1]] @ K_A.T
                           + (vn[1] - vn[3])[:, :K_B.shape[1]] @ K_B.T)
        rec = {"B": B,
               "max_err": float(np.abs(dec()[0].cpu().numpy() - want).max())}
        for name, fn in (("enc", enc), ("reg", reg), ("dec", dec)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / reps * 1e3
            prof = profile_kernels(lambda: [fn() for _ in range(reps)])
            rec[name] = {"device_ms": prof["device_ms"] / reps,
                         "host_ms": host,
                         "kernel_launches": prof["kernel_launches"] / reps}
        out.append(rec)
    return out


# bench.py's ct x ct preset at logN=14 (its BASELINE config #3 shape)
BENCH14 = CKKSPreset(name="bench14", logn=14, slots=64, scale_bits=50,
                     limb_bits=25, mult_depth=5)


def ctct(device, preset: CKKSPreset = BENCH14, compact: bool = False):
    """CTCT_BATCH ct x ct multiplies + rescale as one batched call at
    `preset` against one shared ciphertext (bench.py's ct x ct protocol),
    the relinearisation key stored with its Shoup companions or, when
    `compact`, without (the same draws either way); the product of row 0
    decoded to 1e-6.  Returns (record, the product's residues)."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.keyswitch import (_key_bytes, gen_relin_key,
                                                mul_ct)

    ctx = make_context(preset)
    keys = S.keygen(ctx, S.TorchSampler(0, device), device)
    relin = gen_relin_key(ctx, keys, S.TorchSampler(1, device), compact)
    rng = np.random.default_rng(0)
    batch, iters, k = CTCT_BATCH, CTCT_ITERS, ctx.max_limbs
    v = torch.from_numpy(rng.uniform(-1, 1, (batch, ctx.slots))).to(device)
    w = torch.from_numpy(rng.uniform(-1, 1, ctx.slots)).to(device)
    sampler = S.TorchSampler(3, device)
    a = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)), k),
                  sampler)
    b = S.encrypt(ctx, keys, S.encode(ctx, (w, torch.zeros_like(w)), k),
                  sampler)

    def mult():
        return S.rescale_pair(ctx, mul_ct(ctx, a, b, relin))

    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        out = mult()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = mult()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    re, _ = S.decode_ri(ctx, S.decrypt(ctx, keys, S.Ciphertext(
        out.data[0], out.scale)))
    err = float((re - v[0] * w).abs().max())
    if not err < 1e-6:
        raise AssertionError(f"ct x ct product off by {err}")
    rec = {"preset": preset.name, "B": batch, "limbs": k, "compact": compact,
           "key_bytes": _key_bytes(ctx, compact),
           "mults_per_s": iters * batch / wall,
           "ms_per_batched_call": wall / iters * 1e3, "max_err_row0": err,
           "peak_device_bytes": torch.cuda.max_memory_allocated(device)}
    return rec, out.data


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the batch bench is of the device")
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.bench.ntt_kernels import card_line

    device = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"[batch] {torch.cuda.get_device_name(0)} | {card}", flush=True)
    ref = reference_setup(device)
    rec = collections.OrderedDict(device=torch.cuda.get_device_name(0),
                                  card=card, torch=torch.__version__)
    rec["reference_hempc"] = reference_curve(ref, device)
    rec["phases"] = phases(ref, device)
    print(f"[batch] phases {json.dumps(rec['phases'])}", flush=True)
    del ref
    rec["ctct_logn14"] = ctct(device)[0]
    print(f"[batch] ctct {json.dumps(rec['ctct_logn14'])}", flush=True)
    torch.cuda.empty_cache()
    rec["flagship_fused"] = fused_curve(flagship_setup(device), device)
    torch.cuda.empty_cache()
    model, plant = cli.cstr_setup()
    B0 = qp_envelope(model, plant, qp_disturbance(plant))[0]
    rec["flagship_qp"] = qp_curve(device, model, plant, B0,
                                  qp_regulator(device, model, plant, B0))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
