"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  0. require CUDA; print the card's name and power limit
  1. build the CUDA kernels from hectr_tpu_torch/csrc, one nvcc per
     source, all at once (timed)
  2. NTT kernels vs plain PyTorch, bit for bit, over real prime chains
     (logN 8/12/15, L 1/5/24/34, batch ()/(2,)/(11,)) and over every
     logN 1-15 at 1, 3, 4, 22, 44 and 264 rows (every cluster size the
     wrapper picks), and their times, bounds and shares of the bound at
     the shapes the encrypted loops give them, each bit-equal and timed
     at every cluster size (hectr_tpu_torch.bench.ntt_kernels)
  3. the REFERENCE_HEMPC encrypted CSTR loop (40 steps, every rotation
     key) through the CLI's functions: <= 5e-10 per channel against the
     plaintext twin, canary < 1e-5, golden cstr-hempc.bin to 1e-6
  4. the FLAGSHIP loop (logN=15, 24-prime chain, BSGS rotation keys,
     horizon 4): <= 2e-9 per channel, canary < 1e-5, final state
  5. the multiply-ceiling probe K3 (hectr_tpu_torch.bench.vpu_ceiling):
     kernel bit-equal to the plain chain at small r and over the full
     [4096, 128] x 512 x 4 chain, the pow identity, kernel and plain
     times, multiplies/s, SASS instructions per multiply, and the NTT
     kernel's share of the ceiling
  6. the fused single-ciphertext regulator at FLAGSHIP (40 steps, the
     keys of phase 4): <= 2e-9 per channel, canary < 1e-5, final state
  7. the constrained encrypted loop at FLAGSHIP_QP as
     scripts/run_flagship_qp_tpu.py sets it up (compact relinearisation
     and BSGS keys, du box, degree-7 2-iteration PGD, 10 steps): the
     plaintext mirror's eta, envelope and certificate equal the JAX
     run's; <= 1e-4 per channel against the mirror, box honored to 1e-4
     and active, canary < 1e-5
  8. "he": the reference's he_* call sequence at its exact parameters
     (hectx_init(12, 109, 16, 50), 15 rotation keys, 4 encryptions, 2
     gemvs): the control law to 1e-8, canary < 1e-5, the realized
     modulus and security estimate printed; the native CRT oracle
     (csrc/hectr_host.cpp, built with g++) on the decrypted plaintext
  9. "medium": MEDIUM at full width (logN=14, 8192 slots, 12 limbs):
     FFT embedding on the card = the CPU's to 1e-12; encrypt/decrypt of
     8192 complex slots to 1e-6; rotations by 1 and 7; a 5-level ct x ct
     chain (compact relinearisation key, 12 -> 2 limbs) to 1e-6 per
     level; a dense 8192 x 8192 BSGS gemv (180 compact keys) to 1e-4 of
     M v, with its key and plaintext-grid bytes, peak device memory and
     times
 10. each kernel launched on every path that uses it (K1/K2 in phases
     3, 4, 6-9, with their launches by shape; K3 in phase 5); each
     phase's wall time, the kernel summary, the card, and as the last
     line {"ok": true, "device": {...}}
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
FLAGSHIP_FINAL_STATE = np.array([0.895, 321.8075, 0.7655])
# the JAX package's constrained FLAGSHIP_QP run (its mirror is exact
# float64 host arithmetic, so its numbers carry over)
QP_SUMMARY = ROOT / "results" / "flagship_qp_tpu" / "summary.json"
# batch + (L,) of the NTT sweep: 1, 3, 4, 22, 44 and 264 rows
ROW_SHAPES = ((1,), (3,), (2, 2), (22,), (2, 22), (11, 24))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_residues(primes, batch, n, gen, device):
    """Uniform residues [*batch, L, n] with 0 and p-1 planted per row."""
    rows = [torch.randint(0, p, (*batch, n), generator=gen, device=device)
            for p in primes]
    a = torch.stack(rows, dim=-2)
    a[..., 0] = 0
    a[..., 1] = torch.tensor(primes, device=device) - 1
    return a


def sweep_chain(logn: int) -> tuple[int, ...]:
    """24 NTT primes for rows of 2^logn, 30-bit and 25-bit alternating."""
    from hectr_tpu_torch.ckks.primes import find_ntt_primes

    two_n = 2 << logn
    return tuple(p for pair in zip(find_ntt_primes(30, 12, two_n),
                                   find_ntt_primes(25, 12, two_n))
                 for p in pair)


def phase_kernels(device, kernel_rows):
    from hectr_tpu_torch.bench import ntt_kernels
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.config import FLAGSHIP_QP, CKKSPreset
    from hectr_tpu_torch.ops import ntt_cuda

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = 0
    max_err = {"ntt": 0, "intt": 0}
    for logn in (8, 12, 15):
        # a 34-prime chain (32 data + 2 special) at this ring size; its
        # prefixes mix 30-bit base/special and 25-bit scale primes
        preset = FLAGSHIP_QP if logn == 15 else CKKSPreset(
            name=f"smoke-{logn}", logn=logn, slots=16, scale_bits=50,
            limb_bits=25, mult_depth=15, special_limbs=2, digit_width=2)
        chain = make_context(preset).full_primes
        for L in (1, 5, 24, 34):
            t = T.ntt_tables(1 << logn, chain[:L], device)
            for batch in ((), (2,), (11,)):
                a = random_residues(chain[:L], batch, 1 << logn, gen, device)
                fwd = T.ntt(a, t)
                inv = T.intt(fwd, t)
                ref_fwd = T.ntt_plain(a, t)
                ref_inv = T.intt_plain(fwd, t)
                torch.cuda.synchronize()
                max_err["ntt"] = max(max_err["ntt"], int(
                    (fwd - ref_fwd).abs().max()))
                max_err["intt"] = max(max_err["intt"], int(
                    (inv - ref_inv).abs().max()))
                check(torch.equal(fwd, ref_fwd),
                      f"ntt != plain at logN={logn} L={L} batch={batch}")
                check(torch.equal(inv, ref_inv),
                      f"intt != plain at logN={logn} L={L} batch={batch}")
                check(torch.equal(inv, a),
                      f"intt(ntt(a)) != a at logN={logn} L={L} batch={batch}")
                cases += 1
    print(f"[kernels] {cases} cases bit-equal to plain (ntt, intt, "
          f"roundtrip); max |kernel - plain| = {max_err}", flush=True)

    # every ring size over row counts that reach every cluster size
    clusters = set()
    for logn in range(1, 16):
        chain = sweep_chain(logn)
        for lead in ROW_SHAPES:
            t = T.ntt_tables(1 << logn, chain[:lead[-1]], device)
            a = random_residues(t.primes, lead[:-1], 1 << logn, gen, device)
            fwd = T.ntt(a, t)
            inv = T.intt(fwd, t)
            ok = (torch.equal(fwd, T.ntt_plain(a, t))
                  and torch.equal(inv, T.intt_plain(fwd, t))
                  and torch.equal(inv, a))
            check(ok, f"kernel != plain at logN={logn}, shape {lead}")
            clusters.add(ntt_cuda.geometry(a.numel() >> logn, logn).cluster)
            cases += 1
    check(clusters == {1, 2, 4, 8}, f"cluster sizes reached: {clusters}")
    print(f"[kernels] logN 1-15 x rows {[int(np.prod(s)) for s in ROW_SHAPES]}"
          f" bit-equal to plain as well ({cases} cases in all; clusters of "
          f"{sorted(clusters)} CTAs)", flush=True)

    # times at the loops' shapes, beside the bound and every cluster size
    for rec in ntt_kernels.measure(device):
        by_cluster = {c["cluster"]: round(c["ms"], 4)
                      for c in rec["by_cluster"]}
        print(f"[kernels] {rec['kernel']} {rec['shape']} ({rec['label']}; "
              f"{rec['cluster']} CTAs x {rec['threads']} threads a row, "
              f"passes {rec['passes']}): kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) = {rec['share_of_bound']:.3f} of it; "
              f"ms by CTAs a row {by_cluster}", flush=True)
        if rec["label"] == "flagship digit stack":
            kernel_rows[rec["kernel"]].update(
                max_abs_err=max_err[rec["kernel"]], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=None)


def reset_launches() -> None:
    from hectr_tpu_torch.ops import mulmod_cuda, ntt_cuda

    ntt_cuda.reset_launches()
    mulmod_cuda.reset_launches()


def read_launches() -> dict:
    from hectr_tpu_torch.ops import mulmod_cuda, ntt_cuda

    return {**ntt_cuda.LAUNCHES, **mulmod_cuda.LAUNCHES}


def print_launch_shapes(label: str, per: int, what: str) -> None:
    """The NTT kernels' launches since the last reset, by input shape,
    divided by `per` (the phase's steps)."""
    from hectr_tpu_torch.ops import ntt_cuda

    shapes = {f"{name} {list(shape)}": round(n / per, 3)
              for (name, shape), n in sorted(ntt_cuda.LAUNCH_SHAPES.items())}
    print(f"[{label}] NTT launches per {what} by shape: {json.dumps(shapes)}",
          flush=True)


def deviations(x, u, x_ref, u_ref) -> np.ndarray:
    """max |a - b| per channel (c, T, h, Tc, F)."""
    return np.concatenate([np.max(np.abs(x - x_ref), axis=0),
                           np.max(np.abs(u - u_ref), axis=0)])


def run_loop(label, preset, rotations, device, card):
    from hectr_tpu_torch import cli

    t0 = time.perf_counter()
    ctx, keys, rot_keys = cli.hempc_keys(preset, 0, device, rotations)
    x_pt, u_pt = cli.run_cstr_mpc(40, device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    x, u, canary = cli.run_cstr_hempc(ctx, keys, rot_keys, 40, 0, device)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = read_launches()
    print_launch_shapes(label, 40, "step")

    check(x.shape == (41, 3) and u.shape == (40, 2), f"{label}: shapes")
    check(bool(np.isfinite(x).all() and np.isfinite(u).all()),
          f"{label}: non-finite trajectory")
    dev = deviations(x, u, x_pt, u_pt)
    print(f"[{label}] keygen + {len(rot_keys)} rotation keys + plaintext "
          f"twin {t_setup:.2f} s; 40-step encrypted loop {t_loop:.3f} s = "
          f"{40 / t_loop:.2f} steps/s on {card}", flush=True)
    print(f"[{label}] max |encrypted - plaintext| per channel (c, T, h, Tc, "
          f"F) = {dev.tolist()}; canary {canary:.3e}; final state "
          f"{x[-1].tolist()}; launches {launches}", flush=True)
    return x, u, dev, canary, launches, (ctx, keys, rot_keys, x_pt, u_pt)


def phase_ceiling(device, kernel_rows, card):
    """K3: the multiply-ceiling probe, and the NTT kernel's share of it."""
    from hectr_tpu_torch.bench import HBM_BYTES_PER_S, lazy_mult_peak_per_s
    from hectr_tpu_torch.bench import vpu_ceiling as V
    from hectr_tpu_torch.ops import build

    x0, c = V.probe_inputs(device)
    err = V.check_kernel(x0, c)
    print(f"[ceiling] mulmod chain kernel bit-equal to plain at r = 0, 1, 2, "
          f"3, 16 and over [{V.ROWS}, {V.LANES}] x {V.R_CHAIN} x {V.CALLS}; "
          f"max |kernel - plain| = {err}", flush=True)
    plain = V.plain_ms(x0, c)
    reset_launches()
    res = V.probe(x0, c)
    launches = read_launches()
    check(launches["mulmod_chain"] > 0, "mulmod chain kernel never launched "
          "in the probe")
    sass = V.sass_loop_body(
        V.kernel_sass(build.library_path("mulmod_chain.cu")),
        "mulmod_chain_kernel")
    ntt_ms = kernel_rows["ntt"]["ms"]
    rate, share = V.ntt_share(ntt_ms, res["mult_per_s"])
    print(f"[ceiling] pow probe ok (x * w^{V.R_CHAIN * V.CALLS} mod p); "
          f"kernel {res['ms']:.4f} ms, plain {plain:.4f} ms per dispatch of "
          f"{V.CALLS} x {V.R_CHAIN} chained multiplies on [{V.ROWS}, "
          f"{V.LANES}] ({plain / res['ms']:.1f}x) = "
          f"{res['mult_per_s']:.4e} lazy-Shoup mult/s on {card}", flush=True)
    print(f"[ceiling] SASS loop body: {sass['body_instructions']} "
          f"instructions for {sass['multiplies']} multiplies = "
          f"{sass['per_multiply']:.3f} per multiply; {sass['opcodes']}",
          flush=True)
    print(f"[ceiling] ntt [11, 24, 2^15] at {ntt_ms:.4f} ms = 264 x 15 x "
          f"2^14 Shoup multiplies = {rate:.4e} mult/s = {share:.4f} of the "
          f"ceiling", flush=True)
    # the bound of one dispatch: the block in and out once, against its
    # multiplies at the integer multiply peak
    peak = lazy_mult_peak_per_s()
    t_ops = V.ROWS * V.LANES * V.R_CHAIN * V.CALLS / peak * 1e3
    t_bytes = (V.ROWS * V.LANES * 8 * 2 + V.LANES * 4 * 3) / HBM_BYTES_PER_S * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                                 "bytes")
    print(f"[ceiling] bound of one dispatch {bound:.4f} ms ({by}: "
          f"{peak:.4e} lazy-Shoup mult/s = SMs x 64 IMAD/clock x the maximum "
          f"SM clock / 3); the kernel at {bound / res['ms']:.4f} of it",
          flush=True)
    kernel_rows["mulmod_chain"].update(launches=launches["mulmod_chain"],
                                       max_abs_err=err, ms=res["ms"],
                                       plain_ms=plain, bound_ms=bound,
                                       bound_by=by, library_ms=None)


def phase_fused(device, flagship, card):
    """The fused single-ciphertext regulator at FLAGSHIP, 40 steps."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.hempc import hempc_init_state
    from hectr_tpu_torch.hempc.fused import (make_fused_materials,
                                             make_fused_regulator)

    ctx, keys, rot_keys, x_pt, u_pt = flagship
    model, plant = cli.cstr_setup()
    reset_launches()
    t0 = time.perf_counter()
    mats = make_fused_materials(ctx, rot_keys, model, plant, 4, device)
    reg = make_fused_regulator(ctx, keys, model, plant, 4, mats)
    x, u, (_, canary) = simulate(
        model, plant, cli.disturbance(40), 1.0, 40, device, regulator=reg,
        regulator_state=hempc_init_state(TorchSampler(2, device), device),
        horizon=4, return_state=True)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = read_launches()
    print_launch_shapes("fused", 40, "step")
    canary = float(canary)
    check(x.shape == (41, 3) and u.shape == (40, 2)
          and bool(np.isfinite(x).all() and np.isfinite(u).all()),
          "fused: shapes or non-finite trajectory")
    dev = deviations(x, u, x_pt, u_pt)
    print(f"[fused] 40-step fused encrypted loop {t_loop:.3f} s = "
          f"{40 / t_loop:.2f} steps/s on {card}", flush=True)
    print(f"[fused] max |encrypted - plaintext| per channel (c, T, h, Tc, F) "
          f"= {dev.tolist()}; canary {canary:.3e}; final state "
          f"{x[-1].tolist()}; launches {launches}", flush=True)
    check(bool((dev <= 2e-9).all()), f"fused deviation {dev}")
    check(canary < 1e-5, f"fused canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"fused final state {x[-1]}")
    return launches


def phase_qp(device, card):
    """The constrained encrypted loop at FLAGSHIP_QP, set up as
    scripts/run_flagship_qp_tpu.py sets it up, against its plaintext
    mirror and the JAX run's recorded mirror numbers."""
    from hectr_tpu_torch import cli
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ckks.keyswitch import gen_relin_key, gen_rotation_keys
    from hectr_tpu_torch.config import FLAGSHIP_QP
    from hectr_tpu_torch.control.mpc import MPCBounds, mpc_hessian
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.control.stages import weighting_matrices
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
    from hectr_tpu_torch.hempc.qp_enc import (make_pgd_mirror_regulator,
                                              pgd_eta, pgd_limbs_required)

    want = json.loads(QP_SUMMARY.read_text())
    bounds = MPCBounds(dumin=np.array([-0.25, -0.004]),
                       dumax=np.array([0.25, 0.004]))
    iters, degree, horizon, steps = 2, 7, 4, 10
    model, plant = cli.cstr_setup()
    p_seq = np.zeros((steps, 1))
    p_seq[2:, 0] = 0.1 * plant.ps[0]          # +10% inlet flow from k=2

    # the plaintext mirror on the host; the envelope B0 is widened until
    # the trajectory's input certificate fits under it
    cpu = torch.device("cpu")
    B0 = 4.0
    for _ in range(3):
        mirror = make_pgd_mirror_regulator(model, plant, horizon, bounds, cpu,
                                           iters=iters, degree=degree,
                                           input_bound=B0)
        x_m, u_m, cert = simulate(
            model, plant, p_seq, 1.0, steps, cpu, regulator=mirror,
            horizon=horizon,
            regulator_state=torch.zeros((), dtype=torch.float64),
            return_state=True)
        cert = float(cert)
        if cert <= B0:
            break
        B0 = float(np.ceil(cert) + 1.0)
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    H = mpc_hessian(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
    lb = np.tile(bounds.dumin, horizon)
    ub = np.tile(bounds.dumax, horizon)
    eta = pgd_eta(H, lb, ub, B0)
    wq = want["qp"]
    rel_eta = abs(eta - wq["eta"]) / wq["eta"]
    rel_cert = (abs(cert - want["input_certificate"])
                / want["input_certificate"])
    print(f"[flagship-qp] mirror: eta {eta!r} (JAX run {wq['eta']!r}, rel. "
          f"{rel_eta:.2e}), envelope B0 {B0} (JAX run {wq['input_bound']}), "
          f"certificate {cert!r} (JAX run {want['input_certificate']!r}, rel. "
          f"{rel_cert:.2e})", flush=True)
    check(cert <= B0, f"mirror certificate {cert} > envelope {B0}")
    # cond(H) = 3.1e8, so the float64 gains (and with them the
    # certificate) agree across BLAS/LAPACK builds only to about
    # eps * cond(H) = 7e-8 relative; on one machine the port's mirror
    # equals the JAX package's to ~1e-15 (tests/test_torch_qp_enc.py)
    check(rel_eta <= 1e-7 and B0 == wq["input_bound"] and rel_cert <= 1e-7,
          "mirror differs from results/flagship_qp_tpu/summary.json")

    ctx = make_context(FLAGSHIP_QP)
    need = pgd_limbs_required(degree, iters, "w_scaled")
    check(need == wq["depth_ledger"]["needed"]
          and ctx.max_limbs - 2 - need == len(ctx.base_primes),
          f"depth ledger: {need} limbs below k_in = {ctx.max_limbs - 2}")
    t0 = time.perf_counter()
    keys = S.keygen(ctx, S.TorchSampler(51, device), device)
    relin = gen_relin_key(ctx, keys, S.TorchSampler(52, device), compact=True)
    rot_keys = gen_rotation_keys(ctx, keys, S.TorchSampler(53, device),
                                 rotations=bsgs_rotations(ctx.slots),
                                 compact=True)
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, horizon,
                               bounds=bounds, relin_key=relin,
                               qp_iters=iters, qp_degree=degree,
                               qp_input_bound=B0)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    step_s = []

    def timed(state, *args):
        t = time.perf_counter()
        out = reg(state, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    reset_launches()
    x, u, (_, canary) = simulate(
        model, plant, p_seq, 1.0, steps, device, regulator=timed,
        regulator_state=hempc_init_state(S.TorchSampler(54, device), device),
        horizon=horizon, return_state=True)
    torch.cuda.synchronize()
    launches = read_launches()
    print_launch_shapes("flagship-qp", steps, "step")
    canary = float(canary)
    check(x.shape == (steps + 1, 3) and u.shape == (steps, 2)
          and bool(np.isfinite(x).all() and np.isfinite(u).all()),
          "flagship-qp: shapes or non-finite trajectory")
    dev = deviations(x, u, x_m, u_m)
    du = np.diff(u, axis=0)
    box_ok = bool(np.all(du <= bounds.dumax + 1e-4)
                  and np.all(du >= bounds.dumin - 1e-4))
    active = float(np.max(np.abs(du[:, 0])) / bounds.dumax[0])
    print(f"[flagship-qp] keygen + compact relin + {len(rot_keys)} "
          f"compact BSGS keys + regulator build {t_setup:.2f} s; median "
          f"regulator step {np.median(step_s) * 1e3:.1f} ms over {steps} "
          f"steps on {card}", flush=True)
    print(f"[flagship-qp] max |encrypted - mirror| per channel (c, T, h, Tc, "
          f"F) = {dev.tolist()}; box honored {box_ok}, activity {active:.4f}; "
          f"canary {canary:.3e}; launches {launches}", flush=True)
    check(bool((dev < 1e-4).all()), f"flagship-qp deviation {dev}")
    check(box_ok, "flagship-qp: du outside the box")
    check(active > 0.8, f"flagship-qp: box not active ({active})")
    check(canary < 1e-5, f"flagship-qp canary {canary}")
    return launches


def facade_problem():
    """The op chain's data of tests/test_he_facade.py (src/hempc.c:240-266);
    the port's facade tests build their problem here too."""
    rng = np.random.default_rng(0)
    xhat = np.zeros(16, np.complex128)
    xhat[:3] = rng.uniform(-1, 1, 3)
    xr = np.zeros(16, np.complex128)
    xr[:3] = rng.uniform(-1, 1, 3)
    uhat = np.zeros(16, np.complex128)
    uhat[:2] = rng.uniform(-1, 1, 2)
    ur = np.zeros(16, np.complex128)
    K_A = np.zeros((16, 16))
    K_A[:8, :3] = rng.normal(size=(8, 3))
    K_B = np.zeros((16, 16))
    K_B[:8, :2] = rng.normal(size=(8, 2))
    return xhat, xr, uhat, ur, K_A, K_B


def phase_he(device, card):
    """The reference's he_* call sequence at its exact parameters, and the
    native CRT oracle on the decrypted plaintext."""
    from hectr_tpu_torch import he, native
    from hectr_tpu_torch.ckks.encoding import unembed
    from hectr_tpu_torch.ckks.modmath import from_rns
    from hectr_tpu_torch.ckks.ntt import intt

    xhat, xr, uhat, ur, K_A, K_B = facade_problem()
    reset_launches()
    t0 = time.perf_counter()
    hc = he.hectx_init(12, 109, 16, 50, seed=0, verbose=True, device=device)
    he.he_keypair(hc)
    he.he_genrk(hc)
    ct_xhat, ct_uhat, ct_xr, ct_ur = (he.he_enc_pk(hc, he.he_ecd(hc, v))
                                      for v in (xhat, uhat, xr, ur))
    xdiff = he.he_sub(hc, ct_xhat, ct_xr)
    udiff = he.he_sub(hc, ct_uhat, ct_ur)
    du = he.he_neg(hc, he.he_add(hc, he.he_gemv(hc, K_A, xdiff),
                                 he.he_gemv(hc, K_B, udiff)))
    u = he.he_add(hc, he.he_moddown(hc, he.he_copy_ct(hc, ct_uhat)), du)
    pt = he.he_dec(hc, u)
    got = he.he_dcd(hc, pt).cpu().numpy()
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    launches = read_launches()
    print_launch_shapes("he", 1, "call sequence")
    want = uhat - (K_A @ (xhat - xr) + K_B @ (uhat - ur))
    err = float(np.max(np.abs(got.real - want.real)))
    canary = float(np.max(np.abs(got.imag)))
    print(f"[he] hectx_init(12, 109, 16, 50): realized logQ "
          f"{hc.realized_logq}, logQP {hc.realized_logqp}, depth {hc.depth}, "
          f"security ~{hc.security_bits:.1f} bits; {len(hc.rot_keys)} rotation "
          f"keys; whole call sequence {t_seq:.3f} s on {card}", flush=True)
    print(f"[he] max |u - (uhat - K_A (xhat - xr) - K_B (uhat - ur))| = "
          f"{err:.3e}, canary {canary:.3e}; launches {launches}", flush=True)
    check(hc.realized_logqp > hc.realized_logq > 0 and hc.security_bits > 0,
          "he: realized modulus not reported")
    check(err <= 1e-8, f"he: control law off by {err}")
    check(canary < 1e-5, f"he canary {canary}")

    # the exact host oracle on the base residues of the decrypted
    # plaintext: its coefficients over the scale decode to the same slots
    ctx = hc.ctx
    kb = len(ctx.base_primes)
    check(pt.limbs == kb, f"he: plaintext at {pt.limbs} limbs, not {kb}")
    t0 = time.perf_counter()
    res = intt(pt.data, ctx.tables(kb, device)).cpu()
    coeffs = native.crt_centered(res, ctx.base_primes)
    t_crt = time.perf_counter() - t0
    check(all(int(a) == int(b) for a, b in
              zip(coeffs, from_rns(res, ctx.base_primes))),
          "he: native CRT differs from the pure-Python CRT")
    stride = ctx.n // (2 * ctx.slots)
    m = torch.tensor([float(c) / float(pt.scale) for c in coeffs[::stride]],
                     dtype=torch.float64)
    re, im = unembed(m, ctx.slots)
    crt_err = float(max(np.abs(re.numpy() - got.real).max(),
                        np.abs(im.numpy() - got.imag).max()))
    print(f"[he] native crt_centered ({native.LIBRARY.name}, g++) on the "
          f"decrypted plaintext's {kb} base limbs x {ctx.n}: {t_crt:.3f} s; "
          f"its slots vs he_dcd max {crt_err:.3e}", flush=True)
    check(crt_err <= 1e-9, f"he: exact CRT decode differs by {crt_err}")
    he.hectx_exit(hc)
    return launches


def phase_medium(device, card):
    """MEDIUM at full width: FFT embedding on the card, encrypt/decrypt,
    rotations, a 5-level ct x ct chain and a dense BSGS gemv over all
    slots."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.encoding import embed_ri, unembed
    from hectr_tpu_torch.ckks.gemv import (bsgs_rotations, gemv_apply,
                                           gemv_materials)
    from hectr_tpu_torch.ckks.keyswitch import (gen_relin_key,
                                                gen_rotation_keys, mul_ct,
                                                rotate)
    from hectr_tpu_torch.config import MEDIUM

    ctx = make_context(MEDIUM)
    s, k = ctx.slots, ctx.max_limbs
    rng = np.random.default_rng(0)

    def sync():
        torch.cuda.synchronize()

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def decoded(ct):
        return S.decode(ctx, S.decrypt(ctx, keys, ct)).cpu().numpy()

    # 1. the FFT embedding on the card against the CPU
    vre, vim = rng.uniform(-5, 5, s), rng.uniform(-5, 5, s)
    m_cpu = embed_ri(torch.from_numpy(vre), torch.from_numpy(vim), s)
    m_dev = embed_ri(on(vre), on(vim), s)
    r_cpu, i_cpu = unembed(m_cpu, s)
    r_dev, i_dev = unembed(m_dev, s)
    e_embed = float((m_dev.cpu() - m_cpu).abs().max())
    e_unembed = float(max((r_dev.cpu() - r_cpu).abs().max(),
                          (i_dev.cpu() - i_cpu).abs().max()))
    e_round = float(max(np.abs(r_dev.cpu().numpy() - vre).max(),
                        np.abs(i_dev.cpu().numpy() - vim).max()))
    print(f"[medium] {ctx.preset.name}: logN={ctx.preset.logn}, {s} slots, "
          f"{k} data + {len(ctx.special_primes)} special limbs, "
          f"{ctx.dnum(k)} digits; FFT embedding card vs CPU: embed "
          f"{e_embed:.3e}, unembed {e_unembed:.3e}; unembed(embed(v)) - v "
          f"{e_round:.3e}", flush=True)
    check(max(e_embed, e_unembed, e_round) <= 1e-12,
          "medium: FFT embedding off on the card")

    reset_launches()
    # 2. encrypt / decrypt of s complex slots
    t0 = time.perf_counter()
    keys = S.keygen(ctx, S.TorchSampler(61, device), device)
    enc = S.TorchSampler(62, device)
    v = vre + 1j * vim
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(v), k), enc)
    got = decoded(ct)
    t_rt = time.perf_counter() - t0
    e_rt = float(max(np.abs(got.real - vre).max(), np.abs(got.imag - vim).max()))

    # 3. rotations by 1 and 7
    rk = gen_rotation_keys(ctx, keys, S.TorchSampler(63, device),
                           rotations=[1, 7])
    vr = rng.uniform(-3, 3, s)
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(vr + 0j), k), enc)
    e_rot, c_rot = [], []
    for r in (1, 7):
        got = decoded(rotate(ctx, ct, r, rk))
        e_rot.append(float(np.abs(got.real - np.roll(vr, -r)).max()))
        c_rot.append(float(np.abs(got.imag).max()))
    del rk
    print(f"[medium] encrypt/decrypt of {s} complex slots U(-5,5): max err "
          f"{e_rt:.3e} (keygen + encode + encrypt + decrypt + decode "
          f"{t_rt:.3f} s); rotate by 1, 7: max err {e_rot}, max |imag| "
          f"{c_rot}", flush=True)
    check(e_rt <= 1e-6, f"medium roundtrip {e_rt}")
    check(max(e_rot) <= 1e-6 and max(c_rot) < 1e-4, "medium rotation")

    # 4. ct x ct chain: enc(v) * enc(w)^i, 12 -> 2 limbs
    relin = gen_relin_key(ctx, keys, S.TorchSampler(64, device), compact=True)
    v = rng.uniform(-0.7, 0.7, s) + 1j * rng.uniform(-0.7, 0.7, s)
    w = rng.uniform(-0.7, 0.7, s) + 1j * rng.uniform(-0.7, 0.7, s)
    a = S.encrypt(ctx, keys, S.encode(ctx, on(v), k), enc)
    b = S.encrypt(ctx, keys, S.encode(ctx, on(w), k), enc)
    step_ms = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        S.rescale_pair(ctx, mul_ct(ctx, a, b, relin))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    want, chain_err, levels = v, [], []
    while a.limbs > 2:
        a = S.rescale_pair(ctx, mul_ct(ctx, a, S.mod_down_to(ctx, b, a.limbs),
                                       relin))
        want = want * w
        chain_err.append(float(np.abs(decoded(a) - want).max()))
        levels.append(a.limbs)
    del relin
    print(f"[medium] ct x ct chain (compact relin key): limbs {levels}, max "
          f"|dec - v w^i| per level {chain_err}; mul_ct + rescale at k={k}: "
          f"median {np.median(step_ms):.3f} ms over 5 calls on {card}",
          flush=True)
    check(len(chain_err) == (k - 2) // 2 and max(chain_err) <= 1e-6,
          f"medium ct x ct chain {chain_err}")

    # 5. dense BSGS gemv over every slot
    M = np.random.default_rng(9).normal(size=(s, s)) / np.sqrt(s)
    vg = rng.uniform(-2, 2, s)
    sync()
    t0 = time.perf_counter()
    rk = gen_rotation_keys(ctx, keys, S.TorchSampler(65, device),
                           rotations=bsgs_rotations(s), compact=True)
    sync()
    t_keys = time.perf_counter() - t0
    key_bytes = sum(x.numel() * x.element_size() for x in rk.values())
    t0 = time.perf_counter()
    mat = gemv_materials(ctx, M, k, rk, device, method="bsgs")
    sync()
    t_mat = time.perf_counter() - t0
    b = mat["bsgs"]
    grid = [g["pt"] for g in b["giant"]]
    if "pt0" in b:
        grid.append(b["pt0"])
    grid_bytes = sum(x.numel() * x.element_size() for x in grid)
    ct = S.encrypt(ctx, keys, S.encode(ctx, on(vg + 0j), k), enc)
    gemv_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        out = gemv_apply(ctx, mat, ct)
        sync()
        gemv_ms.append((time.perf_counter() - t0) * 1e3)
    got = decoded(out)
    launches = read_launches()
    print_launch_shapes("medium", 1, "phase (keygen, chain, 3 gemvs)")
    e_gemv = float(np.abs(got.real - M @ vg).max())
    c_gemv = float(np.abs(got.imag).max())
    peak = torch.cuda.max_memory_allocated(device)
    print(f"[medium] dense {s} x {s} BSGS gemv at k={k}: {len(rk)} compact "
          f"keys ({key_bytes} B on the card) in {t_keys:.2f} s; materials "
          f"({len(grid)} x {b['n1']} diagonal plaintexts, {grid_bytes} B) in "
          f"{t_mat:.2f} s; median gemv {np.median(gemv_ms):.1f} ms over 3 "
          f"calls ({[round(x, 1) for x in gemv_ms]}); max |dec - M v| "
          f"{e_gemv:.3e}, max |imag| {c_gemv:.3e}; peak device memory "
          f"{peak} B on {card}; launches {launches}", flush=True)
    check(e_gemv <= 1e-4 and c_gemv < 1e-3, f"medium gemv {e_gemv}, {c_gemv}")
    del mat, b, grid, rk, keys
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from hectr_tpu_torch.config import FLAGSHIP, REFERENCE_HEMPC
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ops import build, mulmod_cuda, ntt_cuda
    from hectr_tpu_torch.utils import read_traj_bin

    from hectr_tpu_torch.utils.pmu import Timer

    timer = Timer()          # each phase's wall time, device synchronized
    with timer.section("build"):
        sources = ("ntt.cu", "mulmod_chain.cu")
        libs = build.build(*sources)
        ntt_cuda.library()
        mulmod_cuda.library()
    print(f"[build] nvcc sm_90a hectr_tpu_torch/csrc/{{{','.join(sources)}}} "
          f"(in parallel) -> {[lib.name for lib in libs]} "
          f"{timer.sections['build']:.2f} s", flush=True)

    kernel_rows = {
        "ntt": {"name": "ntt_fwd", "route": "cuda",
                "source": "hectr_tpu_torch/csrc/ntt.cu",
                "replaces": "hectr_tpu/ops/ntt_pallas.py:272"},
        "intt": {"name": "ntt_inv", "route": "cuda",
                 "source": "hectr_tpu_torch/csrc/ntt.cu",
                 "replaces": "hectr_tpu/ops/ntt_pallas.py:315"},
        "mulmod_chain": {"name": "mulmod_chain", "route": "cuda",
                         "source": "hectr_tpu_torch/csrc/mulmod_chain.cu",
                         "replaces": "scripts/bench_vpu_ceiling.py:61"},
    }
    with timer.section("kernels"):
        phase_kernels(device, kernel_rows)

    with timer.section("reference-hempc"):
        x, u, dev, canary, launches_ref, _ = run_loop(
            "reference-hempc", REFERENCE_HEMPC, None, device, card)
    check(bool((dev <= 5e-10).all()), f"reference deviation {dev}")
    check(canary < 1e-5, f"reference canary {canary}")
    golden_x, golden_u = read_traj_bin(ROOT / "tests/golden/cstr-hempc.bin")
    golden = np.hstack([golden_x, golden_u])
    ours = np.hstack([x, np.vstack([u, u[-1:]])])
    rel = np.max(np.abs(ours - golden), axis=0) / np.max(np.abs(golden), axis=0)
    print(f"[reference-hempc] golden cstr-hempc.bin max relative error per "
          f"channel {rel.tolist()}", flush=True)
    check(bool((rel < 1e-6).all()), f"golden mismatch {rel}")

    with timer.section("flagship"):
        x, u, dev, canary, launches_flag, flagship = run_loop(
            "flagship", FLAGSHIP, bsgs_rotations(FLAGSHIP.slots), device, card)
    check(bool((dev <= 2e-9).all()), f"flagship deviation {dev}")
    check(canary < 1e-5, f"flagship canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"flagship final state {x[-1]}")

    with timer.section("ceiling"):
        phase_ceiling(device, kernel_rows, card)
    with timer.section("fused"):
        launches_fused = phase_fused(device, flagship, card)
    del flagship
    with timer.section("flagship-qp"):
        launches_qp = phase_qp(device, card)
    with timer.section("he"):
        launches_he = phase_he(device, card)
    with timer.section("medium"):
        launches_medium = phase_medium(device, card)

    loops = (("reference-hempc", launches_ref), ("flagship", launches_flag),
             ("fused", launches_fused), ("flagship-qp", launches_qp),
             ("he", launches_he), ("medium", launches_medium))
    for label, launches in loops:
        for kname in ("ntt", "intt"):
            check(launches[kname] > 0,
                  f"{kname} kernel never launched in the {label} phase")
    for kname in ("ntt", "intt"):
        kernel_rows[kname]["launches"] = sum(l[kname] for _, l in loops)
    print(f"[phases] wall time per phase (s) on {card}: "
          f"{json.dumps({k: round(v, 2) for k, v in timer.report().items()})}",
          flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
