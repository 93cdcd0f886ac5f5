"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  0. require CUDA; print the card's name and power limit
  1. build the CUDA kernels from hectr_tpu_torch/csrc, one nvcc per
     source, all at once (timed)
  2. NTT kernels vs plain PyTorch, bit for bit, over real prime chains
     (logN 8/12/15, L 1/5/24/34, batch ()/(2,)/(11,)), and their times
     at the shapes the encrypted loop gives them
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
  8. each kernel launched on every path that uses it (K1/K2 in phases
     3, 4, 6, 7; K3 in phase 5); the kernel summary, the card, and as
     the last line {"ok": true, "device": {...}}
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


def phase_kernels(device, kernel_rows):
    from hectr_tpu_torch.bench import cuda_time_ms as time_ms
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.config import FLAGSHIP_QP, PRESETS, CKKSPreset

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

    # times at the loop's shapes: the digit stack of decompose_digits
    times = {}
    for label, preset, shape in (
            ("reference", "reference-hempc", (4, 5, 1 << 12)),
            ("flagship", "flagship", (11, 24, 1 << 15))):
        ctx = make_context(PRESETS[preset])
        t = ctx.tables_ks(ctx.max_limbs, device)
        a = random_residues(t.primes, shape[:1], shape[2], gen, device)
        fwd = T.ntt(a, t)
        check(torch.equal(fwd, T.ntt_plain(a, t))
              and torch.equal(T.intt(fwd, t), T.intt_plain(fwd, t)),
              f"kernel != plain at the {label} loop's shape {shape}")
        row = {
            "ntt": (time_ms(lambda: T.ntt(a, t)),
                    time_ms(lambda: T.ntt_plain(a, t))),
            "intt": (time_ms(lambda: T.intt(fwd, t)),
                     time_ms(lambda: T.intt_plain(fwd, t))),
        }
        times[label] = row
        for name, (k_ms, p_ms) in row.items():
            print(f"[kernels] {name} {list(shape)} int64: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"({p_ms / k_ms:.1f}x)", flush=True)
    for name in ("ntt", "intt"):
        kernel_rows[name].update(max_abs_err=max_err[name],
                                 ms=times["flagship"][name][0],
                                 plain_ms=times["flagship"][name][1])


def reset_launches() -> None:
    from hectr_tpu_torch.ops import mulmod_cuda, ntt_cuda

    ntt_cuda.reset_launches()
    mulmod_cuda.reset_launches()


def read_launches() -> dict:
    from hectr_tpu_torch.ops import mulmod_cuda, ntt_cuda

    return {**ntt_cuda.LAUNCHES, **mulmod_cuda.LAUNCHES}


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
    kernel_rows["mulmod_chain"].update(launches=launches["mulmod_chain"],
                                       max_abs_err=err, ms=res["ms"],
                                       plain_ms=plain)


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

    t0 = time.perf_counter()
    sources = ("ntt.cu", "mulmod_chain.cu")
    libs = build.build(*sources)
    ntt_cuda.library()
    mulmod_cuda.library()
    print(f"[build] nvcc sm_90a hectr_tpu_torch/csrc/{{{','.join(sources)}}} "
          f"(in parallel) -> {[lib.name for lib in libs]} "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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
    phase_kernels(device, kernel_rows)

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

    x, u, dev, canary, launches_flag, flagship = run_loop(
        "flagship", FLAGSHIP, bsgs_rotations(FLAGSHIP.slots), device, card)
    check(bool((dev <= 2e-9).all()), f"flagship deviation {dev}")
    check(canary < 1e-5, f"flagship canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"flagship final state {x[-1]}")

    phase_ceiling(device, kernel_rows, card)
    launches_fused = phase_fused(device, flagship, card)
    del flagship
    launches_qp = phase_qp(device, card)

    loops = (("reference-hempc", launches_ref), ("flagship", launches_flag),
             ("fused", launches_fused), ("flagship-qp", launches_qp))
    for label, launches in loops:
        for kname in ("ntt", "intt"):
            check(launches[kname] > 0,
                  f"{kname} kernel never launched in the {label} loop")
    for kname in ("ntt", "intt"):
        kernel_rows[kname]["launches"] = sum(l[kname] for _, l in loops)
    print(json.dumps({"kernels": list(kernel_rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
