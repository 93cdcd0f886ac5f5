"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  0. require CUDA; print the card's name and power limit
  1. build the CUDA NTT kernels from hectr_tpu_torch/csrc (timed)
  2. kernel vs plain PyTorch, bit for bit, over real prime chains
     (logN 8/12/15, L 1/5/24/34, batch ()/(2,)/(11,)), and their times
     at the shapes the encrypted loop gives them
  3. the REFERENCE_HEMPC encrypted CSTR loop (40 steps, every rotation
     key) through the CLI's functions: <= 5e-10 per channel against the
     plaintext twin, canary < 1e-5, golden cstr-hempc.bin to 1e-6
  4. the FLAGSHIP loop (logN=15, 24-prime chain, BSGS rotation keys,
     horizon 4): <= 2e-9 per channel, canary < 1e-5, final state
  5. both kernels launched in phases 3 and 4; the kernel summary, the
     card, and as the last line {"ok": true, "device": {...}}
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


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_residues(primes, batch, n, gen, device):
    """Uniform residues [*batch, L, n] with 0 and p-1 planted per row."""
    rows = [torch.randint(0, p, (*batch, n), generator=gen, device=device)
            for p in primes]
    a = torch.stack(rows, dim=-2)
    a[..., 0] = 0
    a[..., 1] = torch.tensor(primes, device=device) - 1
    return a


def phase_kernels(device, ntt_cuda, kernel_rows):
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


def run_loop(label, preset, rotations, device, ntt_cuda, card):
    from hectr_tpu_torch import cli

    t0 = time.perf_counter()
    ctx, keys, rot_keys = cli.hempc_keys(preset, 0, device, rotations)
    x_pt, u_pt = cli.run_cstr_mpc(40, device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    ntt_cuda.reset_launches()
    t0 = time.perf_counter()
    x, u, canary = cli.run_cstr_hempc(ctx, keys, rot_keys, 40, 0, device)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    launches = dict(ntt_cuda.LAUNCHES)

    check(x.shape == (41, 3) and u.shape == (40, 2), f"{label}: shapes")
    check(bool(np.isfinite(x).all() and np.isfinite(u).all()),
          f"{label}: non-finite trajectory")
    dev = np.concatenate([np.max(np.abs(x - x_pt), axis=0),
                          np.max(np.abs(u - u_pt), axis=0)])
    print(f"[{label}] keygen + {len(rot_keys)} rotation keys + plaintext "
          f"twin {t_setup:.2f} s; 40-step encrypted loop {t_loop:.3f} s = "
          f"{40 / t_loop:.2f} steps/s on {card}", flush=True)
    print(f"[{label}] max |encrypted - plaintext| per channel (c, T, h, Tc, "
          f"F) = {dev.tolist()}; canary {canary:.3e}; final state "
          f"{x[-1].tolist()}; launches {launches}", flush=True)
    return x, u, dev, canary, launches


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
    from hectr_tpu_torch.ops import ntt_cuda
    from hectr_tpu_torch.utils import read_traj_bin

    t0 = time.perf_counter()
    lib = ntt_cuda.library()
    print(f"[build] nvcc sm_90a hectr_tpu_torch/csrc/ntt.cu -> {lib._name} "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kernel_rows = {
        "ntt": {"name": "ntt_fwd", "route": "cuda",
                "source": "hectr_tpu_torch/csrc/ntt.cu",
                "replaces": "hectr_tpu/ops/ntt_pallas.py:272"},
        "intt": {"name": "ntt_inv", "route": "cuda",
                 "source": "hectr_tpu_torch/csrc/ntt.cu",
                 "replaces": "hectr_tpu/ops/ntt_pallas.py:315"},
    }
    phase_kernels(device, ntt_cuda, kernel_rows)

    x, u, dev, canary, launches_ref = run_loop(
        "reference-hempc", REFERENCE_HEMPC, None, device, ntt_cuda, card)
    check(bool((dev <= 5e-10).all()), f"reference deviation {dev}")
    check(canary < 1e-5, f"reference canary {canary}")
    golden_x, golden_u = read_traj_bin(ROOT / "tests/golden/cstr-hempc.bin")
    golden = np.hstack([golden_x, golden_u])
    ours = np.hstack([x, np.vstack([u, u[-1:]])])
    rel = np.max(np.abs(ours - golden), axis=0) / np.max(np.abs(golden), axis=0)
    print(f"[reference-hempc] golden cstr-hempc.bin max relative error per "
          f"channel {rel.tolist()}", flush=True)
    check(bool((rel < 1e-6).all()), f"golden mismatch {rel}")

    x, u, dev, canary, launches_flag = run_loop(
        "flagship", FLAGSHIP, bsgs_rotations(FLAGSHIP.slots), device,
        ntt_cuda, card)
    check(bool((dev <= 2e-9).all()), f"flagship deviation {dev}")
    check(canary < 1e-5, f"flagship canary {canary}")
    check(bool(np.allclose(x[-1], FLAGSHIP_FINAL_STATE, rtol=1e-4, atol=0)),
          f"flagship final state {x[-1]}")

    for label, launches in (("reference-hempc", launches_ref),
                            ("flagship", launches_flag)):
        for kname in ("ntt", "intt"):
            check(launches[kname] > 0,
                  f"{kname} kernel never launched in the {label} loop")
    for kname in ("ntt", "intt"):
        kernel_rows[kname]["launches"] = (launches_ref[kname]
                                          + launches_flag[kname])
    print(json.dumps({"kernels": [kernel_rows["ntt"], kernel_rows["intt"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
