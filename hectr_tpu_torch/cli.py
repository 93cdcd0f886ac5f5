"""Command-line driver: the closed-loop CSTR subcommands of
``hectr_tpu.cli`` on PyTorch.

Usage:  python -m hectr_tpu_torch.cli {cstr-mpc,cstr-hempc}
        [--preset reference-hempc|flagship|...] [--steps 40] [--seed 0]
        [--device cuda] [--out-dir results]

``--device`` defaults to ``cuda`` and fails when CUDA is missing; pass
``--device cpu`` to run on the CPU on purpose.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import time

import numpy as np
import torch

from hectr_tpu_torch.config import PRESETS, resolve_device


def cstr_setup():
    """(model, plant): the linearised CSTR controller model and the
    nonlinear plant (reference tests/hectr.c:699-744)."""
    from hectr_tpu_torch.control.plants import (
        CSTR_STEADY_STATE, cstr_jacobian, cstr_linearize, cstr_ode)
    from hectr_tpu_torch.control.simulate import LinearModel, Plant

    ss = CSTR_STEADY_STATE
    A, B, _ = cstr_linearize(ss["xs"], ss["us"], ss["ps"], 1.0)
    model = LinearModel(
        A=A, B=B, C=np.eye(3), Bd=np.zeros((3, 2)),
        Cd=np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]]),
        Hr=np.array([[1.0, 0, 0], [0, 0, 1.0]]))
    plant = Plant(ode=cstr_ode, jacobian=cstr_jacobian,
                  xs=ss["xs"], us=ss["us"], ps=ss["ps"])
    return model, plant


def disturbance(steps: int) -> np.ndarray:
    """+10% inlet-flow step from k=9 (reference tests/hectr.c)."""
    p_seq = np.zeros((steps, 1))
    p_seq[min(9, steps):, 0] = 0.01
    return p_seq


def require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available on this machine; "
                         "pass --device cpu to run on the CPU")
    return resolve_device(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label: str, device: torch.device):
    """Print the wall time of a section that ends with the device idle."""
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    print(f"[{label}] {time.perf_counter() - t0:.3f} s")


def run_cstr_mpc(steps: int, device, horizon: int | None = None):
    """The plaintext closed loop: positional (x [steps+1, 3],
    u [steps, 2])."""
    from hectr_tpu_torch.control.simulate import simulate

    model, plant = cstr_setup()
    return simulate(model, plant, disturbance(steps), 1.0, steps, device,
                    horizon=horizon)


def hempc_keys(preset, seed: int, device, rotations=None):
    """(ctx, keys, rot_keys) for `preset`: keygen from seed, rotation
    keys (default: every amount, as he_genrk) from seed + 1."""
    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys

    ctx = make_context(preset)
    keys = S.keygen(ctx, S.TorchSampler(seed, device), device)
    rot_keys = gen_rotation_keys(ctx, keys, S.TorchSampler(seed + 1, device),
                                 rotations)
    return ctx, keys, rot_keys


def run_cstr_hempc(ctx, keys, rot_keys, steps: int, seed: int, device,
                   horizon: int | None = None):
    """The encrypted closed loop: positional (x, u) and the noise
    canary max |Im(decode)| over every step.  Encryption randomness
    comes from seed + 2."""
    from hectr_tpu_torch.ckks.scheme import TorchSampler
    from hectr_tpu_torch.control.simulate import simulate
    from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator

    model, plant = cstr_setup()
    horizon = steps // 10 if horizon is None else horizon
    reg = make_hempc_regulator(ctx, keys, rot_keys, model, plant, horizon)
    x, u, (_, canary) = simulate(
        model, plant, disturbance(steps), 1.0, steps, device, regulator=reg,
        regulator_state=hempc_init_state(TorchSampler(seed + 2, device),
                                         device),
        horizon=horizon, return_state=True)
    return x, u, float(canary)


def cmd_cstr_mpc(args, encrypted: bool) -> None:
    from hectr_tpu_torch.utils import write_traj_bin, write_traj_txt

    device = require_device(args.device)
    name = "cstr-hempc" if encrypted else "cstr-mpc"
    if encrypted:
        preset = PRESETS[args.preset]
        with timed("he_keypair + he_genrk", device):
            ctx, keys, rot_keys = hempc_keys(preset, args.seed, device)
        with timed("closed-loop simulate", device):
            x, u, canary = run_cstr_hempc(ctx, keys, rot_keys, args.steps,
                                          args.seed, device)
        # the reference asserts imag residue < 1e-5 on every decode
        # (src/ctr.c:493-494); the canary is the max across the loop
        if not canary < 1e-5:
            raise SystemExit(f"noise canary {canary:.3e} >= 1e-5")
        print(f"noise canary max|Im(decode)| = {canary:.3e}")
    else:
        with timed("closed-loop simulate", device):
            x, u = run_cstr_mpc(args.steps, device)
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_traj_txt(out_dir / f"{name}.txt", x, u)
    write_traj_bin(out_dir / f"{name}.bin", x, u)
    print(f"wrote {out_dir}/{name}.{{txt,bin}}; final state {x[-1].round(4)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="hectr-tpu-torch", description=__doc__)
    ap.add_argument("subcommand", choices=["cstr-mpc", "cstr-hempc"])
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--preset", default="reference-hempc",
                    choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cmd_cstr_mpc(args, encrypted=args.subcommand == "cstr-hempc")


if __name__ == "__main__":
    main()
