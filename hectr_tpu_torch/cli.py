"""Command-line interface: the reference `test-hectr` surface of
``hectr_tpu.cli`` on PyTorch.

Usage:  python -m hectr_tpu_torch.cli <subcommand> [--out-dir results]
        [--preset reference-hempc|flagship|...] [--steps 40] [--seed 0]
        [--device cuda] [--plot] [--logn 12] [--depth 1]

Subcommands: cstr-mpc, cstr-hempc and cstr-lqr (closed loops on
``--device``, which defaults to ``cuda`` and fails when CUDA is missing;
pass ``--device cpu`` to run on the CPU on purpose), scaling (the
coefficient-sharded NTT against the single-device one at ``--logn`` and
2 + 2 x ``--depth`` limbs, one JSON line; over the ranks of
HECTR_COORDINATOR / HECTR_NUM_PROCS / HECTR_PROC_ID when set, else over a
local mesh on ``--device``), and the host-only quadprog, cstr-ode,
cstr-cmp, mpc-tracking, inverted-pendulum-mpc-control and security, which
need no device.  ``--plot`` writes a PDF beside the trajectory of each
closed loop.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed

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


def _write_traj(args, name: str, x, u) -> None:
    from hectr_tpu_torch.utils import write_traj_bin, write_traj_txt

    out_dir = pathlib.Path(args.out_dir)
    write_traj_txt(out_dir / f"{name}.txt", x, u)
    write_traj_bin(out_dir / f"{name}.bin", x, u)
    print(f"wrote {out_dir}/{name}.{{txt,bin}}; final state {x[-1].round(4)}")
    if args.plot:
        from hectr_tpu_torch.utils.plotting import plot_closed_loop

        plot_closed_loop(x, u, out_dir / f"{name}.pdf", title=name)


def cmd_cstr_mpc(args, encrypted: bool) -> None:
    from hectr_tpu_torch.utils import timed

    device = require_device(args.device)
    name = "cstr-hempc" if encrypted else "cstr-mpc"
    if encrypted:
        preset = PRESETS[args.preset]
        with timed("he_keypair + he_genrk"):
            ctx, keys, rot_keys = hempc_keys(preset, args.seed, device)
        with timed("closed-loop simulate"):
            x, u, canary = run_cstr_hempc(ctx, keys, rot_keys, args.steps,
                                          args.seed, device)
        # the reference asserts imag residue < 1e-5 on every decode
        # (src/ctr.c:493-494); the canary is the max across the loop
        if not canary < 1e-5:
            raise SystemExit(f"noise canary {canary:.3e} >= 1e-5")
        print(f"noise canary max|Im(decode)| = {canary:.3e}")
    else:
        with timed("closed-loop simulate"):
            x, u = run_cstr_mpc(args.steps, device)
    _write_traj(args, name, x, u)


def cmd_cstr_lqr(args) -> None:
    from hectr_tpu_torch.control.simulate import make_lqr_regulator, simulate
    from hectr_tpu_torch.utils import timed

    device = require_device(args.device)
    model, plant = cstr_setup()
    reg = make_lqr_regulator(model, plant, device)
    with timed("closed-loop simulate (lqr)"):
        x, u = simulate(model, plant, disturbance(args.steps), 1.0,
                        args.steps, device, regulator=reg)
    _write_traj(args, "cstr-lqr", x, u)


def cmd_cstr_ode(args) -> None:
    """RK4 vs linearly-implicit stiff steps of the open-loop CSTR from
    steady state, 5 steps of 1 min (cstr-ode.txt)."""
    from hectr_tpu_torch.control.ode import rk4_step, stiff_step
    from hectr_tpu_torch.control.plants import (
        CSTR_STEADY_STATE, cstr_jacobian, cstr_ode)

    def f64(v):
        return torch.tensor(v, dtype=torch.float64)

    u = f64([290.0, 0.1])
    p = f64([0.1])
    x45 = f64(CSTR_STEADY_STATE["xs"])
    x15 = x45.clone()
    rows = [[0.0, *x45[:2].tolist(), *x15[:2].tolist()]]
    for i in range(1, 6):
        x45 = rk4_step(cstr_ode, x45, u, p, 1.0)
        x15 = stiff_step(cstr_ode, cstr_jacobian, x15, u, p, 1.0)
        rows.append([float(i), *x45[:2].tolist(), *x15[:2].tolist()])
    out = pathlib.Path(args.out_dir) / "cstr-ode.txt"
    np.savetxt(out, np.array(rows), fmt="%9.6f")
    print(f"wrote {out}")


def cmd_cstr_cmp(args) -> None:
    from hectr_tpu_torch.utils import traj_compare

    out_dir = pathlib.Path(args.out_dir)
    diff = traj_compare(out_dir / "cstr-mpc.bin", out_dir / "cstr-hempc.bin",
                        out_dir / "cstr-cmp.bin")
    print("max |plaintext - encrypted| per channel:", diff.max(axis=0))


def cmd_mpc_tracking(args) -> None:
    """The reference's 2-state tracking demos, cases 5-12
    (mpc-tracking-<case>.txt)."""
    from hectr_tpu_torch.control.mpc import MPCBounds, ctr_mpc

    A = np.array([[0.8, 1.0], [0.0, 0.9]])
    B = np.array([[-1.0], [2.0]])
    x0 = np.array([0.0, -1.0])
    u0 = np.array([-0.1])
    r1 = np.array([1.0, 0.25])
    cases = {
        5: (r1, MPCBounds()),
        6: (r1, MPCBounds(dumin=[-0.5], dumax=[0.5])),
        7: (r1, MPCBounds(dumin=[-0.3], dumax=[0.2])),
        8: (np.zeros(2), MPCBounds(dumin=[-0.3], dumax=[0.2])),
        9: (np.zeros(2), MPCBounds(umin=[-0.3], umax=[0.1])),
        11: (np.zeros(2), MPCBounds(xmin=[-1.5, -2.5], xmax=[0.5, 0.2])),
        12: (np.zeros(2), MPCBounds(dumin=[-0.5], dumax=[0.5],
                                    xmin=[-1.5, -2.5], xmax=[0.5, 0.2])),
    }
    out_dir = pathlib.Path(args.out_dir)
    for case, (rsp, bounds) in cases.items():
        u = ctr_mpc(2, 2, 1, 30, A, B, np.eye(2), np.eye(2), np.eye(1),
                    xhat=x0, uhat=u0, xr=rsp, ur=np.zeros(1), bounds=bounds)
        y = [x0]
        for k in range(30):
            y.append(A @ y[-1] + B @ u[k])
        y = np.array(y)
        path = out_dir / f"mpc-tracking-{case}.txt"
        with open(path, "w") as f:
            for k in range(31):
                f.write(f"{k:2d} {u[min(k, 29), 0]:12.8f} {y[k, 0]:12.8f} "
                        f"{y[k, 1]:12.8f}\n")
        print(f"wrote {path}")


def cmd_pendulum(args) -> None:
    """Inverted pendulum on a cart, MPC from a 0.3 rad tilt
    (inverted-pendulum-mpc-control.txt)."""
    from hectr_tpu_torch.control.linalg import c2d
    from hectr_tpu_torch.control.mpc import ctr_mpc

    l_bar, mcar, mball, g = 2.0, 1.0, 0.3, 9.8
    Ac = np.array([[0, 1, 0, 0], [0, 0, mball * g / mcar, 0],
                   [0, 0, 0, 1], [0, 0, g * (mcar + mball) / (l_bar * mcar), 0]])
    Bc = np.array([[0.0], [1 / mcar], [0.0], [1 / (l_bar * mcar)]])
    Ad, Bint = c2d(Ac, 0.1)
    Bd = Bint @ Bc
    C = np.array([[0, 1, 0, 0], [0, 0, 1, 0]], dtype=float)
    x0 = np.array([0, 0, 0.3, 0.0])
    u = ctr_mpc(2, 4, 1, 30, Ad, Bd, C, np.eye(2), np.array([[0.01]]),
                xhat=x0, uhat=np.zeros(1), xr=np.zeros(4), ur=np.zeros(1))
    x = [x0]
    for k in range(30):
        x.append(Ad @ x[-1] + Bd.ravel() * u[k, 0])
    out = pathlib.Path(args.out_dir) / "inverted-pendulum-mpc-control.txt"
    with open(out, "w") as f:
        for k in range(31):
            f.write(f"{k:2d} {u[min(k, 29), 0]:12.8f} "
                    + " ".join(f"{v:12.8f}" for v in x[k]) + "\n")
    print(f"wrote {out}")


QP_ORACLE = pathlib.Path(__file__).resolve().parent.parent / "tests" / \
    "test_torch_qp_oracle.py"


def cmd_quadprog(args) -> None:
    """Run the QP oracle suite (the port's active-set solver against
    scipy on the reference's published problems) and print its
    summary line.  --noconftest keeps the JAX package's test
    configuration out, so the suite needs no jax."""
    del args
    r = subprocess.run(
        [sys.executable, "-m", "pytest", str(QP_ORACLE), "-q", "--noconftest",
         "-o", "addopts=", "-p", "no:cacheprovider"],
        capture_output=True, text=True, cwd=QP_ORACLE.parent.parent)
    print(r.stdout.strip().splitlines()[-1])
    if r.returncode != 0:
        raise SystemExit(r.returncode)


def cmd_scaling(args) -> None:
    """NTT scaling-efficiency report, one JSON line.  After
    ``init_distributed`` (one process per rank, a power of two of them)
    the mesh spans the ranks; a single process measures a local mesh of
    as few shards (at least 2) as keep a chunk within one kernel row."""
    from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.multihost import (
        init_distributed, make_pod_mesh, ntt_scaling_efficiency)

    # under NCCL it picks this rank's card
    distributed = init_distributed(device=args.device)
    device = require_device(args.device)
    if distributed:
        mesh = make_pod_mesh(device=device).coeff
    else:
        mesh = LocalMesh(max(2, 1 << max(0, args.logn - MAX_LOGN)))
    rep = ntt_scaling_efficiency(args.logn, args.depth * 2 + 2, mesh, device)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in rep.items()}))
    if distributed:
        torch.distributed.destroy_process_group()


def cmd_security(args) -> None:
    """Security accounting for every registered CKKS preset (HE
    standard table)."""
    del args
    from hectr_tpu_torch.ckks.security import security_report

    for preset in PRESETS.values():
        print(security_report(preset))


COMMANDS = {
    "quadprog": cmd_quadprog,
    "cstr-ode": cmd_cstr_ode,
    "mpc-tracking": cmd_mpc_tracking,
    "inverted-pendulum-mpc-control": cmd_pendulum,
    "cstr-mpc": lambda a: cmd_cstr_mpc(a, encrypted=False),
    "cstr-hempc": lambda a: cmd_cstr_mpc(a, encrypted=True),
    "cstr-cmp": cmd_cstr_cmp,
    "cstr-lqr": cmd_cstr_lqr,
    "scaling": cmd_scaling,
    "security": cmd_security,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="hectr-tpu-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("subcommand", choices=list(COMMANDS))
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--preset", default="reference-hempc",
                    choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--logn", type=int, default=12,
                    help="ring size of the scaling report")
    ap.add_argument("--depth", type=int, default=1,
                    help="levels of the scaling report's chain")
    args = ap.parse_args(argv)
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    COMMANDS[args.subcommand](args)


if __name__ == "__main__":
    main()
