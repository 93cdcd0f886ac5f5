"""Closed-loop simulation: estimator -> target selector -> regulator ->
plant, one step at a time on float64 tensors.

Capability of reference src/ctr.c `ctr_simulate` (src/ctr.c:363-443)
and `hectr_simulate` (src/ctr.c:500-618), as
``hectr_tpu/control/simulate.py``, whose `lax.scan` becomes a Python
step loop with the state kept on the device.  The regulator is a
pluggable function: the encrypted regulator (hectr_tpu_torch.hempc)
runs in this same loop, which is what makes the plaintext-vs-encrypted
comparison a like-for-like one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from hectr_tpu_torch.config import resolve_device
from hectr_tpu_torch.control.mpc import mpc_gains
from hectr_tpu_torch.control.riccati import dlqr
from hectr_tpu_torch.control.stages import (
    actuate,
    estimate_forward,
    estimator_gains,
    lqr_control,
    measure,
    measure_forward,
    select_target,
    selector_matrix,
    weighting_matrices,
)


@dataclasses.dataclass(frozen=True)
class LinearModel:
    """Discrete-time linear controller model + disturbance model +
    setpoint selector (reference ctr_simulate signature,
    src/hectr.h:109-126).  Host numpy float64."""

    A: np.ndarray    # [nx, nx]
    B: np.ndarray    # [nx, nu]
    C: np.ndarray    # [ny, nx]
    Bd: np.ndarray   # [nx, nd]
    Cd: np.ndarray   # [ny, nd]
    Hr: np.ndarray   # [nu, ny]


@dataclasses.dataclass(frozen=True)
class Plant:
    """Nonlinear plant callbacks on tensors + steady-state offsets."""

    ode: Callable        # (x, u, p) -> xdot
    jacobian: Callable   # (x, u, p) -> d(xdot)/dx
    xs: np.ndarray
    us: np.ndarray
    ps: np.ndarray


# A regulator maps (state, xhat, uhat, xr, ur) -> (u, state); `state`
# threads through the loop (the encrypted regulator's sampler and noise
# canary); the plaintext regulator is stateless (state=None).
Regulator = Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor], tuple[torch.Tensor, Any]]


def make_mpc_regulator(model: LinearModel, plant: Plant, horizon: int,
                       device) -> Regulator:
    """The plaintext unconstrained-MPC regulator with precomputed gains:
    u = uhat + du[0:nu], du = -(K_A (xhat-xr) + K_B (uhat-ur))."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    K_A, K_B = mpc_gains(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
    # only the first input block is applied
    K_A = torch.as_tensor(K_A[:nu], dtype=torch.float64, device=device)
    K_B = torch.as_tensor(K_B[:nu], dtype=torch.float64, device=device)

    def regulator(state, xhat, uhat, xr, ur):
        du = -(K_A @ (xhat - xr) + K_B @ (uhat - ur))
        return uhat + du, state

    return regulator


def make_lqr_regulator(model: LinearModel, plant: Plant, device) -> Regulator:
    """LQR regulator plug-in: u = -G (xhat - xr) + ur with the DLQR gain
    (reference ctr_control, src/ctr.c:282-292 -- commented out of the
    reference loop at src/ctr.c:423; its golden artifacts
    cstr-lqr.{txt,bin} are reproduced by this plug-in)."""
    Q, R = weighting_matrices(plant.xs, plant.us)
    G, _ = dlqr(model.A, model.B, Q, R)
    G = torch.as_tensor(G, dtype=torch.float64, device=device)

    def regulator(state, xhat, uhat, xr, ur):
        return lqr_control(G, xhat, xr, ur), state

    return regulator


def simulate(
    model: LinearModel,
    plant: Plant,
    p_seq: np.ndarray,
    dt: float,
    N: int,
    device,
    regulator: Regulator | None = None,
    regulator_state: Any = None,
    horizon: int | None = None,
    rsp: np.ndarray | None = None,
    return_state: bool = False,
):
    """Run the closed loop N steps on `device`; returns positional numpy
    (x [N+1, nx], u [N, nu]), plus the final regulator state if
    `return_state`.

    Per step (reference ctr_simulate / hectr_simulate): measure ->
    Kalman measurement update -> target selector -> regulator (uhat =
    previous u; at k=0, uhat = ur) -> actuate the nonlinear plant ->
    Kalman time update.  horizon defaults to N // 10; x0 = xhatm0 =
    dhatm0 = 0 in deviation variables.
    """
    device = resolve_device(device)
    horizon = N // 10 if horizon is None else horizon
    if regulator is None:
        regulator = make_mpc_regulator(model, plant, horizon, device)

    nx = np.shape(model.C)[1]
    nu = np.shape(model.B)[1]
    Lx, Ld = estimator_gains(model.A, model.B, model.C, model.Bd, model.Cd,
                             plant.xs)
    Ginv = selector_matrix(model.A, model.B, model.C, model.Hr)

    def f64(m):
        return torch.as_tensor(np.asarray(m, dtype=np.float64), device=device)

    A, B, C, Bd, Cd, Hr = (f64(m) for m in (model.A, model.B, model.C,
                                            model.Bd, model.Cd, model.Hr))
    Lx, Ld, Ginv = f64(Lx), f64(Ld), f64(Ginv)
    xs, us, ps = f64(plant.xs), f64(plant.us), f64(plant.ps)
    rsp_v = torch.zeros(nu, dtype=torch.float64, device=device) \
        if rsp is None else f64(rsp)
    p_seq = f64(p_seq).reshape(N, -1)

    x = torch.zeros(nx, dtype=torch.float64, device=device)
    xhatm = torch.zeros(nx, dtype=torch.float64, device=device)
    dhatm = torch.zeros(model.Bd.shape[1], dtype=torch.float64, device=device)
    u = torch.zeros(nu, dtype=torch.float64, device=device)
    reg_state = regulator_state
    x_traj, u_traj = [], []
    for k in range(N):
        y = measure(C, x)
        xhat, dhat = measure_forward(C, Cd, Lx, Ld, y, xhatm, dhatm)
        xr, ur = select_target(Bd, Cd, Hr, Ginv, dhat, rsp_v)
        uhat = ur if k == 0 else u
        u, reg_state = regulator(reg_state, xhat, uhat, xr, ur)
        x_traj.append(x)
        u_traj.append(u)
        x = actuate(plant.ode, plant.jacobian, x, u, p_seq[k], xs, us, ps, dt)
        xhatm, dhatm = estimate_forward(A, B, Bd, xhat, dhat, u)
    x_traj.append(x)

    x_all = (torch.stack(x_traj) + xs).cpu().numpy()
    u_all = (torch.stack(u_traj) + us).cpu().numpy()
    if return_state:
        return x_all, u_all, reg_state
    return x_all, u_all
