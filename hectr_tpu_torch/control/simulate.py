"""Closed-loop simulation: estimator -> target selector -> regulator ->
plant, one step at a time on float64 tensors.

Capability of reference src/ctr.c `ctr_simulate` (src/ctr.c:363-443)
and `hectr_simulate` (src/ctr.c:500-618), as
``hectr_tpu/control/simulate.py``, whose `lax.scan` becomes a Python
step loop with the state kept on the device.  The regulator is a
pluggable function: the encrypted regulator (hectr_tpu_torch.hempc)
runs in this same loop, which is what makes the plaintext-vs-encrypted
comparison a like-for-like one.  ``simulate_batch`` runs B independent
loops, each with its own disturbance, through the same step with every
state batched [B, n] and one regulator call per step for all of them
(the JAX package vmaps a whole loop step instead,
``__graft_entry__.py`` ``one_loop_step``).

On a CUDA device the loop's own stages of a step (the plant, the time
update, the next step's measurement update and selector) for the CSTR
plant (``plants.cstr``'s right-hand side and Jacobian) take one launch
of the hand-written kernel K13 (``StageKernel``, ``ops.stages_cuda``),
so a step costs the host the regulator's call and that launch; K13's
constants stay on the device across episodes while the model, plant, dt
and device stay the same.  Any other plant, and every plant off the
card, runs the plain stages (``Stages``), their constants built for the
call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from hectr_tpu_torch.config import resolve_device
from hectr_tpu_torch.control.mpc import mpc_gains
from hectr_tpu_torch.control.plants.cstr import (cstr_jacobian, cstr_ode,
                                                 cstr_scalars)
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
from hectr_tpu_torch.ops import stages_cuda
from hectr_tpu_torch.utils.pmu import count, span
from hectr_tpu_torch.utils.rows import matvec


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
    u = uhat + du[0:nu], du = -(K_A (xhat-xr) + K_B (uhat-ur)), on one
    loop's vectors or a batch of them."""
    ny, nx = np.shape(model.C)
    nu = np.shape(model.B)[1]
    Q, R = weighting_matrices(plant.xs, plant.us)
    K_A, K_B = mpc_gains(ny, nx, nu, horizon, model.A, model.B, model.C, Q, R)
    # only the first input block is applied
    K_A = torch.as_tensor(K_A[:nu], dtype=torch.float64, device=device)
    K_B = torch.as_tensor(K_B[:nu], dtype=torch.float64, device=device)

    def regulator(state, xhat, uhat, xr, ur):
        du = -(matvec(K_A, xhat - xr) + matvec(K_B, uhat - ur))
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
    p_seq = np.asarray(p_seq, dtype=np.float64).reshape(N, -1)
    x, u, state = _closed_loop(model, plant, p_seq, dt, N, device, regulator,
                               regulator_state, horizon, rsp)
    if return_state:
        return x, u, state
    return x, u


def simulate_batch(
    model: LinearModel,
    plant: Plant,
    p_seqs: np.ndarray,
    dt: float,
    N: int,
    device,
    regulator: Regulator | None = None,
    regulator_state: Any = None,
    horizon: int | None = None,
):
    """B independent closed loops, loop b driven by its own disturbance
    p_seqs[b] ([B, N, np]), stepped together: every state is [B, n] and
    the regulator is called once per step with the whole batch (so an
    encrypted regulator encrypts, switches keys and decrypts B loops per
    call).  Returns positional numpy (x [B, N+1, nx], u [B, N, nu]) and
    the final regulator state.  Each loop is `simulate`'s loop on its own
    disturbance; on the CPU the plant, estimator and selector rows are
    bit-equal to it."""
    p_seqs = np.asarray(p_seqs, dtype=np.float64)
    B = p_seqs.shape[0]
    return _closed_loop(model, plant, p_seqs.reshape(B, N, -1), dt, N, device,
                        regulator, regulator_state, horizon, None)


def _f64(m, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, dtype=np.float64), device=device)


class Stages:
    """The loop's own stages on one device (everything of a step but the
    regulator), with the constants they read: the model's matrices, the
    estimator's and the target selector's gains and the plant's steady
    state, uploaded once."""

    def __init__(self, model: LinearModel, plant: Plant, dt: float, device):
        Lx, Ld = estimator_gains(model.A, model.B, model.C, model.Bd,
                                 model.Cd, plant.xs)
        Ginv = selector_matrix(model.A, model.B, model.C, model.Hr)
        self.A, self.B, self.C, self.Bd, self.Cd, self.Hr = (
            _f64(m, device) for m in (model.A, model.B, model.C, model.Bd,
                                      model.Cd, model.Hr))
        self.Lx, self.Ld, self.Ginv = (_f64(m, device) for m in (Lx, Ld, Ginv))
        self.xs, self.us, self.ps = (_f64(v, device)
                                     for v in (plant.xs, plant.us, plant.ps))
        self.plant, self.dt = plant, dt

    def observe(self, x, xhatm, dhatm, rsp, k):
        """Step k's measurement update and target selector: (xhat, dhat,
        xr, ur)."""
        with span("loop.measure_update", k):
            y = measure(self.C, x)
            xhat, dhat = measure_forward(self.C, self.Cd, self.Lx, self.Ld, y,
                                         xhatm, dhatm)
        with span("loop.selector", k):
            xr, ur = select_target(self.Bd, self.Cd, self.Hr, self.Ginv, dhat,
                                   rsp)
        return xhat, dhat, xr, ur

    def step(self, x, u, p, xhat, dhat, rsp, k, then_observe):
        """Step k's plant and time update under the move u and the
        disturbance row p, then (with `then_observe`) step k + 1's
        measurement update and selector: (x, xhat, dhat, xr, ur) of step
        k + 1, the last four None without `then_observe`."""
        with span("loop.plant", k):
            x = actuate(self.plant.ode, self.plant.jacobian, x, u, p, self.xs,
                        self.us, self.ps, self.dt)
        with span("loop.time_update", k):
            xhatm, dhatm = estimate_forward(self.A, self.B, self.Bd, xhat,
                                            dhat, u)
        if not then_observe:
            return x, None, None, None, None
        return (x, *self.observe(x, xhatm, dhatm, rsp, k + 1))


def _values(model: LinearModel, plant: Plant, dt: float, device) -> tuple:
    """What the stages' constants are computed from, by value (the
    arrays' bytes; the plant's functions by identity, held)."""
    arrays = (model.A, model.B, model.C, model.Bd, model.Cd, model.Hr,
              plant.xs, plant.us, plant.ps)
    return (device, float(dt), plant.ode, plant.jacobian,
            *((np.shape(a), np.asarray(a, dtype=np.float64).tobytes())
              for a in arrays))


class StageKernel:
    """``Stages.step`` and ``Stages.observe`` for the CSTR plant on a CUDA
    device, each one launch of K13 (``ops.stages_cuda.loop_stages``),
    which reads its inputs where they lie and hands out views of one new
    output a call.

    ``stages`` gives the constants for a model, plant, dt and device, and
    packs them into K13's buffer, both kept while those values stay the
    same.  ``pmu.COUNTS`` counts ``loop.kernel`` (a step) and
    ``loop.observe`` (an episode's first measurement update and
    selector)."""

    def __init__(self):
        self.values = self.constants = self.packed = None

    def stages(self, model: LinearModel, plant: Plant, dt: float,
               device) -> Stages:
        values = _values(model, plant, dt, device)
        if values != self.values:
            self.constants = Stages(model, plant, dt, device)
            self.packed = stages_cuda.pack(self.constants, cstr_scalars())
            self.values = values
        return self.constants

    def observe(self, x, xhatm, dhatm, rsp, k):
        count("loop.observe")
        with span("loop.stages.kernel", k):
            return stages_cuda.loop_stages(self.packed, x, None, None, xhatm,
                                           dhatm, rsp, stages_cuda.OBSERVE)[1:]

    def step(self, x, u, p, xhat, dhat, rsp, k, then_observe):
        count("loop.kernel")
        with span("loop.stages.kernel", k):
            if not then_observe:
                x = stages_cuda.loop_stages(self.packed, x, u, p, xhat, dhat,
                                            rsp, stages_cuda.STEP)[0]
                return x, None, None, None, None
            return stages_cuda.loop_stages(self.packed, x, u, p, xhat, dhat,
                                           rsp, stages_cuda.STEP_OBSERVE)


# the CSTR loop's stages on a CUDA device
_KERNEL = StageKernel()


def _runner(plant: Plant, device):
    """What runs the loop's stages on `device` in one launch a step: K13
    (``_KERNEL``) on a CUDA device for the CSTR plant, whose right-hand
    side and Jacobian K13 computes itself (``plant.ode`` and
    ``plant.jacobian`` are ``plants.cstr``'s, by identity); None for any
    other plant or device, where the stages run uncaptured."""
    if (device.type == "cuda" and plant.ode is cstr_ode
            and plant.jacobian is cstr_jacobian):
        return _KERNEL
    return None


def _closed_loop(model, plant, p_seq, dt, N, device, regulator,
                 regulator_state, horizon, rsp):
    """The step loop of `simulate` over states [*lead, n], with p_seq
    [*lead, N, np].  On a CUDA device the stages of every step of the
    CSTR plant take one launch of K13 (``StageKernel``), its constants
    kept on the device between episodes; any other plant, and any plant
    elsewhere, runs them uncaptured, their constants built for the
    call."""
    device = resolve_device(device)
    horizon = N // 10 if horizon is None else horizon
    if regulator is None:
        regulator = make_mpc_regulator(model, plant, horizon, device)

    nx = np.shape(model.C)[1]
    nu = np.shape(model.B)[1]
    lead = p_seq.shape[:-2]
    with span("loop.episode_start"):
        runner = _runner(plant, device)
        if runner is None:
            stages = runner = Stages(model, plant, dt, device)
        else:
            stages = runner.stages(model, plant, dt, device)
        rsp_v = torch.zeros((*lead, nu), dtype=torch.float64, device=device) \
            if rsp is None else _f64(rsp, device)
        p_seq = _f64(p_seq, device)

        x = torch.zeros((*lead, nx), dtype=torch.float64, device=device)
        xhatm = torch.zeros((*lead, nx), dtype=torch.float64, device=device)
        dhatm = torch.zeros((*lead, model.Bd.shape[1]), dtype=torch.float64,
                            device=device)
    reg_state = regulator_state
    x_traj, u_traj = [], []
    xhat, dhat, xr, ur = runner.observe(x, xhatm, dhatm, rsp_v, 0)
    for k in range(N):
        uhat = ur if k == 0 else u
        with span("loop.regulator", k):
            u, reg_state = regulator(reg_state, xhat, uhat, xr, ur)
        x_traj.append(x)
        u_traj.append(u)
        x, xhat, dhat, xr, ur = runner.step(x, u, p_seq[..., k, :], xhat,
                                            dhat, rsp_v, k, k + 1 < N)
    x_traj.append(x)

    with span("loop.trajectories"):
        x_all = (torch.stack(x_traj, dim=-2) + stages.xs).cpu().numpy()
        u_all = (torch.stack(u_traj, dim=-2) + stages.us).cpu().numpy()
    return x_all, u_all, reg_state
