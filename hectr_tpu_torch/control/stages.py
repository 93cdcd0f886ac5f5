"""Controller stages: setup-time gain builders (NumPy) and per-step
update functions (float64 tensors -- these run inside the closed-loop
step loop of hectr_tpu_torch.control.simulate).

Capabilities of reference src/ctr.c:
  weighting_matrices -> `ctr_weighting_matrices` (src/ctr.c:50-60)
  estimator_gains    -> `ctr_estimator` (src/ctr.c:62-119)
  selector_matrix    -> `ctr_selector` (src/ctr.c:121-154)
  measure            -> `ctr_measure` (src/ctr.c:156-164)
  measure_forward    -> `ctr_measure_forward` (src/ctr.c:166-229)
  select_target      -> `ctr_select` (src/ctr.c:231-280)
  estimate_forward   -> `ctr_estimate` (src/ctr.c:294-332)
  actuate            -> `ctr_actuate` (src/ctr.c:334-354)

The per-step updates take one state vector [n] or a batch of them
[..., n] (independent loops): matrices apply to the last axis through
``utils.rows.matvec`` on the CPU, so each row of a batch equals its
unbatched update bit for bit there, and through elementwise products
and a sum on the card (``apply``), so the stages call no cuBLAS routine
there and sum in the order K13 (``ops.stages_cuda``) follows: they are
the card's plain counterpart of K13.

Deviation (documented): reference `ctr_measure` indexes x[i] instead of
x[j] (src/ctr.c:163), i.e. y_i = (sum_j C_ij) * x_i -- benign in all its
tests because C is identity.  `measure` here computes the correct
y = C @ x, which agrees with the reference whenever row-sums of C equal
its diagonal (true for C = I).
"""

from __future__ import annotations

import numpy as np
import torch

from hectr_tpu_torch.config import SMALL
from hectr_tpu_torch.control.ode import stiff_step
from hectr_tpu_torch.control.riccati import dlqe
from hectr_tpu_torch.utils.rows import matvec

# ---------------------------------------------------------------------------
# Setup-time builders (host NumPy float64)
# ---------------------------------------------------------------------------


def weighting_matrices(xs, us):
    """Q = diag(1/xs_i^2), R = diag(1/us_i^2)
    (reference ctr_weighting_matrices, src/ctr.c:50-60)."""
    xs = np.asarray(xs, dtype=np.float64)
    us = np.asarray(us, dtype=np.float64)
    return np.diag(1.0 / xs**2), np.diag(1.0 / us**2)


def estimator_gains(A, B, C, Bd, Cd, xs):
    """Kalman gains (Lx, Ld) for the disturbance-augmented model.

    Augmented system: Aaug = [[A, Bd], [0, I]], Caug = [C, Cd];
    Qw = diag(SMALL,...,SMALL, last=1), Rv = diag(SMALL * xs_i^2);
    L = dlqe(Aaug, Caug, Qw, Rv); Lx = L[:nx], Ld = L[nx:].

    Parity: reference ctr_estimator (src/ctr.c:62-119).  Pass Bd=None/
    Cd=None for the disturbance-free variant (returns Ld=None).
    """
    A = np.asarray(A, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    nx = A.shape[0]
    ny = C.shape[0]
    if Bd is None:
        na = nx
        Aaug, Caug = A, C
    else:
        Bd = np.asarray(Bd, dtype=np.float64)
        Cd = np.asarray(Cd, dtype=np.float64)
        nd = Bd.shape[1]
        na = nx + nd
        Aaug = np.zeros((na, na))
        Aaug[:nx, :nx] = A
        Aaug[:nx, nx:] = Bd
        Aaug[nx:, nx:] = np.eye(nd)
        Caug = np.hstack([C, Cd])
    Qw = np.eye(na) * SMALL
    Qw[-1, -1] = 1.0
    xs = np.asarray(xs, dtype=np.float64)
    Rv = np.diag(SMALL * xs[:ny] ** 2)
    L = dlqe(Aaug, Caug, Qw, Rv)
    if Bd is None:
        return L, None
    return L[:nx], L[nx:]


def selector_matrix(A, B, C, Hr):
    """Ginv = inv([[I - A, -B], [Hr C, 0]])
    (reference ctr_selector, src/ctr.c:121-154)."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    Hr = np.asarray(Hr, dtype=np.float64)
    nx = A.shape[0]
    nu = B.shape[1]
    G = np.zeros((nx + nu, nx + nu))
    G[:nx, :nx] = np.eye(nx) - A
    G[:nx, nx:] = -B
    G[nx:, :nx] = Hr @ C
    return np.linalg.inv(G)


# ---------------------------------------------------------------------------
# Per-step updates (float64 tensors on the loop's device)
# ---------------------------------------------------------------------------


def apply(M, x):
    """M [r, c] applied to the last axis of x [..., c] -> [..., r]: on the
    CPU ``utils.rows.matvec``; elsewhere the elementwise products summed
    over c, which calls no cuBLAS routine."""
    if x.device.type == "cpu":
        return matvec(M, x)
    return (M * x.unsqueeze(-2)).sum(-1)


def measure(C, x):
    """y = C x (reference ctr_measure, src/ctr.c:156-164; index bug
    fixed -- see module docstring)."""
    return apply(C, x)


def measure_forward(C, Cd, Lx, Ld, y, xhatm, dhatm):
    """Kalman measurement update.

    e = y - C xhatm - Cd dhatm; xhat = xhatm + Lx e; dhat = dhatm + Ld e.
    Parity: reference ctr_measure_forward (src/ctr.c:166-229); pass
    Cd/Ld/dhatm=None for the disturbance-free branch.
    """
    if Cd is None:
        e = y - apply(C, xhatm)
        return xhatm + apply(Lx, e), None
    e = y - apply(C, xhatm) - apply(Cd, dhatm)
    return xhatm + apply(Lx, e), dhatm + apply(Ld, e)


def select_target(Bd, Cd, Hr, Ginv, dhat, rsp):
    """Steady-state target (xr, ur) = Ginv @ [Bd dhat; rsp - Hr Cd dhat].

    Parity: reference ctr_select (src/ctr.c:231-280).
    """
    nx = Bd.shape[0] if Bd is not None else Ginv.shape[0] - rsp.shape[-1]
    if Bd is None:
        pack = torch.cat([torch.zeros((*rsp.shape[:-1], nx), dtype=rsp.dtype,
                                      device=rsp.device), rsp], dim=-1)
    else:
        pack = torch.cat([apply(Bd, dhat), rsp - apply(Hr, apply(Cd, dhat))],
                         dim=-1)
    r = apply(Ginv, pack)
    return r[..., :nx], r[..., nx:]


def lqr_control(G, xhat, xr, ur):
    """u = -G (xhat - xr) + ur (reference ctr_control, src/ctr.c:282-292;
    present but commented out of the reference loop at src/ctr.c:423)."""
    return apply(-G, xhat - xr) + ur


def estimate_forward(A, B, Bd, xhat, dhat, u):
    """Time update: xhatm' = A xhat + B u + Bd dhat; dhatm' = dhat.

    Parity: reference ctr_estimate (src/ctr.c:294-332).
    """
    xhatm = apply(A, xhat) + apply(B, u)
    if Bd is None:
        return xhatm, None
    return xhatm + apply(Bd, dhat), dhat


def actuate(ode, jacobian, x, u, p, xs, us, ps, dt):
    """Integrate the true nonlinear plant one controller interval.

    Deviation variables in/out; internally positional.  Two
    linearly-implicit stiff substeps at dt/2 (reference ctr_actuate,
    src/ctr.c:334-354, substep count (int)(dt/(dt/2)) = 2).
    """
    xx = x + xs
    uu = u + us
    pp = p + ps
    ddt = dt / 2
    for _ in range(2):
        xx = stiff_step(ode, jacobian, xx, uu, pp, ddt)
    return xx - xs
