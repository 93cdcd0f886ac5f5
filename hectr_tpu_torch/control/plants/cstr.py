"""Henson & Seborg continuously-stirred tank reactor (CSTR).

Capability of reference src/cstr.c, as
``hectr_tpu/control/plants/cstr.py``: 3 states (concentration c,
temperature T, level h), 2 controls (coolant temperature Tc, outlet
flow F), 1 parameter (inlet flow F0).  The ODE and Jacobian run per
step on float64 tensors, a state [3] or a batch of states [..., 3];
linearisation is setup-time NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hectr_tpu_torch.control.linalg import c2d

# Physical constants (reference src/cstr.c:26-38)
RHO = 1000.0        # density of A-B mixture (kg/m^3)
CP = 0.239          # heat capacity (kJ/kg K)
DELTA_H = -5e4      # heat of reaction A->B (kJ/mol)
E_OVER_R = 8750.0   # activation energy / gas constant (K)
K0 = 7.2e10         # Arrhenius pre-exponential factor (1/min)
U_HT = 54.94        # overall heat-transfer coefficient
C0 = 1.0            # feed concentration (kmol/m^3)
T0 = 350.0          # feed temperature (K)
RADIUS = 0.219      # container radius (m)

# Steady state (reference tests/hectr.c:523-528): xs=(cs,Ts,hs),
# us=(Tcs,Fs), ps=(F0s)
CSTR_STEADY_STATE = dict(
    xs=np.array([0.878, 324.5, 0.659]),
    us=np.array([300.0, 0.1]),
    ps=np.array([0.1]),
)


def cstr_ode(x, u, p):
    """xdot for the CSTR (reference cstr_ode, src/cstr.c:50-65)."""
    c, T, h = x[..., 0], x[..., 1], x[..., 2]
    Tc, F = u[..., 0], u[..., 1]
    F0 = p[..., 0]
    kT = K0 * torch.exp(-E_OVER_R / T)
    S = math.pi * RADIUS**2
    return torch.stack([
        F0 * (C0 - c) / (S * h) - kT * c,
        F0 * (T0 - T) / (S * h)
        + (-DELTA_H) / (RHO * CP) * kT * c
        + 2 * U_HT / (RADIUS * RHO * CP) * (Tc - T),
        (F0 - F) / S,
    ], dim=-1)


def cstr_jacobian(x, u, p):
    """Analytic d(xdot)/dx (reference cstr_jacobian, src/cstr.c:67-87).
    Third row is zero: level dynamics do not depend on the state."""
    del u
    c, T, h = x[..., 0], x[..., 1], x[..., 2]
    F0 = p[..., 0]
    kT = K0 * torch.exp(-E_OVER_R / T)
    S = math.pi * RADIUS**2
    heat = (-DELTA_H) / (RHO * CP)
    return torch.stack([
        torch.stack([
            -F0 / (S * h) - kT,
            -kT * E_OVER_R / (T * T) * c,
            -F0 * (C0 - c) / (S * h * h),
        ], dim=-1),
        torch.stack([
            heat * kT,
            -F0 / (S * h) + heat * kT * E_OVER_R / (T * T) * c
            - 2 * U_HT / (RADIUS * RHO * CP),
            -F0 * (T0 - T) / (S * h * h),
        ], dim=-1),
        torch.zeros_like(x),
    ], dim=-2)


def cstr_scalars() -> dict[str, float]:
    """The scalars ``cstr_ode`` and ``cstr_jacobian`` compute with, as they
    compute them on the card (1/S as PyTorch divides a tensor by a scalar
    there, -E/R as it divides a scalar by a tensor), for a kernel that
    computes the plant itself (K13, ops/stages_cuda.py)."""
    S = math.pi * RADIUS**2
    return {"S": S, "inv_S": 1.0 / S,
            "heat": (-DELTA_H) / (RHO * CP),
            "cool": 2 * U_HT / (RADIUS * RHO * CP),
            "K0": K0, "E": E_OVER_R, "neg_E": -E_OVER_R, "C0": C0, "T0": T0}


def cstr_linearize(xs, us, ps, dt):
    """Linearise at the steady state and discretise: returns (A, B, Bp)
    (reference cstr_linearize, src/cstr.c:89-132)."""
    xs = np.asarray(xs, dtype=np.float64)
    ps = np.asarray(ps, dtype=np.float64)
    c, T, h = xs
    S = math.pi * RADIUS**2
    jacA = cstr_jacobian(torch.from_numpy(xs), torch.as_tensor(us),
                         torch.from_numpy(ps)).numpy()
    jacB = np.array([
        [0.0, 0.0],
        [2 * U_HT / (RADIUS * RHO * CP), 0.0],
        [0.0, -1.0 / S],
    ])
    jacBp = np.array([
        [(C0 - c) / (S * h)],
        [(T0 - T) / (S * h)],
        [1.0 / S],
    ])
    A, Bint = c2d(jacA, dt)
    return A, Bint @ jacB, Bint @ jacBp
