"""Fixed-step ODE integrators on float64 tensors.

Capabilities of reference src/ode.c, as ``hectr_tpu/control/ode.py``:
`ode45` is a classic fixed-step RK4 (src/ode.c:25-63); `ode15s` is a
one-step linearly-implicit stiff update x' = x + dt*(I - dt*J)^-1 f(x)
(src/ode.c:65-95).  The golden trajectories depend on these exact
schemes.
"""

from __future__ import annotations

import torch


def rk4_step(f, x, u, p, dt):
    """One classic 4th-order Runge-Kutta step of x' = f(x, u, p)."""
    k1 = dt * f(x, u, p)
    k2 = dt * f(x + k1 / 2, u, p)
    k3 = dt * f(x + k2 / 2, u, p)
    k4 = dt * f(x + k3, u, p)
    return x + (k1 + 2 * k2 + 2 * k3 + k4) / 6


def stiff_step(f, jac, x, u, p, dt):
    """One linearly-implicit stiff step: x + dt * (I - dt*J)^-1 f(x)."""
    n = x.shape[-1]
    A = torch.eye(n, dtype=x.dtype, device=x.device) - dt * jac(x, u, p)
    return x + dt * torch.linalg.solve(A, f(x, u, p))
