"""The Henson & Seborg CSTR, in NumPy, from the constants a configuration
file states (upstream src/cstr.c:26-132, tests/hectr.c:523-528).

States (c, T, h), inputs (Tc, F), parameter F0.  Every function takes a
state [3] or a batch of them [..., 3] and keeps the dtype it is given,
so the same code runs the float64 reference and its float32 control.
"""

from __future__ import annotations

import math

import numpy as np


class CSTR:
    """The plant's equations over the constants of one configuration."""

    def __init__(self, constants: dict):
        c = constants
        self.rho, self.cp, self.dh = c["RHO"], c["CP"], c["DELTA_H"]
        self.e_over_r, self.k0, self.u_ht = c["E_OVER_R"], c["K0"], c["U_HT"]
        self.c0, self.t0, self.radius = c["C0"], c["T0"], c["RADIUS"]
        self.area = math.pi * self.radius ** 2

    def ode(self, x, u, p):
        """xdot (upstream cstr_ode, src/cstr.c:50-65)."""
        c, T, h = x[..., 0], x[..., 1], x[..., 2]
        Tc, F, F0 = u[..., 0], u[..., 1], p[..., 0]
        kT = self.k0 * np.exp(-self.e_over_r / T)
        S = self.area
        return np.stack([
            F0 * (self.c0 - c) / (S * h) - kT * c,
            F0 * (self.t0 - T) / (S * h)
            + (-self.dh) / (self.rho * self.cp) * kT * c
            + 2 * self.u_ht / (self.radius * self.rho * self.cp) * (Tc - T),
            (F0 - F) / S,
        ], axis=-1)

    def jacobian(self, x, p):
        """d(xdot)/dx (upstream cstr_jacobian, src/cstr.c:67-87)."""
        c, T, h = x[..., 0], x[..., 1], x[..., 2]
        F0 = p[..., 0]
        kT = self.k0 * np.exp(-self.e_over_r / T)
        S = self.area
        heat = (-self.dh) / (self.rho * self.cp)
        zero = np.zeros_like(c)
        return np.stack([
            np.stack([-F0 / (S * h) - kT,
                      -kT * self.e_over_r / (T * T) * c,
                      -F0 * (self.c0 - c) / (S * h * h)], axis=-1),
            np.stack([heat * kT,
                      -F0 / (S * h) + heat * kT * self.e_over_r / (T * T) * c
                      - 2 * self.u_ht / (self.radius * self.rho * self.cp),
                      -F0 * (self.t0 - T) / (S * h * h)], axis=-1),
            np.stack([zero, zero, zero], axis=-1),
        ], axis=-2)

    def input_jacobians(self, xs):
        """(d xdot/du, d xdot/dF0) at the state xs (src/cstr.c:89-132)."""
        c, T, h = xs
        S = self.area
        jac_b = np.array([[0.0, 0.0],
                          [2 * self.u_ht / (self.radius * self.rho * self.cp),
                           0.0],
                          [0.0, -1.0 / S]])
        jac_p = np.array([[(self.c0 - c) / (S * h)],
                          [(self.t0 - T) / (S * h)],
                          [1.0 / S]])
        return jac_b, jac_p

    def stiff_step(self, x, u, p, dt):
        """One linearly-implicit step x + dt (I - dt J)^-1 f(x)
        (upstream ode15s, src/ode.c:65-95)."""
        eye = np.eye(3, dtype=x.dtype)
        A = eye - dt * self.jacobian(x, p)
        f = self.ode(x, u, p)
        return x + dt * np.linalg.solve(A, f[..., None])[..., 0]

    def actuate(self, x, u, p, xs, us, ps, dt):
        """One controller interval of the nonlinear plant in deviation
        variables: two stiff substeps of dt/2 (upstream ctr_actuate,
        src/ctr.c:334-354)."""
        xx, uu, pp = x + xs, u + us, p + ps
        half = x.dtype.type(dt / 2)
        for _ in range(2):
            xx = self.stiff_step(xx, uu, pp, half)
        return xx - xs
