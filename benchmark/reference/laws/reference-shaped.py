"""The law of the reference-shaped form: the upstream's unconstrained
condensed MPC (src/hempc.c:216-266), whose first nu moves the loop
applies."""

from __future__ import annotations


class MPCLaw:
    """u = uhat + du[:nu], du = -(K_A (xhat - xr) + K_B (uhat - ur))."""

    def __init__(self, sys):
        nu = sys.B.shape[1]
        self.K_A, self.K_B = sys.K_A[:nu], sys.K_B[:nu]

    def __call__(self, xhat, uhat, xr, ur):
        return uhat - ((xhat - xr) @ self.K_A.T + (uhat - ur) @ self.K_B.T)


def law(system, config):
    return MPCLaw(system)
