"""The law of the fused form: the reference-shaped form's law in the
packed algebra the fused regulator evaluates, u = (S - K) v1 + K v2 with
v1 = [xhat, uhat], v2 = [xr, ur], K = [K_A | K_B] (its first nu rows)
and S the selector of uhat in v1.  Equal to the reference-shaped law to
rounding."""

from __future__ import annotations

import numpy as np


def law(system, config):
    nx, nu = system.B.shape
    K = np.hstack([system.K_A[:nu], system.K_B[:nu]])
    S = np.zeros_like(K)
    S[:, nx:] = np.eye(nu, dtype=K.dtype)
    first, second = (S - K).T, K.T

    def move(xhat, uhat, xr, ur):
        return (np.concatenate([xhat, uhat], axis=-1) @ first
                + np.concatenate([xr, ur], axis=-1) @ second)
    return move
