"""Discrete Riccati / LQR / LQE solvers (setup-time, host NumPy).

Capabilities of reference src/dare.c, src/dlqr.c, src/dlqe.c.  These run
once per controller setup on tiny systems, so they are host NumPy
float64; their outputs (gain matrices) feed the closed loop.
"""

from __future__ import annotations

import warnings

import numpy as np

from hectr_tpu_torch.config import ITER_MAX, TOLERANCE


def dare(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Discrete algebraic Riccati equation by fixed-point iteration.

    X = A'XA - A'XB (R + B'XB)^-1 B'XA + Q, starting from X = Q,
    iterated until max|dX| < 1e-10 or 10000 iterations.

    Parity: reference `dare` (src/dare.c:38-135), same start, update,
    tolerance (HECTR_TOLERANCE) and iteration cap (HECTR_ITER_MAX).
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    X = Q.copy()
    diff = np.inf
    for _ in range(ITER_MAX):
        ATX = A.T @ X
        BTX = B.T @ X
        Xn = ATX @ A - (ATX @ B) @ np.linalg.inv(R + BTX @ B) @ (BTX @ A) + Q
        diff = np.max(np.abs(Xn - X))
        X = Xn
        if diff < TOLERANCE:
            break
    if not diff < TOLERANCE:
        warnings.warn(
            f"dare: tolerance {TOLERANCE:g} not reached, diff={diff:g}",
            stacklevel=2,
        )
    return X


def dlqr(A, B, Q, R) -> tuple[np.ndarray, np.ndarray]:
    """Discrete LQR gain G = (B'XB + R)^-1 B'XA; returns (G, X).

    Parity: reference `dlqr` (src/dlqr.c:36-73).
    """
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    X = dare(A, B, Q, R)
    BTX = B.T @ X
    G = np.linalg.inv(BTX @ B + np.asarray(R, dtype=np.float64)) @ (BTX @ A)
    return G, X


def dlqe(A, C, Q, R) -> np.ndarray:
    """Discrete Kalman gain: dualize (A', C'), solve DARE,
    G = XC' (CXC' + R)^-1.

    Parity: reference `dlqe` (src/dlqe.c:39-77).
    """
    A = np.asarray(A, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    X = dare(A.T, C.T, Q, R)
    XCT = X @ C.T
    return XCT @ np.linalg.inv(C @ XCT + np.asarray(R, dtype=np.float64))
