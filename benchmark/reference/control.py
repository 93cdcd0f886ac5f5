"""The controller's set-up maths in NumPy float64: discretisation, the
Kalman estimator, the target selector and the condensed MPC gains
(upstream src/ctr.c, src/dare.c, src/dlqe.c, src/mpc.c, src/hempc.c).

A frozen copy of the plain control maths: the same formulas, start
points, tolerances and iteration caps as the upstream C, so that the
reference's gains agree with any faithful implementation to rounding.
"""

from __future__ import annotations

import numpy as np

TOLERANCE = 1e-10   # DARE convergence (HECTR_TOLERANCE, src/hectr.h:39)
SMALL = 1e-5        # estimator noise weights (HECTR_SMALL, src/hectr.h:40)
ITER_MAX = 10000    # DARE iteration cap (HECTR_ITER_MAX, src/hectr.h:41)


def expm(A):
    """e^A by complex eigendecomposition (upstream dexpm,
    src/matrices.c:93-122)."""
    d, v = np.linalg.eig(np.asarray(A, dtype=np.float64).astype(np.complex128))
    return np.real(v @ np.diag(np.exp(d)) @ np.linalg.inv(v))


def c2d(jac_a, dt):
    """(Ad, Bint): the augmented-matrix exponential with its bottom half
    filled with eps(1), as upstream ctr_c2d (src/ctr.c:28-48)."""
    n = jac_a.shape[0]
    M = np.full((2 * n, 2 * n), np.spacing(1.0))
    M[:n, :n] = jac_a * dt
    M[:n, n:] = np.eye(n) * dt
    E = expm(M)
    return E[:n, :n], E[:n, n:]


def weighting(xs, us):
    """Q = diag(1/xs^2), R = diag(1/us^2) (src/ctr.c:50-60)."""
    return np.diag(1.0 / np.asarray(xs) ** 2), np.diag(1.0 / np.asarray(us) ** 2)


def dare(A, B, Q, R):
    """X = A'XA - A'XB (R + B'XB)^-1 B'XA + Q by fixed-point iteration
    from X = Q (src/dare.c:38-135)."""
    X = Q.copy()
    for _ in range(ITER_MAX):
        ATX = A.T @ X
        BTX = B.T @ X
        Xn = ATX @ A - (ATX @ B) @ np.linalg.inv(R + BTX @ B) @ (BTX @ A) + Q
        diff = np.max(np.abs(Xn - X))
        X = Xn
        if diff < TOLERANCE:
            break
    return X


def estimator_gains(A, C, Bd, Cd, xs):
    """(Lx, Ld): the Kalman gain of the disturbance-augmented model
    (src/ctr.c:62-119, src/dlqe.c:39-77)."""
    nx, nd, ny = A.shape[0], Bd.shape[1], C.shape[0]
    na = nx + nd
    Aaug = np.zeros((na, na))
    Aaug[:nx, :nx] = A
    Aaug[:nx, nx:] = Bd
    Aaug[nx:, nx:] = np.eye(nd)
    Caug = np.hstack([C, Cd])
    Qw = np.eye(na) * SMALL
    Qw[-1, -1] = 1.0
    Rv = np.diag(SMALL * np.asarray(xs)[:ny] ** 2)
    X = dare(Aaug.T, Caug.T, Qw, Rv)
    XCT = X @ Caug.T
    L = XCT @ np.linalg.inv(Caug @ XCT + Rv)
    return L[:nx], L[nx:]


def selector(A, B, C, Hr):
    """Ginv = inv([[I - A, -B], [Hr C, 0]]) (src/ctr.c:121-154)."""
    nx, nu = B.shape
    G = np.zeros((nx + nu, nx + nu))
    G[:nx, :nx] = np.eye(nx) - A
    G[:nx, nx:] = -B
    G[nx:, :nx] = Hr @ C
    return np.linalg.inv(G)


def horizon(A, B, C, Q, R, N):
    """(AA, BB, Theta, CC, QQ, RR): the lifted horizon matrices
    (src/mpc.c:27-95)."""
    n, m = B.shape
    Ak = [np.eye(n)]
    for _ in range(N):
        Ak.append(Ak[-1] @ A)
    BBk = [np.zeros((n, m))]
    for k in range(1, N + 1):
        BBk.append(BBk[-1] + Ak[k - 1] @ B)
    Theta = np.zeros((n * (N + 1), m * N))
    for i in range(1, N + 1):
        for j in range(i):
            Theta[i * n:(i + 1) * n, j * m:(j + 1) * m] = BBk[i - j]
    return (np.vstack(Ak), np.vstack(BBk), Theta, np.kron(np.eye(N + 1), C),
            np.kron(np.eye(N + 1), Q), np.kron(np.eye(N), R))


def mpc_gains(A, B, C, Q, R, N):
    """(K_A, K_B, H): du = -(K_A (xhat - xr) + K_B (uhat - ur)) over the
    horizon, and the condensed Hessian (src/hempc.c:117-196,
    src/mpc.c:161-196)."""
    AA, BB, Theta, CC, QQ, RR = horizon(A, B, C, Q, R, N)
    CCTheta = CC @ Theta
    TtCtQ = CCTheta.T @ QQ
    H = TtCtQ @ CCTheta + RR
    Hinv = np.linalg.inv(H)
    return Hinv @ (TtCtQ @ (CC @ AA)), Hinv @ (TtCtQ @ (CC @ BB)), H
