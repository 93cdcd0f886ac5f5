"""Dense linear-algebra helpers for the control stack (setup-time, host).

Capabilities of reference src/matrices.c, rebuilt on NumPy/LAPACK:
  eps           -> reference `eps` (src/matrices.c:26-36), ULP spacing
  inv           -> reference `dgeinv` (src/matrices.c:38-46)
  pinv_cutoff   -> reference `dgepinv` (src/matrices.c:58-91), SVD pseudo-
                   inverse with the same max(m,n)*eps(s0) singular cutoff
  expm          -> reference `dexpm` (src/matrices.c:93-122), matrix
                   exponential via complex eigendecomposition V e^D V^-1
  c2d           -> reference `ctr_c2d` (src/ctr.c:28-48), continuous->
                   discrete via the augmented-matrix exponential

These run once at controller-setup time on tiny matrices (<= ~10x10), so
they live on the host in float64 NumPy; the per-step closed loop that
consumes their outputs is PyTorch (see hectr_tpu_torch.control.simulate).
"""

from __future__ import annotations

import numpy as np


def eps(a: float) -> float:
    """ULP spacing of |a|: the gap to the next representable double.

    Parity: reference `eps` (src/matrices.c:26-36), which increments the
    bit pattern of |a|.  numpy.spacing(|a|) computes the same quantity.
    """
    return float(np.spacing(abs(float(a))))


def inv(A: np.ndarray) -> np.ndarray:
    """Dense inverse (reference `dgeinv`, src/matrices.c:38-46)."""
    return np.linalg.inv(np.asarray(A, dtype=np.float64))


def pinv_cutoff(A: np.ndarray) -> np.ndarray:
    """SVD pseudo-inverse with the reference's singular-value cutoff.

    Parity: reference `dgepinv` (src/matrices.c:58-91): truncate at the
    first singular value below max(m,n)*eps(s[0]).
    """
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    u, s, vt = np.linalg.svd(A, full_matrices=True)
    k = min(m, n)
    cutoff = max(m, n) * eps(s[0]) if s.size else 0.0
    below = np.nonzero(s < cutoff)[0]
    if below.size:
        k = int(below[0])
    return vt[:k, :].T @ np.diag(1.0 / s[:k]) @ u[:, :k].T


def expm(A: np.ndarray) -> np.ndarray:
    """Matrix exponential via complex eigendecomposition.

    Parity: reference `dexpm` (src/matrices.c:93-122): zgeev -> V, D;
    e^A = Re(V e^D V^-1).  Valid for diagonalizable A; callers (c2d)
    perturb degenerate blocks with eps(1) exactly like the reference.
    """
    A = np.asarray(A, dtype=np.float64)
    d, v = np.linalg.eig(A.astype(np.complex128))
    return np.real(v @ np.diag(np.exp(d)) @ np.linalg.inv(v))


def c2d(jacA: np.ndarray, dt: float) -> tuple[np.ndarray, np.ndarray]:
    """Continuous -> discrete: Ad = e^{A dt}, Bint = int_0^dt e^{A s} ds.

    Returns (Ad, Bint); the caller forms Bd = Bint @ jacB.

    Parity: reference `ctr_c2d` (src/ctr.c:28-48): exponentiate the
    augmented 2n x 2n matrix [[A*dt, I*dt], [eps(1)..., eps(1)...]] and
    read the top blocks.  The bottom half is filled with eps(1) (not 0)
    to keep the matrix generically diagonalizable for the
    eigendecomposition-based expm; we reproduce that construction
    exactly because the CSTR golden trajectories depend on it.
    """
    jacA = np.asarray(jacA, dtype=np.float64)
    n = jacA.shape[0]
    M = np.full((2 * n, 2 * n), eps(1.0), dtype=np.float64)
    M[:n, :n] = jacA * dt
    M[:n, n:] = np.eye(n) * dt
    E = expm(M)
    return E[:n, :n], E[:n, n:]
