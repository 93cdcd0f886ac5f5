"""Condensed linear MPC (setup-time gain computation + demo solver).

Capabilities of reference src/mpc.c (and the duplicated horizon builder
in src/hempc.c:27-95):

  horizon_matrices -> reference `calc_horizon_matrices` (src/mpc.c:27-95)
  mpc_gains        -> reference `calc_coeff` (src/hempc.c:117-196): the
                      precomputed unconstrained-MPC gain matrices
                      K_A = H^-1 Th' CC' QQ CC AA   (mN x n)
                      K_B = H^-1 Th' CC' QQ CC BB   (mN x m)
                      with du = -(K_A (xhat-xr) + K_B (uhat-ur)) and
                      u = uhat + du[0:m].
  ctr_mpc          -> reference `ctr_mpc` (src/mpc.c:380-420): full MPC
                      with optional du/u/x box constraints via quadprog.

Design deviation from the reference (documented, intentional): the
reference recomputes the horizon matrices and the Hessian inverse at
*every* closed-loop step (src/ctr.c:425 -> src/mpc.c:397-403, and
src/ctr.c:589 -> src/hempc.c:232-238) even though A,B,C,Q,R are
constant.  Here `mpc_gains` is computed once at setup; the per-step
update is two small dense mat-vecs, which is also exactly the shape of
the encrypted update (two he_gemv, src/hempc.c:257-259).

Known reference quirks handled:
  * `calc_bnd_du`/`calc_bnd_u` index rows with stride N instead of mN
    (src/mpc.c:244,265) -- correct only for m==1, which all tests use.
    We build the correct mN-stride identity (same result for m==1).
  * `ctr_mpc` is called with l=ny but a Q sized nx x nx (src/ctr.c:425,
    src/mpc.c:55-56) -- consistent because ny==nx in every test; the
    shapes here are explicit so mismatch would raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hectr_tpu_torch.control.qp import quadprog


@dataclasses.dataclass(frozen=True)
class MPCBounds:
    """Optional box constraints for ctr_mpc (pairs must be set together,
    mirroring the paired-validation in reference calc_bnddim,
    src/mpc.c:198-232)."""

    dumin: np.ndarray | None = None
    dumax: np.ndarray | None = None
    umin: np.ndarray | None = None
    umax: np.ndarray | None = None
    xmin: np.ndarray | None = None
    xmax: np.ndarray | None = None

    def __post_init__(self):
        for lo, hi in (("dumin", "dumax"), ("umin", "umax"), ("xmin", "xmax")):
            if (getattr(self, lo) is None) != (getattr(self, hi) is None):
                raise ValueError(f"{lo} and {hi} must be set in pairs")

    @property
    def any(self) -> bool:
        return any(
            getattr(self, f) is not None
            for f in ("dumin", "umin", "xmin")
        )


def horizon_matrices(l, n, m, N, A, B, C, Q, R):
    """Build the lifted horizon matrices.

    Returns (AA, BB, Theta, CC, QQ, RR):
      AA   [n(N+1), n]     : stacked A^k, k=0..N
      BB   [n(N+1), m]     : stacked sum_{j=0}^{k-1} A^j B  (BB_0 = 0)
      Theta[n(N+1), mN]    : block (i, j) = BB_{i-j} for i>j else 0
      CC   [l(N+1), n(N+1)]: blockdiag(C)
      QQ   [l(N+1), l(N+1)]: blockdiag(Q)
      RR   [mN, mN]        : blockdiag(R)

    Parity: reference `calc_horizon_matrices` (src/mpc.c:27-95).
    """
    A = np.asarray(A, dtype=np.float64).reshape(n, n)
    B = np.asarray(B, dtype=np.float64).reshape(n, m)
    C = np.asarray(C, dtype=np.float64).reshape(l, n)
    Q = np.asarray(Q, dtype=np.float64).reshape(l, l)
    R = np.asarray(R, dtype=np.float64).reshape(m, m)

    Ak = [np.eye(n)]
    for _ in range(N):
        Ak.append(Ak[-1] @ A)
    AA = np.vstack(Ak)  # [n(N+1), n]

    BBk = [np.zeros((n, m))]
    for k in range(1, N + 1):
        BBk.append(BBk[-1] + Ak[k - 1] @ B)
    BB = np.vstack(BBk)  # [n(N+1), m]

    Theta = np.zeros((n * (N + 1), m * N))
    for i in range(1, N + 1):          # block row
        for j in range(i):             # block col; coefficient BB_{i-j}
            Theta[i * n:(i + 1) * n, j * m:(j + 1) * m] = BBk[i - j]

    CC = np.kron(np.eye(N + 1), C)
    QQ = np.kron(np.eye(N + 1), Q)
    RR = np.kron(np.eye(N), R)
    return AA, BB, Theta, CC, QQ, RR


def mpc_gains(l, n, m, N, A, B, C, Q, R):
    """Precompute the unconstrained-MPC gain matrices (K_A, K_B).

    du = -(K_A (xhat - xr) + K_B (uhat - ur));  u = uhat + du[0:m].

    Parity: reference `calc_coeff` (src/hempc.c:117-196), which embeds
    exactly these two matrices into CKKS slot layouts for the encrypted
    update; the unconstrained branch of `ctr_mpc` (src/mpc.c:412-418)
    computes the same linear map step-by-step.
    """
    AA, BB, Theta, CC, QQ, RR = horizon_matrices(l, n, m, N, A, B, C, Q, R)
    CCTheta = CC @ Theta
    TtCtQ = CCTheta.T @ QQ                  # Theta' CC' QQ   [mN, l(N+1)]
    H = TtCtQ @ CCTheta + RR                # Hessian         [mN, mN]
    Hinv = np.linalg.inv(H)
    K_A = Hinv @ (TtCtQ @ (CC @ AA))        # [mN, n]
    K_B = Hinv @ (TtCtQ @ (CC @ BB))        # [mN, m]
    return K_A, K_B


def mpc_hessian(l, n, m, N, A, B, C, Q, R) -> np.ndarray:
    """The condensed-QP Hessian H = Theta' CC' QQ CC Theta + RR
    (reference calc_Hc, src/mpc.c:161-196) -- needed by the encrypted
    projected-gradient QP (hempc.qp_enc, not ported yet), whose gradient is
    H (du - du_unc)."""
    AA, BB, Theta, CC, QQ, RR = horizon_matrices(l, n, m, N, A, B, C, Q, R)
    CCTheta = CC @ Theta
    return CCTheta.T @ QQ @ CCTheta + RR


def _bound_rows(n, m, N, bounds: MPCBounds, uhat, Theta, f):
    """Assemble inequality rows A du + b <= 0 for the box constraints.

    Parity: reference `calc_bnd` and helpers (src/mpc.c:234-344), with
    the row-stride bug fixed (see module docstring):
      du bounds: [-I; +I] du + [dumin; -dumax] <= 0
      u  bounds: [-I; +I] du + [umin - uhat; -umax + uhat] <= 0
                 (the reference constrains uhat + du_k, not the
                 cumulative sum -- replicated, the goldens depend on it)
      x  bounds: [-Theta; +Theta] du + [xmin - f; -xmax + f] <= 0
    Order: du rows, then u rows, then x rows (reference calc_bnd).
    """
    mN = m * N
    rows_A, rows_b = [], []
    if bounds.dumin is not None:
        I = np.eye(mN)
        rows_A += [-I, I]
        rows_b += [np.tile(np.asarray(bounds.dumin, dtype=np.float64), N),
                   -np.tile(np.asarray(bounds.dumax, dtype=np.float64), N)]
    if bounds.umin is not None:
        I = np.eye(mN)
        lo = np.tile(np.asarray(bounds.umin, dtype=np.float64) - uhat, N)
        hi = np.tile(-np.asarray(bounds.umax, dtype=np.float64) + uhat, N)
        rows_A += [-I, I]
        rows_b += [lo, hi]
    if bounds.xmin is not None:
        lo = np.tile(np.asarray(bounds.xmin, dtype=np.float64), N + 1) - f
        hi = -np.tile(np.asarray(bounds.xmax, dtype=np.float64), N + 1) + f
        rows_A += [-Theta, Theta]
        rows_b += [lo, hi]
    return np.vstack(rows_A), np.concatenate(rows_b)


def ctr_mpc(l, n, m, N, A, B, C, Q, R, xhat, uhat, xr, ur,
            bounds: MPCBounds | None = None):
    """One MPC solve: returns the control sequence u [N, m].

    Unconstrained: du = -H^-1 Theta' CC' QQ CC (AA (xhat-xr) +
    BB (uhat-ur)); constrained: active-set QP on the same H with the box
    rows.  u_k = uhat + cumsum(du)_k (reference `calc_u`,
    src/mpc.c:346-360 -- note it offsets by the *current* control uhat).

    Parity: reference `ctr_mpc` (src/mpc.c:380-420).
    """
    xhat = np.asarray(xhat, dtype=np.float64).ravel()[:n]
    uhat = np.asarray(uhat, dtype=np.float64).ravel()[:m]
    xr = np.asarray(xr, dtype=np.float64).ravel()[:n]
    ur = np.asarray(ur, dtype=np.float64).ravel()[:m]
    bounds = bounds or MPCBounds()

    AA, BB, Theta, CC, QQ, RR = horizon_matrices(l, n, m, N, A, B, C, Q, R)
    # Free response f and tracking error e (reference calc_ef,
    # src/mpc.c:113-144): e = CC (AA (xhat-xr) + BB (uhat-ur)).
    f = AA @ xhat + BB @ uhat
    e = CC @ (AA @ (xhat - xr) + BB @ (uhat - ur))
    CCTheta = CC @ Theta
    TtCtQ = CCTheta.T @ QQ
    H = TtCtQ @ CCTheta + RR
    c = TtCtQ @ e                       # (reference calc_Hc, src/mpc.c:161-196)

    if bounds.any:
        Ain, bin = _bound_rows(n, m, N, bounds, uhat, Theta, f)
        du = quadprog(H, c, Ain=Ain, bin=bin)
    else:
        du = np.linalg.solve(H, -c)

    u = uhat[None, :] + np.cumsum(du.reshape(N, m), axis=0)
    return u
