"""Active-set quadratic programming (setup/demo-time, host NumPy).

Capability of reference src/quadprog.c:

    min_w  0.5 w'Hw + c'w
    s.t.   Ain w + bin <= 0      (inequality)
           Aeq w + beq  = 0      (equality)
           lb <= w <= ub         (bounds, folded into inequality rows)

Algorithm parity with reference `quadprog` (src/quadprog.c:422-480):
  * feasibility restoration of w0 against the equality constraints via
    pseudo-inverse when |Aeq w0 + beq| > FLT_EPSILON (`check_w0`,
    src/quadprog.c:153-177),
  * bounds folded as [-I; +I] rows after Ain (`set_Ab`,
    src/quadprog.c:179-212),
  * working set initialised from near-active rows at w0 (`init_W`,
    src/quadprog.c:214-231, threshold -FLT_EPSILON),
  * equality-constrained subproblem on the working set (`calc_p`,
    src/quadprog.c:240-336) -- here solved as one least-squares KKT
    system instead of the reference's explicit block inverse, which
    assumed invertible H and independent active rows (LAPACK returned
    garbage on e.g. the singular-H pyecosqp test1; least-squares is the
    principled equivalent and matches the documented optima),
  * most-negative-multiplier constraint drop (`calc_mu`,
    src/quadprog.c:341-355) and ratio-test constraint add
    (`calc_alpha`, src/quadprog.c:362-397),
  * same tolerances: HECTR_TOLERANCE on |p|^2, HECTR_ITER_MAX cap.

The QP is inherently sequential scalar-matrix work (active-set updates
on <= ~100-dim problems) and only serves the *constrained* MPC demos;
the encrypted control path is unconstrained (reference src/hempc.c has
no encrypted QP).  It therefore runs on host NumPy.
"""

from __future__ import annotations

import numpy as np

from hectr_tpu_torch.config import FLT_EPSILON, ITER_MAX, TOLERANCE


def _kkt_solve(H, g, A, h):
    """Solve the equality-constrained QP  min 0.5 p'Hp + g'p  s.t. Ap+h=0
    via the KKT system [[H, A'], [A, 0]] [p; lam] = [-g; -h].

    Least-squares (min-norm) solve so redundant/rank-deficient working
    sets and singular H are handled; reference `qp_lagrange`
    (src/quadprog.c:40-151) computed an explicit block inverse.
    """
    n = H.shape[0]
    m = A.shape[0] if A is not None and A.size else 0
    if m == 0:
        p, *_ = np.linalg.lstsq(H, -g, rcond=None)
        return p, np.zeros(0)
    K = np.zeros((n + m, n + m))
    K[:n, :n] = H
    K[:n, n:] = A.T
    K[n:, :n] = A
    rhs = np.concatenate([-g, -h])
    sol, *_ = np.linalg.lstsq(K, rhs, rcond=None)
    return sol[:n], sol[n:]


def quadprog(
    H,
    c,
    Ain=None,
    bin=None,
    Aeq=None,
    beq=None,
    lb=None,
    ub=None,
    w0=None,
):
    """Solve the QP; returns the minimiser w (see module docstring)."""
    H = np.asarray(H, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64).ravel()
    n = c.shape[0]
    w = np.zeros(n) if w0 is None else np.asarray(w0, dtype=np.float64).copy()

    meq = 0
    if Aeq is not None:
        Aeq = np.asarray(Aeq, dtype=np.float64).reshape(-1, n)
        beq = np.asarray(beq, dtype=np.float64).ravel()
        meq = Aeq.shape[0]
        # Feasibility restoration (reference check_w0, src/quadprog.c:153-177)
        if np.any(np.abs(Aeq @ w + beq) > FLT_EPSILON):
            from hectr_tpu_torch.control.linalg import pinv_cutoff

            w = pinv_cutoff(Aeq) @ (-beq)

    # Fold inequality rows + bounds into one A w + b <= 0 system
    # (reference set_Ab, src/quadprog.c:179-212: Ain rows, then lb rows
    # as -I/+lb, then ub rows as +I/-ub).
    rows_A, rows_b = [], []
    if Ain is not None and np.size(Ain):
        rows_A.append(np.asarray(Ain, dtype=np.float64).reshape(-1, n))
        rows_b.append(np.asarray(bin, dtype=np.float64).ravel())
    if lb is not None:
        rows_A.append(-np.eye(n))
        rows_b.append(np.asarray(lb, dtype=np.float64).ravel())
    if ub is not None:
        rows_A.append(np.eye(n))
        rows_b.append(-np.asarray(ub, dtype=np.float64).ravel())
    if rows_A:
        A = np.vstack(rows_A)
        b = np.concatenate(rows_b)
    else:
        A = np.zeros((0, n))
        b = np.zeros(0)
    m = A.shape[0]

    # Working set: rows near-active/violated at w0
    # (reference init_W, src/quadprog.c:214-231).
    W = (A @ w + b) > -FLT_EPSILON if m else np.zeros(0, dtype=bool)

    for _ in range(ITER_MAX):
        # Equality-constrained subproblem on eqlin + active ineqlin rows
        # (reference calc_p, src/quadprog.c:240-336).
        act = np.nonzero(W)[0]
        if meq:
            A_eff = np.vstack([Aeq, A[act]]) if act.size else Aeq
            b_eff = np.concatenate([beq, b[act]]) if act.size else beq
        else:
            A_eff = A[act]
            b_eff = b[act]
        g = H @ w + c
        h = A_eff @ w + b_eff if A_eff.size else np.zeros(0)
        p, lam_eff = _kkt_solve(H, g, A_eff if A_eff.size else None, h)

        if p @ p < TOLERANCE:
            if act.size == 0:
                break
            # Most negative multiplier among active inequality rows
            # (reference calc_mu, src/quadprog.c:341-355).
            lam_act = lam_eff[meq:]
            j = int(np.argmin(lam_act))
            if lam_act[j] > 0:
                break
            W[act[j]] = False
        else:
            # Ratio test over inactive rows with a.p > 0
            # (reference calc_alpha, src/quadprog.c:362-397).
            alpha = 1.0
            alpha_idx = -1
            inact = np.nonzero(~W)[0]
            for i in inact:
                ap = A[i] @ p
                if ap > 0:
                    t = -(A[i] @ w + b[i]) / ap
                    if t < alpha:
                        alpha = t
                        alpha_idx = int(i)
            w = w + alpha * p
            if alpha_idx >= 0:
                W[alpha_idx] = True

    return w
