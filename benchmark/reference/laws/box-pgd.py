"""The law of the box-pgd form: the upstream's condensed MPC with its box
on the moves (calc_bnd_du, solved by quadprog in ctr_mpc,
src/mpc.c:198-420),

    min 1/2 du' H du + c' du   s.t.  dumin <= du_j <= dumax, each move j
                                     of the horizon,

solved as an encrypted regulator can solve it (Schulze Darup et al.,
"Towards encrypted MPC for linear constrained systems", IEEE Control
Systems Letters, 2018): a fixed number of projected-gradient iterations
from the unconstrained optimum, the projection an odd polynomial
surrogate of the box's clamp.  In units of the box's half widths hw about
its middles mid (w-space):

    du_unc  = -(K_A (xhat - xr) + K_B (uhat - ur))
    w_unc   = (du_unc - mid) / hw
    z_0     = p_first(w_unc)
    z_t+1   = p_iter(z_t - G (z_t - w_unc)),   G = eta diag(1/hw) H diag(hw)
    u       = uhat + (mid + hw z_T)[:nu]

The step eta is the smaller of 2 / (l_min + l_max) of H and the step that
keeps every iteration clip's input within 3 half widths; each slot's
clip is fitted on its own domain: B0 (the configuration's
``input_bound``, a bound on |w_unc|) for the first, 1 + eta (|H| hw (1 +
B0))_i / hw_i for the iterations', each rounded up to a 0.25 grid and at
least 1.5.  A fit is Lawson's minimax iteration for an odd polynomial of
clamp(w, -1, 1), scaled so that max |p| = 1 on its domain: the box holds
wherever the clip's input lies in its domain.

Set-up (H, eta, domains, fits) is float64; the loop's arithmetic runs in
the system's dtype, so the float32 control runs the PGD in float32.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference import control as K

MAX_ITER_DOMAIN = 3.0   # the iteration clips' domain the step keeps within
GRID_PER_UNIT = 2000    # fit points a unit of w (at least MIN_GRID in all)
MIN_GRID = 8001
SWEEPS = 300            # Lawson's reweighting sweeps
QUANTUM, MIN_DOMAIN = 0.25, 1.5


@functools.lru_cache(maxsize=None)
def clip_fit(domain: float, degree: int) -> tuple[float, ...]:
    """Coefficients of w, w^3, ..., w^degree: Lawson's minimax fit to
    clamp(w, -1, 1) on [-domain, domain].  Weighted least squares on an
    even grid; after each solve every weight is multiplied by the square
    root of its point's residual (+ 1e-14) and the weights are scaled to
    a largest of 1.  The fit is then divided by its largest |p| on the
    grid."""
    points = max(MIN_GRID, 2 * int(GRID_PER_UNIT * domain) + 1)
    w = np.linspace(-domain, domain, points)
    target = np.clip(w, -1.0, 1.0)
    basis = np.stack([w ** e for e in range(1, degree + 1, 2)], axis=1)
    weight = np.ones_like(w)
    for _ in range(SWEEPS):
        coef = np.linalg.lstsq(basis * weight[:, None], target * weight,
                               rcond=None)[0]
        weight = weight * np.sqrt(np.abs(basis @ coef - target) + 1e-14)
        weight = weight / weight.max()
    coef = coef / np.max(np.abs(basis @ coef))
    return tuple(float(c) for c in coef)


def quantized(domains) -> np.ndarray:
    """Fit domains rounded up to the 0.25 grid, at least 1.5."""
    d = np.asarray(domains, dtype=np.float64)
    return np.maximum(np.ceil(d / QUANTUM) * QUANTUM, MIN_DOMAIN)


def box(config):
    """(mid, hw) of the box over the horizon's moves, float64."""
    rc = config["regulator"]
    lo = np.tile(np.asarray(rc["dumin"], dtype=np.float64), rc["horizon"])
    hi = np.tile(np.asarray(rc["dumax"], dtype=np.float64), rc["horizon"])
    return (lo + hi) / 2.0, (hi - lo) / 2.0


def hessian(system, config) -> np.ndarray:
    """The condensed Hessian H of the horizon's QP, float64 (from the
    system's matrices as given)."""
    A, B, C, xs, us = (np.asarray(m, dtype=np.float64) for m in
                       (system.A, system.B, system.C, system.xs, system.us))
    Q, R = K.weighting(xs, us)
    return K.mpc_gains(A, B, C, Q, R, config["regulator"]["horizon"])[2]


def pgd_setup(H, hw, bound):
    """(eta, first clip's domains, iteration clips' domains), float64."""
    reach = np.abs(H) @ (hw * (1.0 + bound))
    ev = np.linalg.eigvalsh((H + H.T) / 2.0)
    eta = min(2.0 / (ev[0] + ev[-1]),
              (MAX_ITER_DOMAIN - 1.0) / np.max(reach / hw))
    first = np.full(hw.shape, float(bound))
    return float(eta), first, 1.0 + eta * reach / hw


def coefficients(domains, degree: int) -> np.ndarray:
    """[slots, terms]: each slot's fit on its quantized domain."""
    return np.array([clip_fit(float(d), degree) for d in quantized(domains)])


def law(system, config):
    rc = config["regulator"]
    iters, degree = int(rc["iterations"]), int(rc["clip_degree"])
    nu = system.B.shape[1]
    dt = system.K_A.dtype
    mid, hw = box(config)
    H = hessian(system, config)
    eta, first, then = pgd_setup(H, hw, float(rc["input_bound"]))
    G = (eta * H * hw[None, :] / hw[:, None]).astype(dt)
    c_first = coefficients(first, degree).astype(dt)
    c_then = coefficients(then, degree).astype(dt)
    K_A, K_B = system.K_A, system.K_B
    mid, hw = mid.astype(dt), hw.astype(dt)
    powers = range(1, degree + 1, 2)

    def clip(w, coef):
        acc = np.zeros_like(w)
        for i, e in enumerate(powers):
            acc = acc + coef[:, i] * w ** e
        return acc

    def move(xhat, uhat, xr, ur):
        du_unc = -((xhat - xr) @ K_A.T + (uhat - ur) @ K_B.T)
        w_unc = (du_unc - mid) / hw
        z = clip(w_unc, c_first)
        for _ in range(iters):
            z = clip(z - (z - w_unc) @ G.T, c_then)
        return uhat + (mid + hw * z)[..., :nu]
    return move


def checks(config, x, u):
    """du_box_excess: for each loop-step, how far its applied move u_k -
    u_(k-1) lies beyond the box, in half widths: the largest over the
    inputs of (|du - mid| - hw) / hw, floored at 0.  The first step's
    move is taken from the steady state us, where the loop starts (zero
    set-points, so the regulator's uhat is us there)."""
    rc = config["regulator"]
    lo = np.asarray(rc["dumin"], dtype=np.float64)
    hi = np.asarray(rc["dumax"], dtype=np.float64)
    mid, hw = (lo + hi) / 2.0, (hi - lo) / 2.0
    u = np.asarray(u, dtype=np.float64)
    us = np.asarray(config["plant"]["us"], dtype=np.float64)
    du = np.diff(u, axis=-2, prepend=np.broadcast_to(us, u[..., :1, :].shape))
    excess = np.maximum((np.abs(du - mid) - hw) / hw, 0.0).max(axis=-1)
    return {"du_box_excess": (excess,
                              config["correct_limits"]["du_box_excess"])}
