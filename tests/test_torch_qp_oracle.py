"""Active-set QP oracle of the port: the reference's 11 published problems
(tests/hectr.c:26-520: CSDN blog, five MATLAB quadprog doc examples,
Octave, PyAdvancedControl pyecosqp tests 1-3) through the port's
control/qp.quadprog, against scipy SLSQP and the documented optima.

The CLI's `quadprog` subcommand runs this file with --noconftest, so it
imports neither jax nor the JAX package and runs where the card is.  The
cases are those of tests/test_qp.py (ALL_CASES);
tests/test_torch_cli.py holds the two copies equal.
"""

import numpy as np
import pytest
from scipy.optimize import minimize

from hectr_tpu_torch.control.qp import quadprog


def scipy_solve(H, c, Ain=None, bin=None, Aeq=None, beq=None, lb=None, ub=None,
                w0=None):
    n = len(c)
    cons = []
    if Ain is not None:
        Ain, bin = np.asarray(Ain, float), np.asarray(bin, float)
        cons.append({"type": "ineq",
                     "fun": lambda w: -(Ain @ w + bin),
                     "jac": lambda w: -Ain})
    if Aeq is not None:
        Aeq, beq = np.asarray(Aeq, float), np.asarray(beq, float)
        cons.append({"type": "eq",
                     "fun": lambda w: Aeq @ w + beq,
                     "jac": lambda w: Aeq})
    bounds = None
    if lb is not None or ub is not None:
        lo = [-np.inf] * n if lb is None else list(lb)
        hi = [np.inf] * n if ub is None else list(ub)
        bounds = list(zip(lo, hi))
    H = np.asarray(H, float)
    c = np.asarray(c, float)
    res = minimize(
        lambda w: 0.5 * w @ H @ w + c @ w,
        np.zeros(n) if w0 is None else np.asarray(w0, float),
        jac=lambda w: H @ w + c,
        constraints=cons, bounds=bounds, method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-14},
    )
    return res.x


def _octave_case():
    # tests/hectr.c:349-419 (Octave quadprog doc example)
    C = np.array([
        [0.9501, 0.7620, 0.6153, 0.4057],
        [0.2311, 0.4564, 0.7919, 0.9354],
        [0.6068, 0.0185, 0.9218, 0.9169],
        [0.4859, 0.8214, 0.7382, 0.4102],
        [0.8912, 0.4447, 0.1762, 0.8936],
    ])
    d = np.array([0.0578, 0.3528, 0.8131, 0.0098, 0.1388])
    kwargs = dict(
        Ain=[[0.2027, 0.2721, 0.7467, 0.4659],
             [0.1987, 0.1988, 0.4450, 0.4186],
             [0.6037, 0.0152, 0.9318, 0.8462]],
        bin=[-0.5251, -0.2026, -0.6721],
        Aeq=[[3, 5, 7, 9]], beq=[-4],
        lb=[-0.1] * 4, ub=[1] * 4,
    )
    return C.T @ C, -C.T @ d, kwargs, None


def _pyecosqp_mpc_cases():
    Aeq = np.array([
        [1, 0, 0, 1, 0, 0, 0, 0, 0],
        [-2, 0, 0, 0, 1, 0, 0, 0, 0],
        [0, 1, 0, -0.8, -1, 1, 0, 0, 0],
        [0, -2, 0, 0, -0.9, 0, 1, 0, 0],
        [0, 0, 1, 0, 0, -0.8, -1, 1, 0],
        [0, 0, -2, 0, 0, 0, -0.9, 0, 1],
    ], dtype=float)
    beq = np.zeros(6)
    beq[0], beq[1] = -2.8, -1.8
    H = np.eye(9)
    c = np.zeros(9)
    Ain = np.zeros((6, 9))
    Ain[:3, :3] = np.eye(3)
    Ain[3:, :3] = -np.eye(3)
    bin = np.full(6, -0.7)
    return {
        "pyecosqp_test2": (H, c, dict(Aeq=Aeq, beq=beq), None),
        "pyecosqp_test3": (H, c, dict(Aeq=Aeq, beq=beq, Ain=Ain, bin=bin),
                           None),
    }


ALL_CASES = {
    # name: (H, c, kwargs, documented optimum or None)
    "lagrange_csdn": (
        [[4, 1], [1, 2]], [-1, -1],
        dict(Aeq=[[1, 1]], beq=[-1]),
        [0.25, 0.75],  # tests/hectr.c:39
    ),
    "matlab_linear_constraints": (
        [[1, -1], [-1, 2]], [-2, -6],
        dict(Ain=[[1, 1], [-1, 2], [2, 1]], bin=[-2, -2, -3],
             w0=[-3.0, -3.0]),
        [2.0 / 3.0, 4.0 / 3.0],
    ),
    "matlab_linear_equality": (
        [[1, -1], [-1, 2]], [-2, -6],
        dict(Aeq=[[1, 1]], beq=[0]),
        [-0.8, 0.8],
    ),
    "matlab_constraints_and_bounds": (
        [[1, -1, 1], [-1, 2, -2], [1, -2, 4]], [2, -3, 1],
        dict(Aeq=[[1, 1, 1]], beq=[-0.5], lb=[0, 0, 0], ub=[1, 1, 1]),
        [0.0, 0.5, 0.0],
    ),
    "matlab_objective_value": (
        [[1, -1, 1], [-1, 2, -2], [1, -2, 4]], [-7, -12, -15],
        dict(Ain=[[1, 1, 1]], bin=[-3]),
        None,
    ),
    "matlab_optimization_process": (
        [[2, 1, -1], [1, 3, 0.5], [-1, 0.5, 5]], [4, -7, 12],
        dict(lb=[0, 0, 0], ub=[1, 1, 1]),
        None,
    ),
    "matlab_lagrange_multipliers": (
        [[1, -1, 1], [-1, 2, -2], [1, -2, 4]], [-7, -12, -15],
        dict(Ain=[[1, 1, 1]], bin=[-3], lb=[0, 0, 0]),
        None,
    ),
    "pyecosqp_test1": (
        [[1, 0], [0, 0]], [3, 4],
        dict(Ain=[[-1, 0], [0, -1], [-1, -3], [2, 5], [3, 4]],
             bin=[0, 0, 15, -100, -80]),
        None,
    ),
    "octave": _octave_case(),
    **_pyecosqp_mpc_cases(),
}


@pytest.mark.parametrize("name", sorted(ALL_CASES))
def test_quadprog_oracle(name):
    H, c, kwargs, documented = ALL_CASES[name]
    w = quadprog(H, c, **kwargs)
    w_ref = scipy_solve(H, c, **kwargs)
    H = np.asarray(H, float)
    c = np.asarray(c, float)

    def obj(v):
        return 0.5 * v @ H @ v + c @ v

    # objective parity with scipy (the minimiser is not unique where H
    # is singular, e.g. pyecosqp_test1)
    assert obj(w) <= obj(w_ref) + 1e-6, (obj(w), obj(w_ref))
    if documented is not None:
        np.testing.assert_allclose(w, documented, atol=1e-4)
    if "Aeq" in kwargs:
        np.testing.assert_allclose(
            np.asarray(kwargs["Aeq"], float) @ w
            + np.asarray(kwargs["beq"], float), 0, atol=1e-6)
    if "Ain" in kwargs:
        assert np.all(np.asarray(kwargs["Ain"], float) @ w
                      + np.asarray(kwargs["bin"], float) <= 1e-6)
    if kwargs.get("lb") is not None:
        assert np.all(w >= np.asarray(kwargs["lb"], float) - 1e-8)
    if kwargs.get("ub") is not None:
        assert np.all(w <= np.asarray(kwargs["ub"], float) + 1e-8)
