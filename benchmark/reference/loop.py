"""The reference closed loop: measure -> Kalman update -> target selector
-> regulator -> nonlinear CSTR -> Kalman time update, on L loops at
once (upstream ctr_simulate / hectr_simulate, src/ctr.c:363-618), with
the law of the configuration's regulator form (``laws/<form>.py``).

Everything is derived here from the configuration file alone; the loop
runs in the dtype it is asked for (float64, or float32 for the control).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark import spec
from benchmark.reference import control as K
from benchmark.reference.plant import CSTR


@dataclasses.dataclass
class System:
    """The plant and every matrix the loop and the law need."""

    plant: CSTR
    xs: np.ndarray
    us: np.ndarray
    ps: np.ndarray
    dt: float
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    Bd: np.ndarray
    Cd: np.ndarray
    Hr: np.ndarray
    Lx: np.ndarray
    Ld: np.ndarray
    Ginv: np.ndarray
    K_A: np.ndarray
    K_B: np.ndarray

    @classmethod
    def from_config(cls, config: dict) -> "System":
        pc, mc, rc = config["plant"], config["model"], config["regulator"]
        plant = CSTR(pc["constants"])
        xs, us, ps = (np.asarray(pc[k], dtype=np.float64)
                      for k in ("xs", "us", "ps"))
        dt = float(pc["dt"])
        jac_b, _ = plant.input_jacobians(xs)
        A, Bint = K.c2d(plant.jacobian(xs, ps), dt)
        B = Bint @ jac_b
        C, Bd, Cd, Hr = (np.asarray(mc[k], dtype=np.float64)
                         for k in ("C", "Bd", "Cd", "Hr"))
        Lx, Ld = K.estimator_gains(A, C, Bd, Cd, xs)
        Q, R = K.weighting(xs, us)
        K_A, K_B, _ = K.mpc_gains(A, B, C, Q, R, rc["horizon"])
        return cls(plant, xs, us, ps, dt, A, B, C, Bd, Cd, Hr, Lx, Ld,
                   K.selector(A, B, C, Hr), K_A, K_B)

    def astype(self, dtype) -> "System":
        """The same system with every array in `dtype`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).astype(dtype)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)})


def closed_loop(sys: System, law, p: np.ndarray):
    """L loops, loop i driven by p[i] ([L, N, np] deviations of F0):
    (x [L, N+1, nx], u [L, N, nu]) in absolute units, in sys's dtype."""
    L, N = p.shape[:2]
    dt = sys.xs.dtype.type
    nx, nu, nd = sys.A.shape[0], sys.B.shape[1], sys.Bd.shape[1]
    x = np.zeros((L, nx), dtype=sys.xs.dtype)
    xhatm = np.zeros_like(x)
    dhatm = np.zeros((L, nd), dtype=x.dtype)
    u = np.zeros((L, nu), dtype=x.dtype)
    rsp = np.zeros((L, nu), dtype=x.dtype)
    xt, ut = [], []
    for k in range(N):
        y = x @ sys.C.T
        e = y - xhatm @ sys.C.T - dhatm @ sys.Cd.T
        xhat = xhatm + e @ sys.Lx.T
        dhat = dhatm + e @ sys.Ld.T
        pack = np.concatenate([dhat @ sys.Bd.T,
                               rsp - (dhat @ sys.Cd.T) @ sys.Hr.T], axis=-1)
        r = pack @ sys.Ginv.T
        xr, ur = r[:, :nx], r[:, nx:]
        uhat = ur if k == 0 else u
        u = law(xhat, uhat, xr, ur)
        xt.append(x)
        ut.append(u)
        x = sys.plant.actuate(x, u, p[:, k].astype(x.dtype), sys.xs, sys.us,
                              sys.ps, dt(sys.dt))
        xhatm = xhat @ sys.A.T + u @ sys.B.T + dhat @ sys.Bd.T
        dhatm = dhat
    xt.append(x)
    return np.stack(xt, axis=1) + sys.xs, np.stack(ut, axis=1) + sys.us


def reference_episodes(config: dict, pool: np.ndarray, used, dtype=np.float64):
    """The reference's closed loops for the pool episodes `used`.

    pool [P, B, N, np]: the disturbances of every episode the run may
    draw.  Returns (x [E, B, N+1, nx], u [E, B, N, nu]), the loops computed
    in `dtype` (the set-up maths in float64) under the law of the
    configuration's regulator form."""
    sys = System.from_config(config).astype(dtype)
    law = spec.law(config["regulator"]["form"]).law(sys, config)
    Bp, N = pool.shape[1:3]
    used = np.asarray(used, dtype=np.int64)
    uniq, inverse = np.unique(used, return_inverse=True)
    x, u = closed_loop(sys, law, pool[uniq].reshape(len(uniq) * Bp, N, -1))
    x = x.reshape(len(uniq), Bp, N + 1, -1)[inverse]
    u = u.reshape(len(uniq), Bp, N, -1)[inverse]
    return x, u
