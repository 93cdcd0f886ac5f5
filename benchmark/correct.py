"""The comparison that decides ``correct``.

The port's closed loops of the window are held against the reference's
loops over the same disturbances, every episode, every plant, every step:

* ``u_rel_gap``: the widest gap of a decoded move, max |u - u_ref| / |us|
  over every step and input (us: the steady-state input, so Tc and F
  weigh alike).  It covers encode, encrypt, the gemvs, the key switch,
  the mod-down, decrypt and decode.
* ``x_rel_gap``: the widest gap of the trajectory, max |x - x_ref| / |xs|
  over every state of every step: the plant, the estimator and the
  target selector, fed by those moves.
* ``imag_canary``: the largest imaginary residue of a decode, which the
  configuration bounds (the upstream asserts < 1e-5 on every decode).

A loop-step fails where its move, the state it leads to or its
episode's canary is beyond the limit, or is not finite.  The limits are
the configuration's ``correct_limits`` and its stated canary bound.
"""

from __future__ import annotations

import numpy as np


def limits(config: dict) -> dict[str, float]:
    return {**config["correct_limits"],
            "imag_canary": config["guarantees"]["imag_canary_max"]}


def _gap(a, b, scale):
    g = np.abs(np.asarray(a) - np.asarray(b)) / np.abs(scale)
    return np.where(np.isfinite(g), g, np.inf)


def compare(config: dict, x, u, canary, x_ref, u_ref):
    """x [E, B, N+1, nx], u [E, B, N, nu], canary [E, B] of the port and
    the reference's x_ref, u_ref: (checks {name: {"value", "limit"}},
    failed loop-steps, attempted loop-steps)."""
    lim = limits(config)
    gx = _gap(x, x_ref, config["plant"]["xs"])
    gu = _gap(u, u_ref, config["plant"]["us"])
    canary = np.asarray(canary, dtype=np.float64)
    canary = np.where(np.isfinite(canary), canary, np.inf)
    values = {"u_rel_gap": float(gu.max()), "x_rel_gap": float(gx.max()),
              "imag_canary": float(canary.max())}
    bad = ((gu.max(axis=-1) > lim["u_rel_gap"])
           | (gx[..., 1:, :].max(axis=-1) > lim["x_rel_gap"])
           | (canary > lim["imag_canary"])[..., None])
    checks = {name: {"value": values[name], "limit": lim[name]}
              for name in ("u_rel_gap", "x_rel_gap", "imag_canary")}
    return checks, int(bad.sum()), int(bad.size)


def passed(checks: dict, failed: int) -> bool:
    return failed == 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())
