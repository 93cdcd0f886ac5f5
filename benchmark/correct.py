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
* the checks of the regulator form's law, where its file
  (``reference/laws/<form>.py``) defines ``checks(config, x, u)``: a
  guarantee the form adds, such as a box on the moves, as a value per
  loop-step of the port's run ({name: (values [E, B, N], limit)}), its
  limit from the configuration's ``correct_limits``.

A loop-step fails where its move, the state it leads to, its episode's
canary or one of its law's checks is beyond the limit, or is not finite.
The limits are the configuration's ``correct_limits`` and its stated
canary bound; each limit there is read by one check.
"""

from __future__ import annotations

import numpy as np

from benchmark import spec

BASE = ("u_rel_gap", "x_rel_gap", "imag_canary")


def limits(config: dict) -> dict[str, float]:
    return {**config["correct_limits"],
            "imag_canary": config["guarantees"]["imag_canary_max"]}


def _finite(v):
    return np.where(np.isfinite(v), v, np.inf)


def _gap(a, b, scale):
    return _finite(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(scale))


def law_checks(config: dict, x, u) -> dict:
    """The checks of the configuration's form's law on the port's x, u:
    {name: (values [E, B, N], limit)}; raises where one reuses a name of
    the three above or where a limit of ``correct_limits`` has no check."""
    form = config["regulator"]["form"]
    law = spec.law(form)
    named = law.checks(config, x, u) if hasattr(law, "checks") else {}
    if set(named) & set(BASE):
        raise ValueError(f"regulator form {form!r}: its checks "
                         f"{sorted(set(named) & set(BASE))} take the "
                         f"comparison's own names")
    unread = set(config["correct_limits"]) - set(BASE) - set(named)
    if unread:
        raise ValueError(f"regulator form {form!r}: no check reads the "
                         f"limits {sorted(unread)}")
    return named


def compare(config: dict, x, u, canary, x_ref, u_ref):
    """x [E, B, N+1, nx], u [E, B, N, nu], canary [E, B] of the port and
    the reference's x_ref, u_ref: (checks {name: {"value", "limit"}},
    failed loop-steps, attempted loop-steps)."""
    lim = limits(config)
    gx = _gap(x, x_ref, config["plant"]["xs"])
    gu = _gap(u, u_ref, config["plant"]["us"])
    canary = _finite(np.asarray(canary, dtype=np.float64))
    values = {"u_rel_gap": float(gu.max()), "x_rel_gap": float(gx.max()),
              "imag_canary": float(canary.max())}
    bad = ((gu.max(axis=-1) > lim["u_rel_gap"])
           | (gx[..., 1:, :].max(axis=-1) > lim["x_rel_gap"])
           | (canary > lim["imag_canary"])[..., None])
    for name, (v, limit) in law_checks(config, x, u).items():
        v = _finite(np.asarray(v, dtype=np.float64)).reshape(bad.shape)
        values[name], lim[name] = float(v.max()), limit
        bad |= v > limit
    checks = {name: {"value": values[name], "limit": lim[name]}
              for name in values}
    return checks, int(bad.sum()), int(bad.size)


def passed(checks: dict, failed: int) -> bool:
    return failed == 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())
