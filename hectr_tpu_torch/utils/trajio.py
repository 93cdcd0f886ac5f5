"""Trajectory serialisation in the reference's formats.

The reference persists each closed-loop run as
  results/<name>.txt : "%2u %13g x5" rows (tests/hectr.c:746-750)
  results/<name>.bin : records of (uint32 k, nx f8 states, nu f8
                       controls) (tests/hectr.c:751-757)
and the differential artifact cstr-cmp.bin holds per-step absolute
deviations (tests/hectr.c:821-847).  These functions read and write
byte-compatible files so our outputs diff directly against the
committed goldens.
"""

from __future__ import annotations

import struct

import numpy as np


def write_traj_txt(path, x: np.ndarray, u: np.ndarray) -> None:
    """x [N+1, nx], u [N, nu]; last control row repeated at k=N."""
    n_steps = x.shape[0]
    with open(path, "w") as f:
        for k in range(n_steps):
            uk = u[min(k, u.shape[0] - 1)]
            vals = " ".join(f"{v:13g}" for v in (*x[k], *uk))
            f.write(f"{k:2d} {vals}\n")


def write_traj_bin(path, x: np.ndarray, u: np.ndarray) -> None:
    nx = x.shape[1]
    nu = u.shape[1]
    with open(path, "wb") as f:
        for k in range(x.shape[0]):
            uk = u[min(k, u.shape[0] - 1)]
            f.write(struct.pack("<I", k))
            f.write(np.asarray(x[k], dtype="<f8").tobytes())
            f.write(np.asarray(uk, dtype="<f8").tobytes())


def read_traj_bin(path, nx: int = 3, nu: int = 2) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    rec = 4 + 8 * (nx + nu)
    if len(raw) % rec:
        raise ValueError(f"{path}: {len(raw)} bytes is not a whole number "
                         f"of {rec}-byte records")
    xs, us = [], []
    for off in range(0, len(raw), rec):
        vals = np.frombuffer(raw, dtype="<f8", count=nx + nu, offset=off + 4)
        xs.append(vals[:nx])
        us.append(vals[nx:])
    return np.array(xs), np.array(us)


def traj_compare(path_a, path_b, out_path=None, nx: int = 3, nu: int = 2
                 ) -> np.ndarray:
    """Per-step absolute deviations |a - b| (the cstr-cmp capability,
    tests/hectr.c:821-847).  Optionally writes the .bin artifact."""
    xa, ua = read_traj_bin(path_a, nx, nu)
    xb, ub = read_traj_bin(path_b, nx, nu)
    diff = np.hstack([np.abs(xa - xb), np.abs(ua - ub)])
    if out_path:
        write_traj_bin(out_path, diff[:, :nx], diff[:, nx:])
    return diff
