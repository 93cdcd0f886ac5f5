"""Fixed-step ODE integrators on float64 tensors.

Capabilities of reference src/ode.c, as ``hectr_tpu/control/ode.py``:
`ode45` is a classic fixed-step RK4 (src/ode.c:25-63); `ode15s` is a
one-step linearly-implicit stiff update x' = x + dt*(I - dt*J)^-1 f(x)
(src/ode.c:65-95).  The golden trajectories depend on these exact
schemes.
"""

from __future__ import annotations

import torch


def rk4_step(f, x, u, p, dt):
    """One classic 4th-order Runge-Kutta step of x' = f(x, u, p)."""
    k1 = dt * f(x, u, p)
    k2 = dt * f(x + k1 / 2, u, p)
    k3 = dt * f(x + k2 / 2, u, p)
    k4 = dt * f(x + k3, u, p)
    return x + (k1 + 2 * k2 + 2 * k3 + k4) / 6


def stiff_step(f, jac, x, u, p, dt):
    """One linearly-implicit stiff step: x + dt * (I - dt*J)^-1 f(x).
    x [..., n] with J [..., n, n]: one batched solve for a batch of
    states.  On the CPU it is LAPACK's LU solve (``solve_ex``, which
    checks nothing), each row bit-equal to its own solve; on the card it
    is ``solve_pivoted``, which calls no library solver: it neither reads
    a status back to the host nor takes a workspace, so the closed loop
    captures it into a CUDA graph (``control.simulate``)."""
    n = x.shape[-1]
    A = torch.eye(n, dtype=x.dtype, device=x.device) - dt * jac(x, u, p)
    b = f(x, u, p)
    if x.device.type == "cpu":
        return x + dt * torch.linalg.solve_ex(A, b)[0]
    return x + dt * solve_pivoted(A, b)


def solve_pivoted(A, b):
    """x with A x = b, for A [..., n, n] and b [..., n], by Gaussian
    elimination with partial pivoting in elementwise tensor ops: column
    j's pivot is the remaining row of largest magnitude there (argmax),
    swapped in by ``torch.where``; then back substitution.  A singular A
    gives inf or nan, unchecked, as ``torch.linalg.solve_ex`` does."""
    n = A.shape[-1]
    rest = torch.cat([A, b.unsqueeze(-1)], dim=-1)   # [..., n - j, n - j + 1]
    rows = torch.arange(n, device=A.device)
    pivots = []                   # row j: u_jj, ..., u_j(n-1), then c_j
    for j in range(n - 1):
        p = rest[..., 0].abs().argmax(-1, keepdim=True)
        pivot = rest.take_along_dim(p.unsqueeze(-1), dim=-2)
        # the other rows, the first row in the pivot's place
        others = torch.where((rows[1:n - j] == p).unsqueeze(-1),
                             rest[..., :1, :], rest[..., 1:, :])
        factor = others[..., :1] / pivot[..., :1]
        rest = others[..., 1:] - factor * pivot[..., 1:]
        pivots.append(pivot[..., 0, :])
    pivots.append(rest[..., 0, :])
    x = [None] * n
    for j in reversed(range(n)):
        row = pivots[j]
        s = row[..., -1]
        for i in range(j + 1, n):
            s = s - row[..., i - j] * x[i]
        x[j] = s / row[..., 0]
    return torch.stack(x, dim=-1)
