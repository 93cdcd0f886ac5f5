"""Matplotlib equivalents of the reference's gnuplot render scripts.

The reference shells out to gnuplot after every test run
(tests/hectr.c:944-969; scripts in tests/results/*.gp rendering
epslatex -> PDF).  Capabilities reproduced: closed-loop trajectory
panels (cstr-mpc.gp / cstr-hempc.gp), the log-axis differential plot
(cstr-cmp.gp), integrator comparison (cstr-ode.gp), and tracking plots
(mpc-tracking.gp).

The port of ``hectr_tpu/utils/plotting.py``: host numpy in, PDF out.
matplotlib is imported on first use, so nothing else needs it.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


CSTR_LABELS = ["c (kmol/m^3)", "T (K)", "h (m)", "Tc (K)", "F (m^3/min)"]


def plot_closed_loop(x: np.ndarray, u: np.ndarray, path, title=""):
    """5-panel state/control trajectory (cstr-mpc.gp parity)."""
    plt = _plt()
    cols = np.hstack([x, np.vstack([u, u[-1:]])])
    fig, axes = plt.subplots(5, 1, figsize=(7, 11), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(cols[:, i], lw=1.5)
        ax.set_ylabel(CSTR_LABELS[i])
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("step (min)")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_differential(diff: np.ndarray, path):
    """Log-axis per-channel |plaintext - encrypted| (cstr-cmp.gp
    parity)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for i, lab in enumerate(CSTR_LABELS):
        ax.semilogy(np.maximum(diff[:, i], 1e-18), label=lab, lw=1.2)
    ax.set_xlabel("step")
    ax.set_ylabel("|plaintext - encrypted|")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_integrators(rows: np.ndarray, path):
    """RK4 vs stiff-step open-loop comparison (cstr-ode.gp parity).
    rows: [t, c_rk4, T_rk4, c_stiff, T_stiff]."""
    plt = _plt()
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(7, 6), sharex=True)
    a1.plot(rows[:, 0], rows[:, 1], "o-", label="RK4")
    a1.plot(rows[:, 0], rows[:, 3], "s-", label="stiff")
    a1.set_ylabel("c (kmol/m^3)")
    a2.plot(rows[:, 0], rows[:, 2], "o-", label="RK4")
    a2.plot(rows[:, 0], rows[:, 4], "s-", label="stiff")
    a2.set_ylabel("T (K)")
    a2.set_xlabel("t (min)")
    for a in (a1, a2):
        a.grid(True, alpha=0.3)
        a.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_tracking(u: np.ndarray, y: np.ndarray, path, title=""):
    """Control + outputs for the tracking demos (mpc-tracking.gp
    parity)."""
    plt = _plt()
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(7, 6), sharex=True)
    a1.step(np.arange(len(u)), u, where="post")
    a1.set_ylabel("u")
    a2.plot(y[:, 0], label="y0")
    a2.plot(y[:, 1], label="y1")
    a2.set_ylabel("y")
    a2.set_xlabel("step")
    for a in (a1, a2):
        a.grid(True, alpha=0.3)
    a2.legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
