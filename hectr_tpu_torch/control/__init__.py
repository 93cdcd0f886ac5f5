"""Control toolbox: setup-time NumPy (linalg, riccati, qp, mpc) and the
per-step float64 tensor code (ode, plants, stages, simulate)."""
