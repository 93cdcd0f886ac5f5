"""Hand-written CUDA kernels for Hopper (built from csrc/ at first use)."""
