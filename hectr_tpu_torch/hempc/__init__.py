"""Encrypted model-predictive control: the unconstrained MPC update

    du = -(K_A (xhat - xr) + K_B (uhat - ur))      [2 encrypted gemvs]
    u  = moddown(uhat) + du

evaluated over CKKS ciphertexts (reference src/hempc.c `ctr_hempc`).
"""

from hectr_tpu_torch.hempc.regulator import (
    hempc_init_state,
    make_hempc_regulator,
)

__all__ = ["hempc_init_state", "make_hempc_regulator"]
