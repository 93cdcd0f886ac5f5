"""Plant models: pure (ode, jacobian) functions plus steady-state
offsets."""

from hectr_tpu_torch.control.plants.cstr import (
    CSTR_STEADY_STATE,
    cstr_jacobian,
    cstr_linearize,
    cstr_ode,
)

__all__ = [
    "CSTR_STEADY_STATE",
    "cstr_ode",
    "cstr_jacobian",
    "cstr_linearize",
]
