"""Global constants and named CKKS parameter presets.

The same presets as the JAX package (``hectr_tpu/config.py``): the
prime chains, and so every residue, depend on them, so the two
packages must agree field for field.
"""

from __future__ import annotations

import dataclasses

import torch

# Algorithm constants (reference: src/hectr.h:39-41).
TOLERANCE = 1e-10   # DARE / QP convergence tolerance  (HECTR_TOLERANCE)
SMALL = 1e-5        # noise weights, imag-residue canary (HECTR_SMALL)
ITER_MAX = 10000    # DARE / QP iteration cap           (HECTR_ITER_MAX)

# Single-precision epsilon: the reference's active-set QP uses
# FLT_EPSILON for feasibility / working-set thresholds (src/quadprog.c).
FLT_EPSILON = 1.1920928955078125e-07


@dataclasses.dataclass(frozen=True)
class CKKSPreset:
    """Named CKKS parameter preset."""

    name: str
    logn: int               # ring degree N = 2**logn
    slots: int              # packed complex slots (<= N/2)
    scale_bits: int         # log2(Delta)
    limb_bits: int          # target RNS prime size (< 31)
    mult_depth: int         # supported ct levels (in *rescale groups*)
    special_limbs: int = 1  # key-switch special primes (ns)
    digit_width: int = 1    # key-switch digit group width in limbs


# The reference encrypted-MPC parameters: logn=12, Delta=2^50, slots=16
# (src/ctr.c:511-518), realised as a chain of ~25-bit primes with
# composite (two-prime) rescaling.
REFERENCE_HEMPC = CKKSPreset(
    name="reference-hempc", logn=12, slots=16, scale_bits=50,
    limb_bits=25, mult_depth=1,
)

# Full packing (8192 slots) with enc/dec + ct-ct mult/rescale at
# logN=14: 12 data limbs (2 base + 5 scale pairs), two specials and
# width-2 digit groups (6 digits at full depth).
MEDIUM = CKKSPreset(
    name="medium", logn=14, slots=8192, scale_bits=50,
    limb_bits=25, mult_depth=5, special_limbs=2, digit_width=2,
)

# The reference parameters at logN=13, which clears the HE standard's
# 128-bit table for this chain.
REFERENCE_HEMPC_SECURE = CKKSPreset(
    name="reference-hempc-secure", logn=13, slots=16, scale_bits=50,
    limb_bits=25, mult_depth=1,
)

# The deployment-scale ring: encrypted MPC at logN=15, 20 scale limbs.
FLAGSHIP = CKKSPreset(
    name="flagship", logn=15, slots=16, scale_bits=50,
    limb_bits=25, mult_depth=10, special_limbs=2, digit_width=2,
)

# Constrained-MPC flagship: 5 more rescale levels for the encrypted QP.
FLAGSHIP_QP = CKKSPreset(
    name="flagship-qp", logn=15, slots=16, scale_bits=50,
    limb_bits=25, mult_depth=15, special_limbs=2, digit_width=2,
)

PRESETS = {p.name: p for p in (REFERENCE_HEMPC, REFERENCE_HEMPC_SECURE,
                               MEDIUM, FLAGSHIP, FLAGSHIP_QP)}


def resolve_device(device) -> torch.device:
    """A torch.device with its index filled in, so that per-device
    caches key ``"cuda"`` and ``"cuda:0"`` alike (a tensor's ``.device``
    always carries the index)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
