"""Carry keys and ciphertexts across from the JAX package.

The JAX package holds residues as uint32 arrays; given as numpy, these
functions turn them into the port's int64 objects on a device, and turn
the port's tensors back into uint32 numpy.  Tests use them to run the
port on the reference's own keys.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from hectr_tpu_torch.ckks.scheme import Ciphertext, KeySet, Plaintext


def residues(a, device) -> torch.Tensor:
    """uint32 residues (any array-like) -> int64 tensor on `device`."""
    a = np.asarray(a)
    if a.dtype != np.uint32:
        raise TypeError(f"expected uint32 residues, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int64 residue tensor -> uint32 numpy (values must be < 2^32)."""
    a = t.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= 1 << 32):
        raise ValueError("residues outside [0, 2^32)")
    return a.astype(np.uint32)


def keyset(sk, pk, device) -> KeySet:
    return KeySet(sk=residues(sk, device), pk=residues(pk, device))


def rotation_keys(keys: dict, device) -> dict[int, torch.Tensor]:
    """{r: uint32 [dnum, 4, K+S, N]} -> {r: int64 tensor}."""
    return {int(r): residues(k, device) for r, k in keys.items()}


def ciphertext(data, scale: Fraction, device) -> Ciphertext:
    return Ciphertext(data=residues(data, device), scale=Fraction(scale))


def plaintext(data, scale: Fraction, device) -> Plaintext:
    return Plaintext(data=residues(data, device), scale=Fraction(scale))
