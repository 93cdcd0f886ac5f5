"""CKKS canonical-embedding encode/decode, matrix branch (slots <= 64).

For s slots the encoded polynomial is sparse -- m(X) = m'(X^{N/2s}) with
m' in the 2s-dimensional subring -- so encode/decode only need the
subring's canonical embedding, here an [s, 2s] matrix transform in
float64 (``hectr_tpu/ckks/encoding.py`` matrix branch).  The FFT branch
for larger slot counts is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hectr_tpu_torch.config import resolve_device

MATRIX_MAX_SLOTS = 64


@functools.lru_cache(maxsize=None)
def embedding_matrices(slots: int) -> tuple[np.ndarray, np.ndarray]:
    """(ReE, ImE), each [s, 2s]: E[i, j] = omega^{g_i j}."""
    s = slots
    g = 1
    gs = []
    for _ in range(s):
        gs.append(g)
        g = (g * 5) % (4 * s)
    j = np.arange(2 * s)
    ang = 2.0 * np.pi * np.outer(np.array(gs), j) / (4.0 * s)
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def _device_embedding(slots: int, device: torch.device):
    if slots > MATRIX_MAX_SLOTS:
        raise NotImplementedError(
            f"slots={slots}: only the matrix embedding (slots <= "
            f"{MATRIX_MAX_SLOTS}) is ported")
    ReE, ImE = embedding_matrices(slots)
    return (torch.from_numpy(ReE).to(device), torch.from_numpy(ImE).to(device))


def embed_ri(vre: torch.Tensor, vim: torch.Tensor, slots: int) -> torch.Tensor:
    """Slot values (re, im)[s] float64 -> real subring coefficients
    m'[2s] (unscaled)."""
    ReE, ImE = _device_embedding(slots, resolve_device(vre.device))
    return (ReE.T @ vre + ImE.T @ vim) / slots


def unembed(m: torch.Tensor, slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Real subring coefficients m'[2s] -> slot values (re[s], im[s])."""
    ReE, ImE = _device_embedding(slots, resolve_device(m.device))
    return ReE @ m, ImE @ m


def integer_residues(y: torch.Tensor, primes_col: torch.Tensor) -> torch.Tensor:
    """Exact residues of integer-valued float64 y (|y| < 2^60) mod each
    prime (primes_col int64 [K, 1]) -> int64 [K, len(y)].

    The three-way exact split y = a1*2^54 + a2*2^27 + a3 keeps every
    conversion and product exact (float64 cannot hold 2^54-magnitude
    integers at unit precision, so the folding is piecewise), in the
    reference's operation order.
    """
    sign_neg = y < 0
    a = torch.abs(y)
    a1 = torch.floor(a / 2.0**54)
    r1 = a - a1 * 2.0**54
    a2 = torch.floor(r1 / 2.0**27)
    a3 = r1 - a2 * 2.0**27
    a1 = a1.to(torch.int64)[None, :]
    a2 = a2.to(torch.int64)[None, :]
    a3 = a3.to(torch.int64)[None, :]
    p = primes_col
    c54 = torch.remainder(torch.full_like(p, 1 << 54), p)
    c27 = torch.remainder(torch.full_like(p, 1 << 27), p)
    # a1 < 2^6, a2 < 2^27, c < 2^30: every product and the sum < 2^61
    r = torch.remainder(a1 * c54 + torch.remainder(a2 * c27, p) + a3, p)
    return torch.where(sign_neg[None, :] & (r != 0), p - r, r)
