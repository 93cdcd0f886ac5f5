"""CKKS canonical-embedding encode/decode (any slot count up to N/2).

For s slots the encoded polynomial is sparse -- m(X) = m'(X^{N/2s}) with
m' in the 2s-dimensional subring Z[Y]/(Y^{2s}+1) -- so encode/decode
only need the subring's canonical embedding, evaluated two ways behind
one interface, as in ``hectr_tpu/ckks/encoding.py``:

  * s <= MATRIX_MAX_SLOTS: an [s, 2s] float64 matrix transform;
  * larger s (up to N/2): an O(s log s) complex negacyclic FFT on
    (re, im) float64 pairs, with the modular NTT's merged-psi butterfly
    structure and evaluation-point indexing e_i = 2*bitreverse(i)+1,
    psi = exp(i*pi/2s).  Slot i sits at the evaluation index holding
    exponent 5^i mod 4s and its conjugate partner at -5^i mod 4s, which
    makes the inverse transform land on real coefficients.

Both branches take any leading batch dimensions ([..., s] -> [..., 2s]),
and each row of a batch gets exactly the 1-D result: the FFT is
elementwise per stage, in the JAX package's float64 operation order, and
the matrix branch multiplies row by row.  Tables are cached per
(size, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hectr_tpu_torch.ckks.ntt import bit_reverse_indices
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
    ReE, ImE = embedding_matrices(slots)
    return (torch.from_numpy(ReE).to(device), torch.from_numpy(ImE).to(device))


# ---------------------------------------------------------------------------
# complex negacyclic FFT (large slot counts)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def cfft_tables(n2: int) -> tuple[np.ndarray, ...]:
    """Merged-psi twiddles of the length-n2 complex negacyclic transform,
    psi = exp(i*pi/n2): (cos, sin) of psi^{brv(i)} and of psi^{-brv(i)},
    each [n2] float64 (the modular NTT's psi_rev layout)."""
    ang = np.pi * bit_reverse_indices(n2) / n2
    return np.cos(ang), np.sin(ang), np.cos(ang), -np.sin(ang)


@functools.lru_cache(maxsize=None)
def _device_cfft_tables(n2: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in cfft_tables(n2))


@functools.lru_cache(maxsize=None)
def slot_indices(slots: int) -> tuple[np.ndarray, np.ndarray]:
    """(pos, cpos): evaluation-point index of slot i (exponent 5^i mod
    4s) and of its conjugate partner (exponent -5^i mod 4s) in the
    length-2s negacyclic transform output.  Together they cover every
    index exactly once."""
    n2 = 2 * slots
    e = (2 * bit_reverse_indices(n2) + 1) % (2 * n2)
    where = {int(exp): i for i, exp in enumerate(e)}
    pos = np.empty(slots, dtype=np.int64)
    cpos = np.empty(slots, dtype=np.int64)
    g = 1
    for i in range(slots):
        pos[i] = where[g]
        cpos[i] = where[(2 * n2 - g) % (2 * n2)]
        g = (g * 5) % (2 * n2)
    return pos, cpos


@functools.lru_cache(maxsize=None)
def _device_slot_indices(slots: int, device: torch.device):
    pos, cpos = slot_indices(slots)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(np.concatenate([pos, cpos])).to(device))


def cfft_fwd(re: torch.Tensor, im: torch.Tensor, n2: int):
    """Forward complex negacyclic FFT over the last axis (CT, natural ->
    bit-reversed evaluation order), ntt_plain's stage loop on float64
    pairs."""
    cr, ci, _, _ = _device_cfft_tables(n2, resolve_device(re.device))
    lead = re.shape[:-1]
    half, m = n2, 1
    while m < n2:
        half //= 2
        xr = re.reshape(*lead, m, 2 * half)
        xi = im.reshape(*lead, m, 2 * half)
        ur, vr = xr[..., :half], xr[..., half:]
        ui, vi = xi[..., :half], xi[..., half:]
        sr = cr[m:2 * m, None]
        si = ci[m:2 * m, None]
        tr = vr * sr - vi * si
        ti = vr * si + vi * sr
        re = torch.cat([ur + tr, ur - tr], dim=-1).reshape(*lead, n2)
        im = torch.cat([ui + ti, ui - ti], dim=-1).reshape(*lead, n2)
        m *= 2
    return re, im


def cfft_inv(re: torch.Tensor, im: torch.Tensor, n2: int):
    """Inverse (GS, bit-reversed -> natural) over the last axis, scaled
    by 1/n2."""
    _, _, cr, ci = _device_cfft_tables(n2, resolve_device(re.device))
    lead = re.shape[:-1]
    half, m = 1, n2
    while m > 1:
        h = m // 2
        xr = re.reshape(*lead, h, 2 * half)
        xi = im.reshape(*lead, h, 2 * half)
        ur, vr = xr[..., :half], xr[..., half:]
        ui, vi = xi[..., :half], xi[..., half:]
        sr = cr[h:2 * h, None]
        si = ci[h:2 * h, None]
        dr, di = ur - vr, ui - vi
        re = torch.cat([ur + vr, dr * sr - di * si], dim=-1).reshape(*lead, n2)
        im = torch.cat([ui + vi, dr * si + di * sr], dim=-1).reshape(*lead, n2)
        half *= 2
        m = h
    return re / n2, im / n2


# ---------------------------------------------------------------------------
# public embedding API
# ---------------------------------------------------------------------------


def _rows(fn, x: torch.Tensor, *more: torch.Tensor):
    """Apply a 1-D function row by row over the leading dimensions."""
    if x.dim() == 1:
        return fn(x, *more)
    lead = x.shape[:-1]
    flat = [t.reshape(-1, t.shape[-1]) for t in (x, *more)]
    out = [fn(*row) for row in zip(*flat)]
    if isinstance(out[0], tuple):
        return tuple(torch.stack(o).reshape(*lead, -1) for o in zip(*out))
    return torch.stack(out).reshape(*lead, -1)


def embed_ri(vre: torch.Tensor, vim: torch.Tensor, slots: int) -> torch.Tensor:
    """Slot values (re, im) float64 [..., s] -> real subring coefficients
    m' [..., 2s] (unscaled)."""
    device = resolve_device(vre.device)
    if slots <= MATRIX_MAX_SLOTS:
        ReE, ImE = _device_embedding(slots, device)
        return _rows(lambda r, i: (ReE.T @ r + ImE.T @ i) / slots, vre, vim)
    n2 = 2 * slots
    _, both = _device_slot_indices(slots, device)
    # slot i at pos[i] and its conjugate at cpos[i]: one scatter over
    # the permutation (pos, cpos)
    z = torch.zeros((*vre.shape[:-1], n2), dtype=torch.float64, device=device)
    wre = z.index_copy(-1, both, torch.cat([vre, vre], dim=-1))
    wim = z.index_copy(-1, both, torch.cat([vim, -vim], dim=-1))
    mre, _ = cfft_inv(wre, wim, n2)   # imaginary part is ~0 by symmetry
    return mre


def embed(v, slots: int) -> torch.Tensor:
    """Complex slot values (numpy array or complex tensor) [..., s] ->
    real subring coefficients [..., 2s]; a numpy array embeds on the
    CPU, a tensor on its device."""
    v = complex_tensor(v)
    return embed_ri(v.real, v.imag, slots)


def complex_tensor(v) -> torch.Tensor:
    """A complex128 tensor of v: a tensor stays on its device, anything
    else (numpy, lists) goes to the CPU."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.complex128))
    return v.to(torch.complex128)


def unembed(m: torch.Tensor, slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Real subring coefficients m' [..., 2s] -> slot values (re, im)
    [..., s]."""
    device = resolve_device(m.device)
    if slots <= MATRIX_MAX_SLOTS:
        ReE, ImE = _device_embedding(slots, device)
        return _rows(lambda x: (ReE @ x, ImE @ x), m)
    pos, _ = _device_slot_indices(slots, device)
    fre, fim = cfft_fwd(m, torch.zeros_like(m), 2 * slots)
    return fre.index_select(-1, pos), fim.index_select(-1, pos)


def integer_residues(y: torch.Tensor, primes_col: torch.Tensor) -> torch.Tensor:
    """Exact residues of integer-valued float64 y [..., M] (|y| < 2^60)
    mod each prime (primes_col int64 [K, 1]) -> int64 [..., K, M].

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
    a1 = a1.to(torch.int64)[..., None, :]
    a2 = a2.to(torch.int64)[..., None, :]
    a3 = a3.to(torch.int64)[..., None, :]
    p = primes_col
    c54 = torch.remainder(torch.full_like(p, 1 << 54), p)
    c27 = torch.remainder(torch.full_like(p, 1 << 27), p)
    # a1 < 2^6, a2 < 2^27, c < 2^30: every product and the sum < 2^61
    r = torch.remainder(a1 * c54 + torch.remainder(a2 * c27, p) + a3, p)
    return torch.where(sign_neg[..., None, :] & (r != 0), p - r, r)
