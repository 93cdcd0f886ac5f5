"""Fast RNS base conversion (exact centered CRT with float correction).

The workhorse of hybrid key switching, as ``hectr_tpu/ckks/basecvt.py``.
Given residues x_i = [d]_{q_i} of a centered value d, Q = prod q_i:

    y_i = [x_i * (Q/q_i)^{-1}]_{q_i}                  (per-limb Shoup mul)
    d   = sum_i y_i * (Q/q_i)  -  v * Q,  v = round(sum_i y_i / q_i)
    [d]_{p_t} = sum_i y_i * [(Q/q_i)]_{p_t} - v * [Q]_{p_t}   (mod p_t)

The float64 correction v is summed in the reference's order (left to
right over i): another order can flip v by one, which keeps d correct
mod every source prime but changes the key-switch noise, and with it
bit equality.  Residues are int64 [..., g, N] tensors; constants are
cached per (primes, device).

Dispatch is by the tensor's device, as in ``ckks.ntt``: a CUDA tensor goes
to the hand-written kernel K6 (``hectr_tpu_torch.ops.keyswitch_cuda``),
which raises on what it does not take; a CPU tensor to the plain version
below, the reference the kernel is held to.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hectr_tpu_torch.ckks.modmath import (
    add_mod_plain,
    barrett_constants,
    i64,
    mul_mod_plain,
    mul_mod_shoup_plain,
    mul_mod_shoup_wide_plain,
    shoup,
    sub_mod_plain,
)
from hectr_tpu_torch.config import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class BaseConvConstants:
    """Constants for one (from_primes -> to_primes) conversion."""

    g: int                      # source limb count
    t: int                      # target limb count
    q_col: torch.Tensor         # [g, 1] int64 source primes
    inv: torch.Tensor           # [g, 1] int64 (Q/q_i)^-1 mod q_i
    inv_shoup: torch.Tensor     # [g, 1] int64
    q_f64: torch.Tensor         # [g, 1] float64 source primes
    M: torch.Tensor             # [g, t, 1] int64 (Q/q_i) mod p_t
    M_shoup: torch.Tensor       # [g, t, 1] int64 floor(M * 2^32 / p_t)
    Qmod: torch.Tensor          # [t, 1] int64 Q mod p_t
    Qmod_shoup: torch.Tensor    # [t, 1] int64 floor(Qmod * 2^32 / p_t)
    p: torch.Tensor             # [t, 1] int64 target primes
    mu: torch.Tensor            # [t, 1] int64 Barrett mu
    k: torch.Tensor             # [t, 1] int64 Barrett shift


def base_conv_constants(from_primes, to_primes, device) -> BaseConvConstants:
    return _base_conv_constants(tuple(from_primes), tuple(to_primes),
                                resolve_device(device))


@functools.lru_cache(maxsize=None)
def _base_conv_constants(from_primes: tuple[int, ...],
                         to_primes: tuple[int, ...],
                         device: torch.device) -> BaseConvConstants:
    g, t = len(from_primes), len(to_primes)
    Q = 1
    for q in from_primes:
        Q *= q
    inv = np.array([pow((Q // q) % q, -1, q) for q in from_primes],
                   dtype=np.int64).reshape(g, 1)
    q_col = np.array(from_primes, dtype=np.int64).reshape(g, 1)
    M = np.empty((g, t, 1), dtype=np.int64)
    M_shoup = np.empty((g, t, 1), dtype=np.int64)
    for i, q in enumerate(from_primes):
        Qi = Q // q
        for j, p in enumerate(to_primes):
            M[i, j, 0] = Qi % p
            M_shoup[i, j, 0] = ((Qi % p) << 32) // p
    Qmod = np.array([Q % p for p in to_primes], dtype=np.int64).reshape(t, 1)
    p, mu, k = barrett_constants(list(to_primes))
    return BaseConvConstants(
        g=g, t=t, q_col=i64(q_col, device), inv=i64(inv, device),
        inv_shoup=i64(shoup(inv, q_col), device),
        q_f64=torch.from_numpy(q_col.astype(np.float64)).to(device),
        M=i64(M, device), M_shoup=i64(M_shoup, device),
        Qmod=i64(Qmod, device), Qmod_shoup=i64(shoup(Qmod, p), device),
        p=i64(p, device), mu=i64(mu, device), k=i64(k, device))


@dataclasses.dataclass(frozen=True, eq=False)
class GroupedConvConstants:
    """Constants for converting dnum digit groups (each a width-alpha
    slice of the data chain, the last possibly truncated and padded
    with inert dummy limbs) to one common target chain."""

    dnum: int
    alpha: int
    t: int
    q_col: torch.Tensor     # [dnum, alpha, 1] int64 (dummy rows = 1)
    inv: torch.Tensor       # [dnum, alpha, 1] int64 (dummy rows = 0)
    inv_shoup: torch.Tensor
    q_f64: torch.Tensor     # [dnum, alpha, 1] float64
    M: torch.Tensor         # [dnum, alpha, t, 1] int64 (Q_j/q_i) mod p_t
    M_shoup: torch.Tensor   # [dnum, alpha, t, 1] int64
    Qmod: torch.Tensor      # [dnum, t, 1] int64 Q_j mod p_t
    Qmod_shoup: torch.Tensor  # [dnum, t, 1] int64 (K6's correction)
    p: torch.Tensor         # [t, 1] int64
    mu: torch.Tensor
    k: torch.Tensor


def grouped_conv_constants(groups, to_primes, device) -> GroupedConvConstants:
    return _grouped_conv_constants(tuple(tuple(g) for g in groups),
                                   tuple(to_primes), resolve_device(device))


@functools.lru_cache(maxsize=None)
def _grouped_conv_constants(groups: tuple[tuple[int, ...], ...],
                            to_primes: tuple[int, ...],
                            device: torch.device) -> GroupedConvConstants:
    dnum = len(groups)
    alpha = max(len(g) for g in groups)
    t = len(to_primes)
    q_col = np.ones((dnum, alpha, 1), dtype=np.int64)
    inv = np.zeros((dnum, alpha, 1), dtype=np.int64)
    M = np.zeros((dnum, alpha, t, 1), dtype=np.int64)
    M_shoup = np.zeros((dnum, alpha, t, 1), dtype=np.int64)
    Qmod = np.empty((dnum, t, 1), dtype=np.int64)
    for j, grp in enumerate(groups):
        Qj = 1
        for q in grp:
            Qj *= q
        for i, q in enumerate(grp):
            q_col[j, i, 0] = q
            inv[j, i, 0] = pow((Qj // q) % q, -1, q)
            Qi = Qj // q
            for tt, p in enumerate(to_primes):
                M[j, i, tt, 0] = Qi % p
                M_shoup[j, i, tt, 0] = ((Qi % p) << 32) // p
        for tt, p in enumerate(to_primes):
            Qmod[j, tt, 0] = Qj % p
    p, mu, k = barrett_constants(list(to_primes))
    return GroupedConvConstants(
        dnum=dnum, alpha=alpha, t=t, q_col=i64(q_col, device),
        inv=i64(inv, device), inv_shoup=i64(shoup(inv, q_col), device),
        q_f64=torch.from_numpy(q_col.astype(np.float64)).to(device),
        M=i64(M, device), M_shoup=i64(M_shoup, device),
        Qmod=i64(Qmod, device), Qmod_shoup=i64(shoup(Qmod, p), device),
        p=i64(p, device), mu=i64(mu, device), k=i64(k, device))


def _require_cpu(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(f"no base conversion for device {x.device}")


def _correction(y: torch.Tensor, q_f64: torch.Tensor) -> torch.Tensor:
    """v = round(sum_i y_i / q_i) over dim -2, summed left to right."""
    r = y.to(torch.float64) / q_f64
    s = r.select(-2, 0)
    for i in range(1, r.shape[-2]):
        s = s + r.select(-2, i)
    return torch.round(s).to(torch.int64)


def grouped_convert(x: torch.Tensor, c: GroupedConvConstants) -> torch.Tensor:
    """Grouped residues [..., dnum, alpha, N] (dummy rows zero) ->
    centered per-group values' residues over the target chain
    [..., dnum, t, N]; leading dims are independent rows.  K6 for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        from hectr_tpu_torch.ops.keyswitch_cuda import base_convert_cuda

        return base_convert_cuda(x.contiguous(), c, grouped=True)
    _require_cpu(x)
    return grouped_convert_plain(x, c)


def grouped_convert_plain(x: torch.Tensor, c: GroupedConvConstants
                          ) -> torch.Tensor:
    """``grouped_convert`` in plain PyTorch ops."""
    y = mul_mod_shoup_plain(x, c.inv, c.inv_shoup, c.q_col)  # [.., dnum, alpha, N]
    v = _correction(y, c.q_f64)                          # [..., dnum, N]
    acc = torch.zeros((*x.shape[:-2], c.t, x.shape[-1]), dtype=torch.int64,
                      device=x.device)
    for i in range(c.alpha):
        # y_i is a residue of q_i, NOT reduced mod p_t: wide Shoup
        term = mul_mod_shoup_wide_plain(y[..., i, None, :], c.M[:, i],
                                        c.M_shoup[:, i], c.p)  # [.., dnum, t, N]
        acc = add_mod_plain(acc, term, c.p)
    corr = mul_mod_plain(v[..., None, :], c.Qmod, c.p, c.mu, c.k)
    return sub_mod_plain(acc, corr, c.p)


def base_convert(x: torch.Tensor, c: BaseConvConstants) -> torch.Tensor:
    """Residues [..., g, N] over from_primes -> centered-value residues
    [..., t, N] over to_primes (coefficient domain in and out).  K6 (its
    one-group form) for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.device.type == "cuda":
        from hectr_tpu_torch.ops.keyswitch_cuda import base_convert_cuda

        return base_convert_cuda(x.contiguous(), c, grouped=False)
    _require_cpu(x)
    return base_convert_plain(x, c)


def base_convert_plain(x: torch.Tensor, c: BaseConvConstants) -> torch.Tensor:
    """``base_convert`` in plain PyTorch ops."""
    y = mul_mod_shoup_plain(x, c.inv, c.inv_shoup, c.q_col)  # [..., g, N]
    v = _correction(y, c.q_f64)                          # [..., N]
    acc = torch.zeros(x.shape[:-2] + (c.t, x.shape[-1]), dtype=torch.int64,
                      device=x.device)
    for i in range(c.g):
        term = mul_mod_shoup_wide_plain(y[..., i:i + 1, :], c.M[i],
                                        c.M_shoup[i], c.p)   # [..., t, N]
        acc = add_mod_plain(acc, term, c.p)
    corr = mul_mod_plain(v[..., None, :], c.Qmod, c.p, c.mu, c.k)
    return sub_mod_plain(acc, corr, c.p)
