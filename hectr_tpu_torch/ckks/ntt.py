"""Negacyclic NTT / inverse NTT over RNS limb tensors.

The merged-psi transforms of Longa & Naehrig ("Speeding up the NTT",
2016), as in ``hectr_tpu/ckks/ntt.py``: the forward transform is
Cooley-Tukey with the 2N-th root psi's powers in bit-reversed order
(natural -> bit-reversed order); the inverse is Gentleman-Sande with
psi^-1 powers, scaled by N^-1 (bit-reversed -> natural).  Pointwise
products happen in the bit-reversed NTT domain.

Dispatch is by the tensor's device: a CUDA tensor goes to the
hand-written kernels (``hectr_tpu_torch.ops.ntt_cuda``), which raise on
what they do not support; a CPU tensor goes to the plain stage-per-pass
version below, which is also the reference the kernels are held to.  On
the card, a ring above the kernels' largest row (2^15) is routed by its
size to the coefficient-sharded transform on a local mesh
(``sharded_ring``), whose local stages are kernel launches again.
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
    mul_mod,
    mul_mod_shoup_plain,
    shoup,
    sub_mod_plain,
)
from hectr_tpu_torch.ckks.primes import root_of_unity
from hectr_tpu_torch.config import resolve_device


def bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class HostNTTTables:
    """Per-prime-chain transform tables on the host (numpy), laid out
    as in the JAX package so the two can be compared array for array."""

    n: int
    primes: tuple[int, ...]
    p: np.ndarray                  # [L, 1] int64
    mu: np.ndarray                 # [L, 1] int64  Barrett mu
    k: np.ndarray                  # [L, 1] int64  Barrett shift base
    psi_rev: np.ndarray            # [L, N] uint32  psi^brv(i)
    psi_rev_shoup: np.ndarray      # [L, N] uint32
    psi_inv_rev: np.ndarray        # [L, N] uint32  psi^-brv(i)
    psi_inv_rev_shoup: np.ndarray  # [L, N] uint32
    n_inv: np.ndarray              # [L, 1] uint32  N^-1 mod p
    n_inv_shoup: np.ndarray        # [L, 1] uint32


@functools.lru_cache(maxsize=None)
def build_ntt_tables(n: int, primes: tuple[int, ...]) -> HostNTTTables:
    L = len(primes)
    brv = bit_reverse_indices(n)
    psi_rev = np.empty((L, n), dtype=np.uint32)
    psi_inv_rev = np.empty((L, n), dtype=np.uint32)
    n_inv = np.empty((L, 1), dtype=np.uint32)
    p_arr, mu, k = barrett_constants(list(primes))
    for i, p in enumerate(primes):
        psi = root_of_unity(p, 2 * n)
        psi_inv = pow(psi, -1, p)
        pows = np.empty(n, dtype=object)
        pows_inv = np.empty(n, dtype=object)
        acc = 1
        acc_inv = 1
        for j in range(n):
            pows[j] = acc
            pows_inv[j] = acc_inv
            acc = acc * psi % p
            acc_inv = acc_inv * psi_inv % p
        psi_rev[i] = pows[brv].astype(np.uint32)
        psi_inv_rev[i] = pows_inv[brv].astype(np.uint32)
        n_inv[i, 0] = pow(n, -1, p)

    def _shoup32(w):
        return shoup(w, p_arr).astype(np.uint32)

    return HostNTTTables(
        n=n, primes=primes, p=p_arr, mu=mu, k=k,
        psi_rev=psi_rev, psi_rev_shoup=_shoup32(psi_rev),
        psi_inv_rev=psi_inv_rev, psi_inv_rev_shoup=_shoup32(psi_inv_rev),
        n_inv=n_inv, n_inv_shoup=_shoup32(n_inv),
    )


def u32_as_i32(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 tensor with the same 32-bit patterns (a
    Shoup companion >= 2^31 reads back negative here and unchanged as
    uint32 in a kernel)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


@dataclasses.dataclass(frozen=True, eq=False)
class NTTTables:
    """Device-resident tables for one (n, primes, device).

    The int64 fields serve the plain path and the modular arithmetic
    around it; the ``*32`` fields hold the same values as 32-bit
    patterns in int32 tensors for the CUDA kernels."""

    n: int
    primes: tuple[int, ...]
    device: torch.device
    p: torch.Tensor                 # [L, 1] int64
    mu: torch.Tensor                # [L, 1] int64
    k: torch.Tensor                 # [L, 1] int64
    psi_rev: torch.Tensor           # [L, N] int64
    psi_rev_shoup: torch.Tensor
    psi_inv_rev: torch.Tensor
    psi_inv_rev_shoup: torch.Tensor
    n_inv: torch.Tensor             # [L, 1] int64
    n_inv_shoup: torch.Tensor
    p32: torch.Tensor               # [L] int32 bit patterns
    psi_rev32: torch.Tensor         # [L, N] int32 bit patterns
    psi_rev_shoup32: torch.Tensor
    psi_inv_rev32: torch.Tensor
    psi_inv_rev_shoup32: torch.Tensor
    n_inv32: torch.Tensor           # [L] int32 bit patterns
    n_inv_shoup32: torch.Tensor


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, primes: tuple[int, ...],
                   device: torch.device) -> NTTTables:
    h = build_ntt_tables(n, primes)

    def i32(a):
        return u32_as_i32(a).to(device)

    return NTTTables(
        n=n, primes=primes, device=device,
        p=i64(h.p, device), mu=i64(h.mu, device), k=i64(h.k, device),
        psi_rev=i64(h.psi_rev, device),
        psi_rev_shoup=i64(h.psi_rev_shoup, device),
        psi_inv_rev=i64(h.psi_inv_rev, device),
        psi_inv_rev_shoup=i64(h.psi_inv_rev_shoup, device),
        n_inv=i64(h.n_inv, device), n_inv_shoup=i64(h.n_inv_shoup, device),
        p32=i32(h.p.astype(np.uint32).reshape(-1)),
        psi_rev32=i32(h.psi_rev), psi_rev_shoup32=i32(h.psi_rev_shoup),
        psi_inv_rev32=i32(h.psi_inv_rev),
        psi_inv_rev_shoup32=i32(h.psi_inv_rev_shoup),
        n_inv32=i32(h.n_inv.reshape(-1)),
        n_inv_shoup32=i32(h.n_inv_shoup.reshape(-1)),
    )


def ntt_tables(n: int, primes: tuple[int, ...], device) -> NTTTables:
    """Tables over `primes` at ring size n, cached per (n, primes,
    device)."""
    return _device_tables(n, tuple(primes), resolve_device(device))


def ntt_plain(a: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT in plain PyTorch, one pass per stage.
    a: int64 [..., L, N] natural order -> [..., L, N] bit-reversed."""
    n = t.n
    batch = a.shape[:-2]
    L = a.shape[-2]
    pcol = t.p[..., None]                      # [L, 1, 1]
    half = n
    m = 1
    while m < n:
        half //= 2
        x = a.reshape(*batch, L, m, 2 * half)
        u = x[..., :half]
        v = x[..., half:]
        S = t.psi_rev[:, m:2 * m, None]
        Ssh = t.psi_rev_shoup[:, m:2 * m, None]
        v = mul_mod_shoup_plain(v, S, Ssh, pcol)
        a = torch.cat([add_mod_plain(u, v, pcol), sub_mod_plain(u, v, pcol)],
                      dim=-1).reshape(*batch, L, n)
        m *= 2
    return a


def intt_plain(a: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT in plain PyTorch.  int64 [..., L, N]
    bit-reversed -> natural-order coefficients."""
    n = t.n
    batch = a.shape[:-2]
    L = a.shape[-2]
    pcol = t.p[..., None]
    half = 1
    m = n
    while m > 1:
        h = m // 2
        x = a.reshape(*batch, L, h, 2 * half)
        u = x[..., :half]
        v = x[..., half:]
        S = t.psi_inv_rev[:, h:2 * h, None]
        Ssh = t.psi_inv_rev_shoup[:, h:2 * h, None]
        s = add_mod_plain(u, v, pcol)
        d = mul_mod_shoup_plain(sub_mod_plain(u, v, pcol), S, Ssh, pcol)
        a = torch.cat([s, d], dim=-1).reshape(*batch, L, n)
        half *= 2
        m = h
    return mul_mod_shoup_plain(a, t.n_inv, t.n_inv_shoup, t.p)


def _check(a: torch.Tensor, t: NTTTables) -> None:
    if a.dim() < 2 or a.shape[-1] != t.n or a.shape[-2] != len(t.primes):
        raise ValueError(f"expected [..., {len(t.primes)}, {t.n}], "
                         f"got {tuple(a.shape)}")
    if a.device != t.device:
        raise ValueError(f"tensor on {a.device}, tables on {t.device}")


def sharded_ring(a: torch.Tensor, t: NTTTables, inverse: bool = False
                 ) -> torch.Tensor:
    """The transform of a ring larger than one kernel row: the
    coefficient-sharded NTT (``parallel.ntt_shard``) on a local mesh of
    N / 2^15 shards, gathered back to ``[..., L, N]``.  Its local stages
    go through `ntt` / `intt` on chunks of 2^15, so on the card they are
    K1/K2 launches; on the CPU they are the plain stages (bit-equal to
    ``ntt_plain`` / ``intt_plain`` either way)."""
    from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN
    from hectr_tpu_torch.parallel import LocalMesh
    from hectr_tpu_torch.parallel.ntt_shard import make_sharded_ntt

    mesh = LocalMesh(t.n >> MAX_LOGN)
    fwd, inv = make_sharded_ntt(t, mesh)
    return mesh.gather((inv if inverse else fwd)(a))


def ntt(a: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT: the CUDA kernel for a CUDA tensor (through
    ``sharded_ring`` above 2^15), the plain version for a CPU tensor."""
    _check(a, t)
    if a.device.type == "cuda":
        from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN, ntt_cuda

        if t.n > 1 << MAX_LOGN:
            return sharded_ring(a, t)
        return ntt_cuda(a.contiguous(), t)
    if a.device.type != "cpu":
        raise NotImplementedError(f"no NTT for device {a.device}")
    return ntt_plain(a, t)


def intt(a: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT, dispatched as `ntt` is."""
    _check(a, t)
    if a.device.type == "cuda":
        from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN, intt_cuda

        if t.n > 1 << MAX_LOGN:
            return sharded_ring(a, t, inverse=True)
        return intt_cuda(a.contiguous(), t)
    if a.device.type != "cpu":
        raise NotImplementedError(f"no NTT for device {a.device}")
    return intt_plain(a, t)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Elementwise product in the NTT domain (Barrett)."""
    return mul_mod(a, b, t.p, t.mu, t.k)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Polynomial product mod X^N + 1 per limb: intt(ntt(a) * ntt(b))."""
    return intt(pointwise_mul(ntt(a, t), ntt(b, t), t), t)
