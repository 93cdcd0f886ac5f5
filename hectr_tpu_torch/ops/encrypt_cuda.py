"""PyTorch wrapper of the hand-written CUDA encrypt kernel
(csrc/encrypt.cu).

K14 ``encrypt``: public-key encryption's arithmetic for every ciphertext
of a batch in one launch.  From the sampler's signed draws v, e0, e1
[*batch, N], a plaintext m [*batch, k, N] and the public key pk [2, K, N]
(K >= k) it writes the ciphertext [*batch, 2, k, N]: the draws' floor-mod
residues, their forward NTTs and (v^ pk0 + e0^ + m, v^ pk1 + e1^), the
words ``ckks.scheme.encrypt_plain`` (its plain version) gives.  A row
of the launch (a batch row's limb) is a cluster of three groups of CTAs,
one a draw, each running K1's passes (``geometry``); the source note in
csrc/encrypt.cu gives the design and what bounds it.

``encrypt`` checks its operands (dtype, then shapes, then one device) and
raises on anything the kernel does not take, before the library is built;
``_launch`` raises off a CUDA device.  The kernel is compiled from the
repository's source with nvcc at first use (``ops.build``) and bound
through a plain C interface with ctypes; nothing here touches CUDA or nvcc
at import time.  ``encrypt`` adds one to ``LAUNCHES["encrypt"]`` and to
``LAUNCH_SHAPES`` under (batch rows, k, logN) where it launches the
kernel, and nowhere else; it adds nothing to ``ntt_cuda``'s counters.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from hectr_tpu_torch.ops import launches, ntt_cuda
from hectr_tpu_torch.ops.build import launch_on, load, raise_on

MAX_LOGN = ntt_cuda.MAX_LOGN     # K1's rows: N = 2^1 .. 2^15
DRAWS = 3                        # v, e0, e1: a group of CTAs each

LAUNCHES = launches.register({"encrypt": 0})
LAUNCH_SHAPES: collections.Counter = launches.register(
    collections.Counter())
reset_launches = launches.resetter(LAUNCHES, LAUNCH_SHAPES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("encrypt.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hectr_encrypt.argtypes = [ptr] * 11 + [i32] * 7 + [ptr]
    lib.hectr_encrypt.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def geometry(logn: int) -> ntt_cuda.Geometry:
    """A draw's share of K14's cluster for rows of 2^logn: K1's launch of a
    row over the fewest CTAs that keep a slice within 2^MAX_SLICE_LOG
    elements (two CTAs an SM), one at 2^14 and below, two at 2^15; the
    cluster holds DRAWS such groups."""
    return ntt_cuda.launch_geometry(
        logn, max(0, logn - ntt_cuda.MAX_SLICE_LOG))


def _check(v, e0, e1, m, pk, t) -> tuple[int, int]:
    """(batch rows, logN) of a launch over the draws v, e0, e1 [*batch,
    N], the plaintext m [*batch, k, N] and the key pk [2, K, N] with the
    tables t over the k limbs; raises on what K14 does not take."""
    operands = (("v", v), ("e0", e0), ("e1", e1), ("m", m), ("pk", pk))
    for label, x in operands:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"CUDA encrypt: {label} is a "
                            f"{type(x).__name__}, not a tensor")
        if x.dtype != torch.int64:
            raise TypeError(f"CUDA encrypt kernel takes {label} as int64, "
                            f"got {x.dtype}")
    n = t.n
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"CUDA encrypt kernel takes N = 2^1..2^{MAX_LOGN}, "
                         f"got N={n}")
    k = len(t.primes)
    if m.dim() < 2 or tuple(m.shape[-2:]) != (k, n):
        raise ValueError(f"CUDA encrypt: expected a plaintext [..., {k}, "
                         f"{n}], got {tuple(m.shape)}")
    batch = tuple(m.shape[:-2])
    for label, x in operands[:3]:
        if tuple(x.shape) != (*batch, n):
            raise ValueError(f"CUDA encrypt: draw {label} has shape "
                             f"{tuple(x.shape)}, the plaintext "
                             f"{tuple(m.shape)}")
    if pk.dim() != 3 or pk.shape[0] != 2 or pk.shape[-1] != n:
        raise ValueError(f"CUDA encrypt: expected a key [2, K, {n}], got "
                         f"{tuple(pk.shape)}")
    if pk.shape[1] < k:
        raise ValueError(f"CUDA encrypt: {k} limbs, the key has "
                         f"{pk.shape[1]}")
    devices = {x.device for _, x in operands} | {t.device}
    if len(devices) != 1:
        raise ValueError(f"CUDA encrypt given tensors on "
                         f"{sorted(str(d) for d in devices)}")
    rows = math.prod(batch)
    if rows == 0:
        raise ValueError("CUDA encrypt: empty batch")
    return rows, logn


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    """x contiguous; raises where it is not 16-byte aligned (the kernel
    reads two words at a time)."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("CUDA encrypt kernel takes 16-byte aligned tensors")
    return x


def encrypt(v: torch.Tensor, e0: torch.Tensor, e1: torch.Tensor,
            m: torch.Tensor, pk: torch.Tensor, t) -> torch.Tensor:
    """K14: the ciphertext [*batch, 2, k, N] of the plaintext m [*batch,
    k, N] under the key pk [2, K >= k, N] from the draws v, e0, e1
    [*batch, N], with the tables t over the k limbs (module docstring)."""
    rows, logn = _check(v, e0, e1, m, pk, t)
    k = len(t.primes)
    operands = [_contiguous(x) for x in (v, e0, e1, m, pk)]
    out = torch.empty((*m.shape[:-2], 2, k, t.n), dtype=torch.int64,
                      device=m.device)
    _launch(operands, out, t, rows * k, geometry(logn))
    LAUNCHES["encrypt"] += 1
    LAUNCH_SHAPES[rows, k, logn] += 1
    return out


def _launch(operands: list, out: torch.Tensor, t, rows: int,
            geom: ntt_cuda.Geometry) -> None:
    """K14 on the checked operands (v, e0, e1, m, pk; contiguous and
    16-byte aligned) into out over `rows` = B k rows, each a cluster of DRAWS
    groups of `geom`; raises off a CUDA device."""
    if out.device.type != "cuda":
        raise ValueError(f"CUDA encrypt kernel given tensors on {out.device}")
    lib = library()
    pk = operands[-1]
    rc = launch_on(lib.hectr_encrypt, out.device.index,
                   *(x.data_ptr() for x in operands), out.data_ptr(),
                   t.psi_rev32.data_ptr(), t.psi_rev_shoup32.data_ptr(),
                   t.p32.data_ptr(), t.mu.data_ptr(), t.k.data_ptr(), rows,
                   len(t.primes), pk.shape[1], geom.logn, geom.logc,
                   geom.threads, geom.plan)
    raise_on(lib, rc, "encrypt")
