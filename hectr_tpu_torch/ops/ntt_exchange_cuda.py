"""PyTorch wrappers of the hand-written CUDA kernels for the cross-shard
stages of the coefficient-sharded NTT (csrc/ntt_exchange.cu).

K4 (forward) and K5 (inverse) have no TPU kernel to replace: the JAX
package runs these stages as XLA code inside ``shard_map``
(``hectr_tpu/parallel/ntt_shard.py:117`` ``fwd_local`` and ``:137``
``inv_local``), which XLA fuses on a TPU; in eager PyTorch each stage
was about 15 launches.  They compute exactly what
``hectr_tpu_torch.parallel.ntt_shard.cross_stages_plain`` (local form)
and ``exchange_stage_plain`` (received form) compute.

  * ``exchange_local_cuda``: every shard in one tensor ``[..., L, D, C]``
    (a local mesh): all log2 D stages in one launch, a thread holding a
    column's D residues in registers.
  * ``exchange_recv_cuda``: one shard ``[..., L, 1, C]`` and the chunk
    its partner sent, int32 as it travels (``ProcessMesh.ppermute_wire``):
    one stage, this shard's half of the butterfly, one multiply.

Both are bound by device memory (the source note in csrc/ntt_exchange.cu
has the design; ``bench.exchange_bound`` the bound).  The kernels are
compiled from the repository's source with nvcc at first use
(``hectr_tpu_torch.ops.build``) and bound through a plain C interface
with ctypes; nothing here touches CUDA or nvcc at import time.

Each wrapper adds one to ``LAUNCHES[name]`` (and to ``LAUNCH_SHAPES``
under (name, form, input shape)) where it launches its kernel, and
nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import load, raise_on

MAX_LOG_SHARDS = 3       # D = 2 .. 8 in the local form

LAUNCHES = launches.register({"exchange_fwd": 0, "exchange_inv": 0})
LAUNCH_SHAPES: collections.Counter = launches.register(
    collections.Counter())
reset_launches = launches.resetter(LAUNCHES, LAUNCH_SHAPES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("ntt_exchange.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hectr_exchange_local.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                         i64, i32, i32, i32, i32, ptr]
    lib.hectr_exchange_local.restype = i32
    lib.hectr_exchange_recv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                        i32, i32, i64, i64, i32, i32, ptr]
    lib.hectr_exchange_recv.restype = i32
    return lib


def _name(inverse: bool) -> str:
    return "exchange_inv" if inverse else "exchange_fwd"


def _tables(t, inverse: bool):
    if inverse:
        return t.psi_inv_rev32, t.psi_inv_rev_shoup32
    return t.psi_rev32, t.psi_rev_shoup32


def _check(x: torch.Tensor, t, shards: int | None) -> tuple[int, int, int]:
    """(rows, L, log2 C) of a sharded int64 tensor ``[..., L, S, C]`` of
    the ring of `t`, or raise on what the kernels do not take; `shards`
    is the S the form expects (None: the whole ring, S = N / C)."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA exchange kernel given a tensor on {x.device}")
    if t.device != x.device:
        raise ValueError(f"tensor on {x.device}, tables on {t.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"CUDA exchange kernel takes int64 residues, got "
                        f"{x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("CUDA exchange kernel takes contiguous, 16-byte "
                         "aligned tensors")
    L = len(t.primes)
    if x.dim() < 3 or x.shape[-3] != L or x.numel() == 0:
        raise ValueError(f"expected [..., {L}, S, C], got {tuple(x.shape)}")
    S, C = x.shape[-2], x.shape[-1]
    log_c = C.bit_length() - 1
    if C < 2 or C != 1 << log_c or t.n % C:
        raise ValueError(f"chunks of {C} do not split a ring of {t.n}")
    D = t.n // C
    if shards is None and S != D:
        raise ValueError(f"the local form takes every shard: expected "
                         f"[..., {L}, {D}, {C}], got {tuple(x.shape)}")
    if shards is not None and S != shards:
        raise ValueError(f"the received form takes one shard: expected "
                         f"[..., {L}, 1, {C}], got {tuple(x.shape)}")
    return x.numel() // C // S, L, log_c


def exchange_local_cuda(x: torch.Tensor, t, inverse: bool = False
                        ) -> torch.Tensor:
    """Every cross-shard stage of the sharded transform on the card in one
    launch: K4 (``inverse=False``, the forward stages d = D/2 ... 1) or
    K5 (the inverse stages d = 1 ... D/2).  x: int64 ``[..., L, D, C]``
    canonical residues, every shard of the ring of `t` (the ring's own
    tables, ``ckks.ntt.ntt_tables``); 2 <= D <= 2^MAX_LOG_SHARDS."""
    rows, L, log_c = _check(x, t, None)
    D = x.shape[-2]
    logd = D.bit_length() - 1
    if not 1 <= logd <= MAX_LOG_SHARDS:
        raise ValueError(f"the local form takes D = 2..{1 << MAX_LOG_SHARDS} "
                         f"shards, got {D}")
    psi, psi_shoup = _tables(t, inverse)
    lib = library()
    name = _name(inverse)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.hectr_exchange_local(x.data_ptr(), out.data_ptr(),
                                      psi.data_ptr(), psi_shoup.data_ptr(),
                                      t.p32.data_ptr(), rows, L, logd, log_c,
                                      int(inverse), stream)
    raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name, "local", tuple(x.shape)] += 1
    return out


def stage_twiddle(shard: int, dist: int, D: int) -> tuple[int, bool]:
    """(twiddle index, is_u) of shard `shard` in the cross-shard stage of
    distance `dist` on D shards: the index m + s // (2 dist) into the
    ring's table, m = D / (2 dist), and whether the shard holds the u
    half of its pairs."""
    return D // (2 * dist) + shard // (2 * dist), (shard // dist) % 2 == 0


def exchange_recv_cuda(own: torch.Tensor, recv: torch.Tensor, t, shard: int,
                       dist: int, inverse: bool = False) -> torch.Tensor:
    """One cross-shard stage of one shard on the card, against the chunk
    its partner ``shard ^ dist`` sent: K4 (forward: u + S v_recv on the
    u-shard, u_recv - S v_own on the v-shard) or K5 (inverse: u + v_recv,
    (u_recv - v_own) S).  own: int64 ``[..., L, 1, C]``; recv of the same
    shape, int32 (the wire's bit patterns), on own's device."""
    rows, L, log_c = _check(own, t, 1)
    D = t.n >> log_c
    if not (0 <= shard < D and 1 <= dist < D and dist & (dist - 1) == 0):
        raise ValueError(f"shard {shard}, distance {dist} on {D} shards")
    if recv.device != own.device or recv.shape != own.shape:
        raise ValueError(f"received {tuple(recv.shape)} on {recv.device} for "
                         f"{tuple(own.shape)} on {own.device}")
    if recv.dtype != torch.int32:
        raise TypeError(f"received chunk of {recv.dtype}; the wire's int32")
    if not recv.is_contiguous() or recv.data_ptr() % 8:
        raise ValueError("the received chunk must be contiguous and aligned "
                         "to two elements")
    index, is_u = stage_twiddle(shard, dist, D)
    psi, psi_shoup = _tables(t, inverse)
    lib = library()
    name = _name(inverse)
    out = torch.empty_like(own)
    with torch.cuda.device(own.device):
        stream = torch.cuda.current_stream(own.device).cuda_stream
        rc = lib.hectr_exchange_recv(own.data_ptr(), recv.data_ptr(),
                                     out.data_ptr(),
                                     psi.data_ptr(), psi_shoup.data_ptr(),
                                     t.p32.data_ptr(), rows, L, log_c, t.n,
                                     index, int(is_u), int(inverse), stream)
    raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name, "received", tuple(own.shape)] += 1
    return out
