"""PyTorch wrappers of the hand-written CUDA kernels for CKKS encode and
decode (csrc/codec.cu).

  * K11 ``encode_residues``: slot values (re, im) float64 [..., s] with the
    embedding fused (``encode_slots``), or already embedded coefficients
    m' float64 [..., 2s] (``encode_coefficients``: the FFT branch, a limb
    shard's rows), -> coefficient rows int64 [..., r, N]: round(m' * scale)
    mod each of the r primes at column j * N/2s, zero elsewhere, ready for
    K1.  Replaces the XLA-fused encode of the JAX package
    (``hectr_tpu/ckks/scheme.py:162-184``); computes what
    ``ckks.encoding.coefficient_rows_plain`` computes (of ``embed_ri``'s
    output for the fused entry).
  * K12 ``crt_decode``: base-chain rows int64 [..., k, 2s] after K2, read
    through their strides (``intt(...)[..., ::N/2s]`` is never copied), or
    the CRT digits gathered already -> the double-double fractional CRT's
    values y float64 [..., 2s], or for s <= 64 the unembedded (re, im)
    [..., s].  Replaces ``hectr_tpu/ckks/scheme.py:187-236``; computes what
    ``ckks.scheme.crt_values_plain`` (and ``crt_decode_plain``) computes.

K11 is bound by the rows it writes, K12 by latency (the source note in
csrc/codec.cu has the design; ``bench.codec_bound`` the bound).  The
kernels are compiled from the repository's source with nvcc at first use
(``hectr_tpu_torch.ops.build``) and bound through a plain C interface with
ctypes; nothing here touches CUDA or nvcc at import time.

Each wrapper checks its operands in the order dtype -> shape -> device and
raises on anything the kernel does not take, before the library is built.
The data operands' leading (batch) dimensions merge wherever every
operand's strides allow (``rns_cuda.merge``), up to MAX_BATCH_DIMS; the
plan (merged sizes and strides, as ctypes arrays) is cached by the
operands' shapes, strides and devices and the constants' identities, so a
call's host work is a dictionary lookup, the output allocation and the
launch.  Each adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import launch_on, load, raise_on
from hectr_tpu_torch.ops.rns_cuda import merge

MAX_BATCH_DIMS = 4          # merged leading dimensions the kernels take
MAX_UNEMBED_WIDTH = 128     # 2s of K12's unembedding: one block a batch row

LAUNCHES = launches.register({"encode_residues": 0, "crt_decode": 0})
reset_launches = launches.resetter(LAUNCHES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("codec.cu")
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_double)
    lib.hectr_encode_residues.argtypes = [i32, ptr, ptr, ptr, ptr, i64, i64,
                                          ptr, ptr, i64, ptr, i64, i64, i64,
                                          f64, ptr, ptr]
    lib.hectr_encode_residues.restype = i32
    lib.hectr_crt_decode.argtypes = [i32, ptr, ptr, ptr, i64, i64, i64, i64,
                                     ptr, ptr, ptr, ptr, ptr, f64, f64, ptr,
                                     ptr, ptr, ptr, ptr]
    lib.hectr_crt_decode.restype = i32
    return lib


# ---------------------------------------------------------------------------
# checks and plans
# ---------------------------------------------------------------------------


def _check_dtypes(name: str, operands) -> None:
    """operands: (label, value, dtype) triples; raise TypeError on the first
    that is no tensor of its dtype."""
    for label, x, dtype in operands:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"CUDA {name}: {label} is a {type(x).__name__}, "
                            f"not a tensor")
        if x.dtype != dtype:
            raise TypeError(f"CUDA {name} kernel takes {label} as {dtype}, "
                            f"got {x.dtype}")


def _check_device(name: str, tensors) -> torch.device:
    """The one CUDA device every tensor lies on, or raise."""
    devices = {x.get_device() for x in tensors}
    if len(devices) != 1 or min(devices) < 0 or not tensors[0].is_cuda:
        raise ValueError(f"CUDA {name} kernel given tensors on "
                         f"{sorted({str(x.device) for x in tensors})}")
    return tensors[0].device


def _column(name: str, label: str, c: torch.Tensor, rows: int) -> None:
    if tuple(c.shape) != (rows, 1):
        raise ValueError(f"CUDA {name}: {label} must be a [{rows}, 1] column, "
                         f"got {tuple(c.shape)}")


def batch_plan(lead, strides) -> tuple[list[int], list[list[int]]]:
    """The leading dimensions `lead` (a shape) with each operand's strides
    over them, merged (size-1 dimensions dropped) into at most
    MAX_BATCH_DIMS: (sizes, strides per operand), at least one dimension."""
    sizes, merged = merge(list(lead), [list(s) for s in strides])
    if len(sizes) > MAX_BATCH_DIMS:
        raise ValueError(f"leading dimensions {tuple(lead)} merge into "
                         f"{len(sizes)}: the kernels take at most "
                         f"{MAX_BATCH_DIMS}")
    return sizes, merged


@dataclasses.dataclass(frozen=True)
class _Plan:
    """A cached launch: merged batch sizes and strides as ctypes arrays, the
    output shapes, and the constants the plan was made for (kept alive, so
    that no other tensor takes their identity while it is cached)."""

    device: torch.device
    nbatch: int
    sizes: ctypes.Array
    strides: ctypes.Array
    out_shapes: tuple
    consts: tuple
    extra: tuple = ()


_PLANS: dict = {}
MAX_PLANS = 1024      # the cache is emptied when it grows past this


def _key(head, data, consts) -> tuple:
    """The plan cache's key: each data operand's shape, strides, dtype and
    device, and each constant (primes, decode constants, embedding
    matrices: the contexts' cached tables) by identity."""
    return (*head, *[(x.shape, x.stride(), x.dtype, x.get_device())
                     for x in data], *[id(x) for x in consts])


def _plan(device: torch.device, lead, strides, out_shapes, consts, extra=()) -> _Plan:
    sizes, merged = batch_plan(lead, strides)
    flat = [s for st in merged for s in st]
    return _Plan(device, len(sizes), (ctypes.c_int64 * len(sizes))(*sizes),
                 (ctypes.c_int64 * len(flat))(*flat), out_shapes, consts,
                 extra)


def _cache(key, plan: _Plan) -> _Plan:
    if len(_PLANS) >= MAX_PLANS:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


def _encode_plan(fused: bool, data, embedding, primes, n: int) -> _Plan:
    name = "encode_residues"
    labels = ("re", "im") if fused else ("m'",)
    _check_dtypes(name, [*zip(labels, data, [torch.float64] * 2),
                         *zip(("ReE", "ImE"), embedding, [torch.float64] * 2),
                         ("primes", primes, torch.int64)])
    x = data[0]
    if x.dim() < 1 or any(d.shape != x.shape for d in data):
        raise ValueError(f"CUDA {name}: {labels} of shapes "
                         f"{[tuple(d.shape) for d in data]}: one shape "
                         f"[..., {'s' if fused else '2s'}]")
    width = 2 * x.shape[-1] if fused else x.shape[-1]
    if fused and any(tuple(E.shape) != (width // 2, width)
                     or not E.is_contiguous() for E in embedding):
        raise ValueError(f"CUDA {name}: ReE, ImE must be contiguous "
                         f"[{width // 2}, {width}]")
    if primes.dim() != 2 or primes.shape[1] != 1:
        raise ValueError(f"CUDA {name}: primes must be an [r, 1] column, got "
                         f"{tuple(primes.shape)}")
    rows = primes.shape[0]
    if width < 1 or n < 1 or n % width or n > 1 << 30:
        raise ValueError(f"CUDA {name}: {width} coefficients do not spread "
                         f"over rows of {n}")
    device = _check_device(name, [*data, *embedding, primes])
    lead = x.shape[:-1]
    col_strides = [d.stride(-1) for d in data] + [0]
    return _plan(device, lead, [d.stride()[:-1] for d in data],
                 ((*lead, rows, n),), (*embedding, primes),
                 extra=(col_strides[0], col_strides[1], width, rows))


def _encode(fused: bool, data, embedding, scale: float, primes,
            n: int) -> torch.Tensor:
    try:
        key = _key(("encode", fused, n), data, (*embedding, primes))
    except AttributeError:
        _encode_plan(fused, data, embedding, primes, n)   # names the operand
        raise
    plan = _PLANS.get(key)
    if plan is None:
        plan = _cache(key, _encode_plan(fused, data, embedding, primes, n))
    out = torch.empty(plan.out_shapes[0], dtype=torch.int64,
                      device=plan.device)
    cs0, cs1, width, rows = plan.extra
    if out.numel() == 0:
        return out
    lib = library()
    rc = launch_on(lib.hectr_encode_residues, plan.device.index, plan.nbatch,
               plan.sizes, plan.strides, data[0].data_ptr(),
               data[1].data_ptr() if fused else None, cs0, cs1,
               embedding[0].data_ptr() if fused else None,
               embedding[1].data_ptr() if fused else None, width,
               primes.data_ptr(), primes.stride(0), rows, n, float(scale),
               out.data_ptr())
    raise_on(lib, rc, "encode_residues")
    LAUNCHES["encode_residues"] += 1
    return out


def encode_slots(vre: torch.Tensor, vim: torch.Tensor, re_e: torch.Tensor,
                 im_e: torch.Tensor, scale: float, primes: torch.Tensor,
                 n: int) -> torch.Tensor:
    """K11 with the embedding fused: slot values vre, vim float64 [..., s]
    (any strides), the embedding matrices ReE, ImE float64 [s, 2s]
    (``encoding.embedding_matrices``), the primes int64 [r, 1] -> int64
    [..., r, n]: the residues of rint(m' * scale) at column j * n/2s, zero
    elsewhere, m'_j summed in the kernel's fixed order."""
    return _encode(True, (vre, vim), (re_e, im_e), scale, primes, n)


def encode_coefficients(m: torch.Tensor, scale: float, primes: torch.Tensor,
                        n: int) -> torch.Tensor:
    """K11's m' entry: embedded coefficients m float64 [..., 2s] (any
    strides), primes int64 [r, 1] -> int64 [..., r, n], as
    ``encoding.coefficient_rows_plain``."""
    return _encode(False, (m,), (), scale, primes, n)


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------


def _decode_plan(x, consts, embedding) -> _Plan:
    name = "crt_decode"
    labels = ("p", "inv", "mu", "k")[:len(consts)]
    _check_dtypes(name, [("x", x, torch.int64),
                         *zip(labels, consts, [torch.int64] * 4),
                         *zip(("ReE", "ImE"), embedding,
                              [torch.float64] * 2)])
    if x.dim() < 2:
        raise ValueError(f"CUDA {name}: x must be [..., k, 2s], got "
                         f"{tuple(x.shape)}")
    rows, width = x.shape[-2:]
    for label, c in zip(labels, consts):
        _column(name, label, c, rows)
    if rows < 1 or width < 1:
        raise ValueError(f"CUDA {name}: x of shape {tuple(x.shape)} has no "
                         f"rows or columns")
    lead = x.shape[:-2]
    if embedding:
        if width % 2 or width > MAX_UNEMBED_WIDTH or any(
                tuple(E.shape) != (width // 2, width) or not E.is_contiguous()
                for E in embedding):
            raise ValueError(f"CUDA {name}: unembedding {width} coefficients "
                             f"takes contiguous [{width // 2}, {width}] "
                             f"matrices and 2s <= {MAX_UNEMBED_WIDTH}")
        out_shapes = ((*lead, width // 2),) * 2
    else:
        out_shapes = ((*lead, width),)
    device = _check_device(name, [x, *consts, *embedding])
    return _plan(device, lead, [x.stride()[:-2]], out_shapes,
                 (*consts, *embedding),
                 extra=(x.stride(-2), x.stride(-1), rows, width,
                        (ctypes.c_int64 * 4)(*[c.stride(0) for c in consts],
                                             *[0] * (4 - len(consts)))))


def crt_decode(x: torch.Tensor, p: torch.Tensor, q_hi: float, q_lo: float,
               digit_consts: tuple | None = None,
               embedding: tuple | None = None):
    """K12: x int64 [..., k, 2s] (any strides) and the rows' primes p int64
    [k, 1]; with `digit_consts` (inv, mu, k), each [k, 1] int64, x are the
    base-chain coefficients and the kernel forms the digits x inv mod p
    (Barrett, as ``ckks.modmath.mul_mod``), without them x are the digits.
    Q / scale = q_hi + q_lo.  Returns y float64 [..., 2s], or with
    `embedding` (ReE, ImE float64 [s, 2s]) the slot values (re, im), each
    float64 [..., s]."""
    consts = (p, *digit_consts) if digit_consts is not None else (p,)
    embedding = tuple(embedding) if embedding is not None else ()
    try:
        key = _key(("decode",), (x,), (*consts, *embedding))
    except AttributeError:
        _decode_plan(x, consts, embedding)
        raise
    plan = _PLANS.get(key)
    if plan is None:
        plan = _cache(key, _decode_plan(x, consts, embedding))
    outs = [torch.empty(s, dtype=torch.float64, device=plan.device)
            for s in plan.out_shapes]
    if outs[0].numel() == 0:
        return tuple(outs) if embedding else outs[0]
    row_stride, col_stride, rows, width, const_strides = plan.extra
    ptrs = [c.data_ptr() for c in consts] + [None] * (4 - len(consts))
    lib = library()
    rc = launch_on(lib.hectr_crt_decode, plan.device.index, plan.nbatch, plan.sizes,
               plan.strides, x.data_ptr(), row_stride, col_stride, rows,
               width, *ptrs, const_strides, float(q_hi), float(q_lo),
               embedding[0].data_ptr() if embedding else None,
               embedding[1].data_ptr() if embedding else None,
               outs[0].data_ptr(), outs[1].data_ptr() if embedding else None)
    raise_on(lib, rc, "crt_decode")
    LAUNCHES["crt_decode"] += 1
    return tuple(outs) if embedding else outs[0]
