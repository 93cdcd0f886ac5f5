"""PyTorch wrappers of the hand-written CUDA NTT kernels (csrc/ntt.cu).

K1 ``ntt_cuda`` replaces ``hectr_tpu/ops/ntt_pallas.py::_fwd_kernel``
and K2 ``intt_cuda`` replaces ``::_inv_kernel``.  Each computes exactly
what ``hectr_tpu_torch.ckks.ntt.ntt_plain`` / ``intt_plain`` compute;
the source note in csrc/ntt.cu gives the design and what bounds it.

The kernels are compiled from the repository's source with nvcc at
first use (``hectr_tpu_torch.ops.build``) and bound through a plain C
interface with ctypes.  Nothing here touches CUDA or nvcc at import
time.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show it went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hectr_tpu_torch.ops.build import load, raise_on

MAX_LOGN = 15  # one row of 2^15 uint32 is 128 KB of shared memory

LAUNCHES = {"ntt": 0, "intt": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("ntt.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hectr_ntt_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.hectr_ntt_fwd.restype = i32
    lib.hectr_ntt_inv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, ptr]
    lib.hectr_ntt_inv.restype = i32
    return lib


def _check(a: torch.Tensor, t) -> tuple[int, int, int]:
    """(rows, L, logn) for a launch, or raise on what the kernels do
    not take."""
    if a.device.type != "cuda":
        raise ValueError(f"CUDA NTT kernel given a tensor on {a.device}")
    if a.device != t.device:
        raise ValueError(f"tensor on {a.device}, tables on {t.device}")
    if a.dtype != torch.int64:
        raise TypeError(f"CUDA NTT kernel takes int64 residues, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("CUDA NTT kernel takes contiguous tensors")
    n = t.n
    logn = n.bit_length() - 1
    if n != 1 << logn or not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"CUDA NTT kernel supports N = 2^1..2^{MAX_LOGN}, "
                         f"got N={n}")
    L = len(t.primes)
    if a.dim() < 2 or a.shape[-1] != n or a.shape[-2] != L:
        raise ValueError(f"expected [..., {L}, {n}], got {tuple(a.shape)}")
    rows = a.numel() // n
    if rows == 0:
        raise ValueError("empty input")
    return rows, L, logn


def ntt_cuda(a: torch.Tensor, t) -> torch.Tensor:
    """Forward negacyclic NTT on the card (K1): int64 [..., L, N]
    natural order -> bit-reversed, with tables ``t`` from
    ``hectr_tpu_torch.ckks.ntt.ntt_tables``."""
    rows, L, logn = _check(a, t)
    lib = library()
    out = torch.empty_like(a)
    # <<<>>> launches on the current device: make it the tensor's
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.hectr_ntt_fwd(a.data_ptr(), out.data_ptr(),
                               t.psi_rev32.data_ptr(),
                               t.psi_rev_shoup32.data_ptr(), t.p32.data_ptr(),
                               rows, L, logn, stream)
    raise_on(lib, rc, "ntt")
    LAUNCHES["ntt"] += 1
    return out


def intt_cuda(a: torch.Tensor, t) -> torch.Tensor:
    """Inverse negacyclic NTT on the card (K2): int64 [..., L, N]
    bit-reversed -> natural-order coefficients."""
    rows, L, logn = _check(a, t)
    lib = library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.hectr_ntt_inv(a.data_ptr(), out.data_ptr(),
                               t.psi_inv_rev32.data_ptr(),
                               t.psi_inv_rev_shoup32.data_ptr(),
                               t.p32.data_ptr(), t.n_inv32.data_ptr(),
                               t.n_inv_shoup32.data_ptr(), rows, L, logn,
                               stream)
    raise_on(lib, rc, "intt")
    LAUNCHES["intt"] += 1
    return out
