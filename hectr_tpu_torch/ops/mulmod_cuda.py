"""PyTorch wrapper of the hand-written CUDA multiply-ceiling probe
(csrc/mulmod_chain.cu).

K3 ``mulmod_chain_cuda`` replaces
``scripts/bench_vpu_ceiling.py::main.kernel``: r dependent lazy Shoup
multiplies per element by its lane's constant.  It computes exactly
what ``hectr_tpu_torch.bench.vpu_ceiling.chain_plain`` computes; the
source note in csrc/mulmod_chain.cu gives the design and what bounds it.

The wrapper adds one to ``LAUNCHES["mulmod_chain"]`` where it launches
the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import load, raise_on

LAUNCHES = launches.register({"mulmod_chain": 0})
reset_launches = launches.resetter(LAUNCHES)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("mulmod_chain.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hectr_mulmod_chain.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                       ctypes.c_int64, i32, i32, ptr]
    lib.hectr_mulmod_chain.restype = i32
    return lib


def mulmod_chain_cuda(x: torch.Tensor, w32: torch.Tensor,
                      w_shoup32: torch.Tensor, p32: torch.Tensor,
                      r: int) -> torch.Tensor:
    """r chained lazy Shoup multiplies on the card (K3): int64
    [rows, lanes] residues below 2^31 -> int64 [rows, lanes] in [0, 2p);
    w32, w_shoup32, p32 are int32 [lanes] tensors of 32-bit patterns."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA mulmod chain given a tensor on {x.device}")
    if x.dtype != torch.int64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("CUDA mulmod chain takes a contiguous int64 "
                         f"[rows, lanes] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    lanes = x.shape[1]
    for name, c in (("w", w32), ("w_shoup", w_shoup32), ("p", p32)):
        if (c.dtype != torch.int32 or c.shape != (lanes,)
                or c.device != x.device or not c.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous int32 [{lanes}] "
                             f"on {x.device}, got {c.dtype} "
                             f"{tuple(c.shape)} on {c.device}")
    if not 0 <= r < 2**31 or x.numel() == 0:
        raise ValueError(f"chain length {r}, {x.numel()} elements")
    lib = library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.hectr_mulmod_chain(x.data_ptr(), out.data_ptr(),
                                    w32.data_ptr(), w_shoup32.data_ptr(),
                                    p32.data_ptr(), x.numel(), lanes, r,
                                    stream)
    raise_on(lib, rc, "mulmod_chain")
    LAUNCHES["mulmod_chain"] += 1
    return out
