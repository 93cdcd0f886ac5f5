"""PyTorch wrappers of the hand-written CUDA NTT kernels (csrc/ntt.cu).

K1 ``ntt_cuda`` replaces ``hectr_tpu/ops/ntt_pallas.py::_fwd_kernel``
and K2 ``intt_cuda`` replaces ``::_inv_kernel``.  Each computes exactly
what ``hectr_tpu_torch.ckks.ntt.ntt_plain`` / ``intt_plain`` compute.

Design (the source note in csrc/ntt.cu has the detail).  The log2 N
stages run in as few passes of at most 5 stages as the row needs, each
held in registers by the thread that owns the 2^r elements the pass
combines; the row moves between passes through swizzled shared memory.
A row is spread over a thread-block cluster of C CTAs, and ``geometry``
picks C and the threads from the launch's shape alone (rows, logN): a
launch gets more CTAs than two for each SM, so a launch of a few rows
still covers the card, and a CTA has at most 256 threads and 64 KB of
the row, so two share an SM (a 2^15 row always takes two CTAs or more).  What bounds the kernels is device memory: 16 bytes per element
(int64 in and out) against one lazy Shoup multiply per butterfly.

The kernels are compiled from the repository's source with nvcc at
first use (``hectr_tpu_torch.ops.build``) and bound through a plain C
interface with ctypes.  Nothing here touches CUDA or nvcc at import
time.

Each wrapper adds one to ``LAUNCHES[name]`` (and to ``LAUNCH_SHAPES``
under its input's shape) where it launches its kernel, and nowhere else,
so a run can show it went through them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from hectr_tpu_torch.ops import launches
from hectr_tpu_torch.ops.build import load, raise_on

MAX_LOGN = 15            # the kernels' row sizes: N = 2^1 .. 2^15
MAX_PASS_BITS = 5        # a thread holds at most 2^5 elements of a row
FIRST_PASS_BITS = 4      # ... or 2 x 2^4 in a pass of two columns
MAX_LOG_CLUSTER = 3      # 8 CTAs, the portable cluster size
MAX_THREADS = 256        # the kernels' __launch_bounds__ (2 CTAs an SM)
MIN_THREADS = 64
SMEM_LIMIT = 232_448     # shared memory one CTA may hold on an H100
H100_SMS = 132
MIN_SLICE_LOG = 8        # a CTA of a cluster holds at least 2^8 elements
MAX_SLICE_LOG = 14       # ... and at most 2^14 (64 KB), so two share an SM

LAUNCHES = launches.register({"ntt": 0, "intt": 0})
LAUNCH_SHAPES: collections.Counter = launches.register(
    collections.Counter())
reset_launches = launches.resetter(LAUNCHES, LAUNCH_SHAPES)


def pass_widths(logn: int) -> tuple[int, ...]:
    """Stages per pass, top index bits first: as few passes of at most
    MAX_PASS_BITS as the row needs, split as evenly as they allow, the
    widest first (15 -> 5, 5, 5; 14 -> 5, 5, 4; 12 -> 4, 4, 4)."""
    count = -(-logn // MAX_PASS_BITS)
    base, extra = divmod(logn, count)
    return (base + 1,) * extra + (base,) * (count - extra)


def max_log_cluster(logn: int) -> int:
    """The largest cluster (as log2) the kernels can run a row of 2^logn
    on: the first pass must cover the CTA index bits and give every CTA
    at least one pair of columns."""
    r0 = pass_widths(logn)[0]
    if logn == r0:
        return 0
    return max(0, min(MAX_LOG_CLUSTER, r0, logn - r0 - 1))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape: 2^logc CTAs per row, `threads` per CTA,
    `smem` bytes of shared memory per CTA, `passes` as `pass_widths`."""

    logn: int
    logc: int
    threads: int
    smem: int
    passes: tuple[int, ...]

    @property
    def cluster(self) -> int:
        return 1 << self.logc

    @property
    def columns(self) -> int:
        """Columns a thread takes in the pass that crosses CTAs (the
        forward's first, the inverse's last): two, for 16-byte device
        accesses, where the row has more than one pass and that pass is
        at most FIRST_PASS_BITS wide (csrc/ntt.cu::first_columns)."""
        r0 = self.passes[0]
        return 2 if self.logn > r0 and r0 <= FIRST_PASS_BITS else 1

    @property
    def plan(self) -> int:
        """The pass widths packed 4 bits each, first pass lowest."""
        return sum(r << (4 * j) for j, r in enumerate(self.passes))

    def grid(self, rows: int) -> int:
        return rows << self.logc


def launch_geometry(logn: int, logc: int) -> Geometry:
    """The geometry of a row of 2^logn over 2^logc CTAs."""
    if not 1 <= logn <= MAX_LOGN or not 0 <= logc <= max_log_cluster(logn):
        raise ValueError(f"no launch of 2^{logn} over 2^{logc} CTAs")
    slice_log = logn - logc
    passes = pass_widths(logn)
    # one thread for each group of elements the widest pass combines, or
    # fewer (each then takes several): at 256 threads and <= 128
    # registers two CTAs share an SM
    items = 1 << max(0, slice_log - max(passes))
    threads = min(MAX_THREADS, max(MIN_THREADS, items))
    return Geometry(logn=logn, logc=logc, threads=threads,
                    smem=4 << slice_log, passes=passes)


@functools.lru_cache(maxsize=None)
def geometry(rows: int, logn: int) -> Geometry:
    """The launch the wrappers make for `rows` rows of 2^logn: the
    smallest cluster that keeps each CTA's slice within 2^MAX_SLICE_LOG
    elements and gives the launch more CTAs than two for each SM, while
    each CTA keeps at least 2^MIN_SLICE_LOG elements."""
    top = min(max_log_cluster(logn), max(0, logn - MIN_SLICE_LOG))
    logc = min(top, max(0, logn - MAX_SLICE_LOG))
    while logc < top and rows << logc <= 2 * H100_SMS:
        logc += 1
    return launch_geometry(logn, logc)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library."""
    lib = load("ntt.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hectr_ntt_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, i32, ptr]
    lib.hectr_ntt_fwd.restype = i32
    lib.hectr_ntt_inv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, i32, ptr]
    lib.hectr_ntt_inv.restype = i32
    lib.hectr_ntt_max_clusters.argtypes = [i32, i32, i32, i32, i32]
    lib.hectr_ntt_max_clusters.restype = i32
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
    if a.data_ptr() % 16:
        raise ValueError("CUDA NTT kernel takes 16-byte aligned tensors")
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


def _stream(a: torch.Tensor) -> int:
    return torch.cuda.current_stream(a.device).cuda_stream


def launch_fwd(a: torch.Tensor, t, geom: Geometry) -> torch.Tensor:
    """K1 over `a` with the given launch geometry (``ntt_cuda`` takes
    ``geometry``'s); counts no launch."""
    rows, L, logn = _check(a, t)
    lib = library()
    out = torch.empty_like(a)
    # the launch goes to the current device: make it the tensor's
    with torch.cuda.device(a.device):
        rc = lib.hectr_ntt_fwd(a.data_ptr(), out.data_ptr(),
                               t.psi_rev32.data_ptr(),
                               t.psi_rev_shoup32.data_ptr(), t.p32.data_ptr(),
                               rows, L, logn, geom.logc, geom.threads,
                               geom.plan, _stream(a))
    raise_on(lib, rc, "ntt")
    return out


def launch_inv(a: torch.Tensor, t, geom: Geometry) -> torch.Tensor:
    """K2 over `a` with the given launch geometry; counts no launch."""
    rows, L, logn = _check(a, t)
    lib = library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = lib.hectr_ntt_inv(a.data_ptr(), out.data_ptr(),
                               t.psi_inv_rev32.data_ptr(),
                               t.psi_inv_rev_shoup32.data_ptr(),
                               t.p32.data_ptr(), t.n_inv32.data_ptr(),
                               t.n_inv_shoup32.data_ptr(), rows, L, logn,
                               geom.logc, geom.threads, geom.plan, _stream(a))
    raise_on(lib, rc, "intt")
    return out


def max_active_clusters(forward: bool, geom: Geometry) -> int:
    """How many clusters of `geom` the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    lib = library()
    got = lib.hectr_ntt_max_clusters(int(forward), geom.logn, geom.logc,
                                     geom.threads, geom.plan)
    if got < 0:
        raise_on(lib, -got, "cudaOccupancyMaxActiveClusters")
    return got


def ntt_cuda(a: torch.Tensor, t) -> torch.Tensor:
    """Forward negacyclic NTT on the card (K1): int64 [..., L, N]
    natural order -> bit-reversed, with tables ``t`` from
    ``hectr_tpu_torch.ckks.ntt.ntt_tables``."""
    rows, _, logn = _check(a, t)
    out = launch_fwd(a, t, geometry(rows, logn))
    LAUNCHES["ntt"] += 1
    LAUNCH_SHAPES["ntt", tuple(a.shape)] += 1
    return out


def intt_cuda(a: torch.Tensor, t) -> torch.Tensor:
    """Inverse negacyclic NTT on the card (K2): int64 [..., L, N]
    bit-reversed -> natural-order coefficients."""
    rows, _, logn = _check(a, t)
    out = launch_inv(a, t, geometry(rows, logn))
    LAUNCHES["intt"] += 1
    LAUNCH_SHAPES["intt", tuple(a.shape)] += 1
    return out
