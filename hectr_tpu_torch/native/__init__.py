"""ctypes binding of the repo's exact host oracle ``csrc/hectr_host.cpp``.

The same surface as ``hectr_tpu/native/__init__.py``, on the port's
int64 residues: buffers are converted to the library's uint32 at the
call, and residue results come back as int64 CPU tensors.  The library
is built with g++ at first use into ``hectr_tpu_torch/csrc/build/``
(rebuilt when the source is newer) and its ABI version is checked.
Nothing falls back: where the library cannot be built or loaded, every
function raises; ``available()`` reports whether it can be.

  available() -> bool
  crt_centered(residues [L, N], primes)  -> object int array [N]
  to_rns(coeffs object ints [N], primes) -> int64 [L, N]
  ntt_ref / intt_ref(a [N], p, psi)      -> int64 [N]   exact oracle
  negacyclic_mul_ref(x [N], y [N], p)    -> int64 [N]   O(N^2) oracle
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import tempfile

import numpy as np
import torch

_ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _ROOT.parent / "csrc" / "hectr_host.cpp"
LIBRARY = _ROOT / "csrc" / "build" / "libhectr_host.so"
ABI_VERSION = 1

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _build() -> None:
    """g++ the oracle to a private name, then rename: concurrent
    processes never load a half-written library."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(SOURCE),
             "-o", tmp], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {SOURCE.name} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if stale) and load the oracle; raises if either fails or
    the ABI version differs."""
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        try:
            _build()
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot build {SOURCE}: {e}") from e
    lib = ctypes.CDLL(str(LIBRARY))
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    lib.hectr_host_abi_version.argtypes = []
    lib.hectr_host_abi_version.restype = ctypes.c_int
    lib.hectr_crt_centered.argtypes = [_u32p, _u64p, i64, i64, i64, _u8p, _u64p]
    lib.hectr_crt_centered.restype = ctypes.c_int
    lib.hectr_to_rns.argtypes = [_u8p, _u64p, _u64p, i64, i64, i64, _u32p]
    lib.hectr_to_rns.restype = ctypes.c_int
    lib.hectr_ntt_ref.argtypes = [_u32p, i64, u64, u64]
    lib.hectr_ntt_ref.restype = ctypes.c_int
    lib.hectr_intt_ref.argtypes = [_u32p, i64, u64, u64]
    lib.hectr_intt_ref.restype = ctypes.c_int
    lib.hectr_negacyclic_mul_ref.argtypes = [_u32p, _u32p, i64, u64, _u32p]
    lib.hectr_negacyclic_mul_ref.restype = ctypes.c_int
    version = lib.hectr_host_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{LIBRARY.name}: ABI version {version}, expected "
                           f"{ABI_VERSION}")
    return lib


def available() -> bool:
    """Whether the oracle builds and loads on this machine."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _u32(a) -> np.ndarray:
    """Residues (int64 tensor or array) -> a contiguous uint32 copy."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    if a.size and (a.min() < 0 or a.max() >= 1 << 32):
        raise ValueError("residues outside [0, 2^32)")
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned {rc}")


def _words_for(primes) -> int:
    bits = sum(int(p).bit_length() for p in primes) + 2
    return (bits + 63) // 64


def crt_centered(residues, primes) -> np.ndarray:
    """Residues [L, N] -> centered exact big-int coefficients (object
    array [N]); the contract of modmath.from_rns."""
    lib = library()
    res = _u32(residues)
    L, N = res.shape
    if L != len(primes):
        raise ValueError(f"{L} residue rows for {len(primes)} primes")
    W = _words_for(primes)
    pr = np.asarray(primes, dtype=np.uint64)
    neg = np.zeros(N, dtype=np.uint8)
    mag = np.zeros((N, W), dtype=np.uint64)
    _check(lib.hectr_crt_centered(_ptr(res, _u32p), _ptr(pr, _u64p), L, N, W,
                                  _ptr(neg, _u8p), _ptr(mag, _u64p)),
           "hectr_crt_centered")
    out = np.empty(N, dtype=object)
    for k in range(N):
        v = 0
        for i in range(W):
            if mag[k, i]:
                v += int(mag[k, i]) << (64 * i)
        out[k] = -v if neg[k] else v
    return out


def to_rns(coeffs_obj, primes) -> torch.Tensor:
    """Exact signed big-int coefficients [N] -> int64 residues [L, N];
    the contract of modmath.to_rns."""
    lib = library()
    coeffs = np.asarray(coeffs_obj, dtype=object)
    N = coeffs.shape[0]
    L = len(primes)
    W = _words_for(primes)
    neg = np.zeros(N, dtype=np.uint8)
    mag = np.zeros((N, W), dtype=np.uint64)
    mask = (1 << 64) - 1
    for k in range(N):
        v = int(coeffs[k])
        if v < 0:
            neg[k] = 1
            v = -v
        for i in range(W):
            mag[k, i] = v & mask
            v >>= 64
        if v:
            raise ValueError(f"coefficient {k} exceeds the CRT word budget")
    pr = np.asarray(primes, dtype=np.uint64)
    out = np.zeros((L, N), dtype=np.uint32)
    _check(lib.hectr_to_rns(_ptr(neg, _u8p), _ptr(mag, _u64p),
                            _ptr(pr, _u64p), L, N, W, _ptr(out, _u32p)),
           "hectr_to_rns")
    return torch.from_numpy(out.astype(np.int64))


def ntt_ref(a, p: int, psi: int) -> torch.Tensor:
    """Exact forward negacyclic NTT of one row [N] (bit-reversed
    output, as ntt)."""
    buf = _u32(a).copy()
    _check(library().hectr_ntt_ref(_ptr(buf, _u32p), buf.shape[0], p, psi),
           "hectr_ntt_ref")
    return torch.from_numpy(buf.astype(np.int64))


def intt_ref(a, p: int, psi: int) -> torch.Tensor:
    """Exact inverse of ntt_ref."""
    buf = _u32(a).copy()
    _check(library().hectr_intt_ref(_ptr(buf, _u32p), buf.shape[0], p, psi),
           "hectr_intt_ref")
    return torch.from_numpy(buf.astype(np.int64))


def negacyclic_mul_ref(x, y, p: int) -> torch.Tensor:
    """Schoolbook product of two rows [N] mod (X^N + 1, p)."""
    xb, yb = _u32(x), _u32(y)
    if xb.shape != yb.shape or xb.ndim != 1:
        raise ValueError(f"expected two rows [N], got {xb.shape}, {yb.shape}")
    out = np.zeros_like(xb)
    _check(library().hectr_negacyclic_mul_ref(
        _ptr(xb, _u32p), _ptr(yb, _u32p), xb.shape[0], p, _ptr(out, _u32p)),
        "hectr_negacyclic_mul_ref")
    return torch.from_numpy(out.astype(np.int64))
