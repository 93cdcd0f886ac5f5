"""Build the hand-written CUDA kernels of ``hectr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc, at first use, into its own
shared library ``csrc/build/libhectr_<name>.so`` with a plain C
interface, loaded with ctypes; ``launch_on`` calls an entry point on the
current stream of a card.  A library is rebuilt when its source or
any header of ``csrc/`` is newer than it.  ``build`` starts one nvcc per
stale source, all at once, and waits for all of them.  Nothing here
touches CUDA or nvcc at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return path


def library_path(source: str) -> pathlib.Path:
    """The library built from csrc/<source> (a ``.cu`` file name)."""
    return BUILD / f"libhectr_{pathlib.Path(source).stem}.so"


def _stale(source: str) -> bool:
    lib = library_path(source)
    if not lib.exists():
        return True
    inputs = [CSRC / source, *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(*sources: str) -> list[pathlib.Path]:
    """Compile every stale source among `sources` (file names in csrc/),
    one nvcc process each, all started together; returns the libraries'
    paths in order.  Raises with the compiler's output if any fails."""
    stale = [s for s in sources if _stale(s)]
    if stale:
        BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in stale:
            # build to a private name, then rename: concurrent builders
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
            jobs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for src, tmp, proc in jobs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"nvcc {src} failed ({proc.returncode}):\n"
                              f"{out}\n{err}")
            else:
                os.replace(tmp, library_path(src))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """Build csrc/<source> if stale and load it; the caller declares the
    argument and result types of its entry points."""
    lib = ctypes.CDLL(str(build(source)[0]))
    lib.hectr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hectr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.hectr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=1)
def _several_cards() -> bool:
    return torch.cuda.device_count() > 1


def launch_on(entry, device: int, *args) -> int:
    """Call the C entry point `entry` with `args` and the current stream of
    card `device` appended, with that card current."""
    if _several_cards() and device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return entry(*args, torch._C._cuda_getCurrentRawStream(device))
    return entry(*args, torch._C._cuda_getCurrentRawStream(device))
