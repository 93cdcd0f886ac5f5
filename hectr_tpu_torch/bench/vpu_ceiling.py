"""Modular-multiply ceiling on one NVIDIA GPU: the counterpart of
``scripts/bench_vpu_ceiling.py``.

    python -m hectr_tpu_torch.bench.vpu_ceiling

It measures the attainable issue rate of the primitive every NTT
butterfly is built from, the lazy Shoup multiply of csrc/modmath.cuh,
with no data movement in the way: a [ROWS, LANES] block whose elements
each go through R_CHAIN dependent multiplies by their lane's constant
per kernel call, CALLS calls chained (the kernel K3,
ops/mulmod_cuda.py).  Shape, prime and draws are the JAX script's.  It
reports

  * lazy-Shoup multiplies/s of the kernel (CUDA events), beside the
    time of the same chain in plain PyTorch;
  * the instructions per multiply of the kernel's loop body, as
    ``cuobjdump -sass`` shows the built library;
  * the forward NTT kernel's multiply rate as a share of this ceiling:
    at logN=15 it does 15 * 2^14 Shoup multiplies per row (log2 N
    stages of N/2 butterflies, one multiply each).

Correctness: kernel and plain chain are bit-equal (the lazy result is
fixed by the exact high product), and the chained result reduced mod p
equals x * w^(R_CHAIN * CALLS) mod p.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from hectr_tpu_torch.bench import cuda_time_ms
from hectr_tpu_torch.ckks.modmath import mul_mod_shoup_lazy_plain
from hectr_tpu_torch.ckks.ntt import u32_as_i32
from hectr_tpu_torch.ckks.primes import find_ntt_primes

LANES = 128
ROWS = 4096       # [4096, 128]: the JAX script's 2 MB uint32 block
R_CHAIN = 512     # dependent multiplies per element per kernel call
CALLS = 4         # kernel calls chained per dispatch


@dataclasses.dataclass(frozen=True, eq=False)
class LaneConstants:
    """Per-lane multiplier w, its Shoup companion and the prime, as
    int64 [lanes] tensors (plain chain) and as int32 bit patterns
    (kernel)."""

    p: int
    w: torch.Tensor
    w_shoup: torch.Tensor
    pv: torch.Tensor
    w32: torch.Tensor
    w_shoup32: torch.Tensor
    p32: torch.Tensor


def probe_inputs(device, rows: int = ROWS
                 ) -> tuple[torch.Tensor, LaneConstants]:
    """(x0 int64 [rows, LANES] below p, lane constants) on `device`:
    p is the largest 30-bit NTT prime for 2N = 2^16, w and x0 are
    numpy default_rng(0) draws in the JAX script's order."""
    p = find_ntt_primes(30, 1, 2 * (1 << 15))[0]
    rng = np.random.default_rng(0)
    w = rng.integers(1, p, size=(1, LANES), dtype=np.uint64)[0]
    wsh = ((w.astype(object) << 32) // p % (1 << 32)).astype(np.uint64)
    x0 = rng.integers(0, p, size=(rows, LANES), dtype=np.uint64)
    pv = np.full(LANES, p, dtype=np.uint64)

    def i64(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def i32(a):
        return u32_as_i32(a.astype(np.uint32)).to(device)

    return i64(x0), LaneConstants(p=p, w=i64(w), w_shoup=i64(wsh),
                                  pv=i64(pv), w32=i32(w),
                                  w_shoup32=i32(wsh), p32=i32(pv))


def chain_plain(x: torch.Tensor, c: LaneConstants, r: int) -> torch.Tensor:
    """r dependent lazy Shoup multiplies per element in plain int64
    PyTorch: x [rows, lanes] below 2^31 -> [rows, lanes] in [0, 2p)."""
    for _ in range(r):
        x = mul_mod_shoup_lazy_plain(x, c.w, c.w_shoup, c.pv)
    return x


def chain(x: torch.Tensor, c: LaneConstants, r: int) -> torch.Tensor:
    """The chain on x's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cuda":
        from hectr_tpu_torch.ops.mulmod_cuda import mulmod_chain_cuda

        return mulmod_chain_cuda(x.contiguous(), c.w32, c.w_shoup32, c.p32, r)
    if x.device.type != "cpu":
        raise NotImplementedError(f"no mulmod chain for device {x.device}")
    return chain_plain(x, c, r)


def dispatch(x: torch.Tensor, c: LaneConstants, r: int = R_CHAIN,
             calls: int = CALLS, step=chain) -> torch.Tensor:
    """`calls` chained calls of `step` (default: the dispatching
    chain), each r multiplies deep."""
    for _ in range(calls):
        x = step(x, c, r)
    return x


def pow_probe_ok(x0: torch.Tensor, out: torch.Tensor, c: LaneConstants,
                 r_total: int) -> bool:
    """out mod p == x0 * w^r_total mod p, lane by lane."""
    wpow = torch.tensor([pow(int(w), r_total, c.p) for w in c.w.tolist()],
                        dtype=torch.int64, device=x0.device)
    want = torch.remainder(x0 * wpow, c.p)        # < 2^60: exact
    return bool(torch.equal(torch.remainder(out, c.p), want))


def ntt_share(ntt_ms: float, mult_per_s: float, rows: int = 11 * 24,
              logn: int = 15) -> tuple[float, float]:
    """(Shoup multiplies/s of one forward NTT kernel call over `rows`
    rows of 2^logn taking ntt_ms, that rate / mult_per_s)."""
    mults = rows * logn * (1 << (logn - 1))
    rate = mults / (ntt_ms * 1e-3)
    return rate, rate / mult_per_s


# ---------------------------------------------------------------------------
# the kernel's loop body in SASS
# ---------------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L\w*):")


def _opcode(text: str) -> str:
    tokens = text.split()
    return tokens[1] if tokens[0].startswith("@") else tokens[0]


def sass_loop_body(sass: str, kernel: str) -> dict:
    """The instruction count of `kernel`'s hottest loop in a
    ``cuobjdump -sass`` listing: the backward branch whose body holds the
    most high-product multiplies (IMAD.HI / IMUL.HI, one per lazy Shoup
    multiply).  Returns body length, multiplies in it, instructions per
    multiply and the body's opcodes."""
    blocks = re.split(r"Function\s*:\s*", sass)
    block = next((b for b in blocks[1:] if kernel in b.split(None, 1)[0]),
                 None)
    if block is None:
        raise ValueError(f"no function named like {kernel!r} in the listing")
    insns, labels, pending = [], {}, []
    for line in block.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2)))

    def target(text):
        m = re.search(r"`\((\.L\w*)\)", text)
        if m:
            return labels.get(m.group(1))
        m = re.search(r"\b0x([0-9a-f]+)\b", text)
        return int(m.group(1), 16) if m else None

    def mults(body):
        return sum(_opcode(t).startswith(("IMAD.HI", "IMUL.HI"))
                   for _, t in body)

    loops = []
    for addr, text in insns:
        if _opcode(text).startswith("BRA"):
            tgt = target(text)
            if tgt is not None and tgt <= addr:
                loops.append([(a, t) for a, t in insns if tgt <= a <= addr])
    body = max(loops, key=mults, default=[])
    n = mults(body)
    if n == 0:
        raise ValueError(f"no loop with a high-product multiply in {kernel}")
    return {"body_instructions": len(body), "multiplies": n,
            "per_multiply": len(body) / n,
            "opcodes": dict(collections.Counter(_opcode(t) for _, t in body))}


def kernel_sass(lib_path) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


# ---------------------------------------------------------------------------
# the probe on the card
# ---------------------------------------------------------------------------


def check_kernel(x0: torch.Tensor, c: LaneConstants) -> int:
    """Hold the kernel bit-equal to the plain chain at small r and over
    one whole dispatch; returns max |kernel - plain| (0) or raises."""
    err = 0
    for r in (0, 1, 2, 3, 16):
        got, want = chain(x0, c, r), chain_plain(x0, c, r)
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"mulmod chain kernel != plain at r={r}")
    got = dispatch(x0, c)
    want = dispatch(x0, c, step=chain_plain)
    err = max(err, int((got - want).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("mulmod chain kernel != plain over "
                             f"{CALLS} x {R_CHAIN}")
    return err


def probe(x0: torch.Tensor, c: LaneConstants, reps: int = 10) -> dict:
    """The probe itself on the card: the pow identity on one dispatch,
    then the kernel's time per dispatch and its multiply rate."""
    out = dispatch(x0, c)
    if not pow_probe_ok(x0, out, c, R_CHAIN * CALLS):
        raise AssertionError("chain mod p != x * w^(R*CALLS) mod p")
    ms = cuda_time_ms(lambda: dispatch(x0, c), reps=reps, warmup=2)
    mults = x0.numel() * R_CHAIN * CALLS
    return {"ms": ms, "mult_per_s": mults / (ms * 1e-3)}


def plain_ms(x0: torch.Tensor, c: LaneConstants) -> float:
    """Device time of one dispatch of the plain chain."""
    return cuda_time_ms(lambda: dispatch(x0, c, step=chain_plain), reps=2,
                        warmup=1)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: the ceiling is a device metric")
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.config import FLAGSHIP
    from hectr_tpu_torch.ops import build, mulmod_cuda

    device = torch.device("cuda", torch.cuda.current_device())
    x0, c = probe_inputs(device)
    mulmod_cuda.library()
    err = check_kernel(x0, c)
    res = probe(x0, c)
    t = make_context(FLAGSHIP).tables_ks(FLAGSHIP.mult_depth * 2 + 2, device)
    a = torch.randint(0, c.p, (11, len(t.primes), t.n), device=device)
    a = torch.remainder(a, t.p)
    ntt_ms = cuda_time_ms(lambda: T.ntt(a, t))
    sass = sass_loop_body(kernel_sass(build.library_path("mulmod_chain.cu")),
                          "mulmod_chain_kernel")
    rate, share = ntt_share(ntt_ms, res["mult_per_s"])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "max_abs_err": err,
        "kernel_ms_per_dispatch": res["ms"],
        "plain_ms_per_dispatch": plain_ms(x0, c),
        "mult_per_s": res["mult_per_s"], "sass": sass,
        "ntt_ms": ntt_ms, "ntt_mult_per_s": rate, "ntt_share": share}))


if __name__ == "__main__":
    main()
