"""K14 on the card beside the composition it replaces.

    python -m hectr_tpu_torch.bench.encrypt_kernels

K14 (``ops.encrypt_cuda.encrypt``: one public-key encryption of a batch in
one launch) at the shapes the loops encrypt: the benchmark's ring
(reference-hempc-secure, N = 2^13, 4 limbs) at one ciphertext (B 1, as
``hempc-loop``) and at 1,024 (B 1024, as ``hempc-serve1024``), and FLAGSHIP
(N = 2^15, 22 limbs) at one.  For each, on one set of ``TorchSampler`` draws,
a uniform plaintext and a key made on the card:

  * held bit-equal to ``ckks.scheme.encrypt_plain`` on the card (the
    floor-mod, the plain transform and the plain primitives, none of them a
    kernel of the port), and to ``ckks.scheme.encrypt_composed``, the
    composition K14 replaces on the card (three ``torch.remainder``, three
    K1, three K9 and a stack);
  * K14's device time, the plain version's and the composition's, each by
    CUDA-graph replay (``bench.cuda_graph_time_ms``), and the launches of
    K14 and of the composition (torch.profiler);
  * the bound (``bench.encrypt_bound``: the draws, plaintext and key read
    once, the ciphertext written once, against the multiply peak) and K14's
    share of it.

One JSON line per case, the card's name and power limit last.
"""

from __future__ import annotations

import json
import math
import subprocess

import torch

from hectr_tpu_torch import config as cfg
from hectr_tpu_torch.bench import (cuda_graph_time_ms, encrypt_bound,
                                   lazy_mult_peak_per_s)
from hectr_tpu_torch.bench.batch import profile_kernels
from hectr_tpu_torch.ckks import scheme as S
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.ops import encrypt_cuda as EC

# B 1024 last: after its plain version's graph (some 87 ms a replay) the
# next profile missed launches
CASES = {"B 1": (cfg.REFERENCE_HEMPC_SECURE, ()),
         "FLAGSHIP": (cfg.FLAGSHIP, ()),
         "B 1024": (cfg.REFERENCE_HEMPC_SECURE, (1024,))}


def uniform_plaintext(t, batch: tuple, gen: torch.Generator) -> torch.Tensor:
    """Residues [*batch, k, N], uniform below each limb's prime."""
    rows = [torch.randint(0, p, (*batch, t.n), generator=gen,
                          device=t.device) for p in t.primes]
    return torch.stack(rows, dim=-2)


def operands(preset, batch: tuple, device, seed: int = 0):
    """(tables over the top level, key, plaintext, draws (v, e0, e1)) at
    `preset` for a batch of `batch` ciphertexts."""
    ctx = make_context(preset)
    keys = S.keygen(ctx, S.TorchSampler(seed, device), device)
    k = ctx.max_limbs
    t = ctx.tables(k, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    m = uniform_plaintext(t, batch, gen)
    draws = S.TorchSampler(seed + 2, device).encryption(ctx, k, batch, device)
    return t, keys.pk, m, draws


def measure(device) -> list[dict]:
    """Each case checked, then timed (module docstring)."""
    peak = lazy_mult_peak_per_s()
    out = []
    for label, (preset, batch) in CASES.items():
        t, pk, m, (v, e0, e1) = operands(preset, batch, device)

        def kernel():
            return EC.encrypt(v, e0, e1, m, pk, t)

        def plain():
            return S.encrypt_plain(t, pk, m, v, e0, e1)

        def composed():
            return S.encrypt_composed(t, pk, m, v, e0, e1)

        got = kernel()
        for name, want in (("plain version", plain),
                           ("composition", composed)):
            if not torch.equal(got, want()):
                raise AssertionError(f"K14 at {label}: not bit-equal to the "
                                     f"{name}")
        del got
        B, k, logn = math.prod(batch), len(t.primes), t.n.bit_length() - 1
        launches = profile_kernels(kernel)["kernel_launches"]
        composed_launches = profile_kernels(composed)["kernel_launches"]
        ms = cuda_graph_time_ms(kernel)
        bound_ms, bound_by = encrypt_bound(B, k, logn, peak)
        out.append({
            "kernel": "encrypt", "case": label, "preset": preset.name,
            "batch": list(batch), "limbs": k, "logn": logn,
            "bit_equal": True, "ms": ms, "launches": launches,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms,
            "plain_ms": cuda_graph_time_ms(plain),
            "composed_ms": cuda_graph_time_ms(composed),
            "composed_launches": composed_launches})
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda", torch.cuda.current_device())
    for rec in measure(device):
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())


if __name__ == "__main__":
    main()
