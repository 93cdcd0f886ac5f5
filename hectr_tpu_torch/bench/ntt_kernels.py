"""K1/K2 on the card at the shapes the encrypted loops give them.

    python -m hectr_tpu_torch.bench.ntt_kernels

For each shape and kernel: the kernel held bit-equal to ``ntt_plain`` /
``intt_plain`` at every cluster size it accepts there, each cluster's
device time (``bench.cuda_graph_time_ms``: launches replayed from a CUDA
graph, so the wrappers' host time is left out) and how many such clusters
the card holds at once (``cudaOccupancyMaxActiveClusters``); the time at
the cluster ``ops.ntt_cuda.geometry`` picks, the plain version's time
(CUDA events), the bound (``bench.ntt_bound``) and the kernel's share of
it.  The per-cluster times are what ``geometry``'s choice is held to.  One
JSON line per shape and kernel, the card's name and power limit last.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import torch

from hectr_tpu_torch.bench import (cuda_graph_time_ms, cuda_time_ms,
                                   lazy_mult_peak_per_s, ntt_bound)

# (label, batch + (L,), preset in hectr_tpu_torch.config): the launches of
# one FLAGSHIP step (keyswitch decomposition and mod-down, encode/encrypt,
# decode), FLAGSHIP_QP's widest digit stacks (544 and 364 rows: more than
# the 264 rows that fill the card at two CTAs an SM), the REFERENCE_HEMPC
# and MEDIUM digit stacks, and the batched steps' launches: the fused
# FLAGSHIP regulator over 8 and 16 loops, the constrained FLAGSHIP_QP one
# over 4, the reference-shaped one over 64 loops at REFERENCE_HEMPC (one
# launch carries every loop's rows)
SHAPES = (
    ("flagship digit stack", (11, 24), "FLAGSHIP"),
    ("flagship mod-down", (2, 22), "FLAGSHIP"),
    ("flagship encode/encrypt/decompose/decode", (22,), "FLAGSHIP"),
    ("flagship special mod-down", (2, 2), "FLAGSHIP"),
    ("flagship-qp digit stack", (16, 34), "FLAGSHIP_QP"),
    ("flagship-qp digit stack at 26 limbs", (13, 28), "FLAGSHIP_QP"),
    ("reference digit stack", (4, 5), "REFERENCE_HEMPC"),
    ("medium digit stack", (6, 14), "MEDIUM"),
    ("fused batch of 8: digit stack", (8, 11, 24), "FLAGSHIP"),
    ("fused batch of 16: digit stack", (16, 11, 24), "FLAGSHIP"),
    ("flagship-qp batch of 4: digit stack", (4, 16, 34), "FLAGSHIP_QP"),
    ("fused batch of 8: mod-down", (8, 2, 22), "FLAGSHIP"),
    ("fused batch of 8: encode/encrypt/decode", (8, 22), "FLAGSHIP"),
    ("reference batch of 64: digit stack", (64, 4, 5), "REFERENCE_HEMPC"),
    ("reference batch of 64: encode/encrypt/decode", (64, 4),
     "REFERENCE_HEMPC"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def shape_inputs(lead, preset, device, gen):
    """The first L primes of the preset's key-switch chain, their NTT
    tables, and uniform residues [*lead, N] with 0 and p-1 planted per
    row."""
    from hectr_tpu_torch import config
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ckks.context import make_context

    ctx = make_context(getattr(config, preset))
    primes = ctx.full_primes[:lead[-1]]
    t = T.ntt_tables(ctx.n, primes, device)
    rows = [torch.randint(0, p, (*lead[:-1], ctx.n), generator=gen,
                          device=device) for p in primes]
    a = torch.stack(rows, dim=-2)
    a[..., 0] = 0
    a[..., 1] = torch.tensor(primes, device=device) - 1
    return a, t


def measure(device) -> list[dict]:
    """One record per shape and kernel (see the module note)."""
    from hectr_tpu_torch.ckks import ntt as T
    from hectr_tpu_torch.ops import ntt_cuda as K

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    peak = lazy_mult_peak_per_s()
    records = []
    for label, lead, preset in SHAPES:
        a, t = shape_inputs(lead, preset, device, gen)
        logn = t.n.bit_length() - 1
        rows = a.numel() >> logn
        geom = K.geometry(rows, logn)
        bound, by = ntt_bound(rows, lead[-1], logn, peak)
        kernels = (("ntt", a, K.launch_fwd, T.ntt_plain),
                   ("intt", T.ntt(a, t), K.launch_inv, T.intt_plain))
        for name, x, launch, plain in kernels:
            want = plain(x, t)
            by_cluster = []
            for logc in range(K.max_log_cluster(logn) + 1):
                g = K.launch_geometry(logn, logc)
                call = functools.partial(launch, x, t, g)
                if not torch.equal(call(), want):
                    raise AssertionError(
                        f"{name} != plain at {label}, {g.cluster} CTAs a row")
                by_cluster.append({
                    "cluster": g.cluster, "threads": g.threads,
                    "ms": cuda_graph_time_ms(call),
                    "max_active_clusters": K.max_active_clusters(
                        name == "ntt", g)})
            ms = by_cluster[geom.logc]["ms"]
            records.append({
                "kernel": name, "shape": [*lead, 1 << logn], "label": label,
                "rows": rows, "cluster": geom.cluster,
                "threads": geom.threads, "smem": geom.smem,
                "passes": list(geom.passes), "ms": ms,
                "plain_ms": cuda_time_ms(lambda: plain(x, t), reps=3,
                                         warmup=1),
                "bound_ms": bound, "bound_by": by,
                "share_of_bound": bound / ms,
                "fastest_cluster": min(by_cluster,
                                       key=lambda c: c["ms"])["cluster"],
                "by_cluster": by_cluster})
    return records


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: kernel times are device metrics")
    device = torch.device("cuda", torch.cuda.current_device())
    for rec in measure(device):
        print(json.dumps(rec), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "card": card_line(), "torch": torch.__version__}))


if __name__ == "__main__":
    main()
