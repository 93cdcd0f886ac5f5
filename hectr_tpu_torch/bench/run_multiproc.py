"""Run the process mesh for real: R ``torch.distributed`` ranks on this
host, each holding one coefficient shard, as the JAX package's
``scripts/run_multihost_cpu.py`` runs two ``jax.distributed`` processes.

    python -m hectr_tpu_torch.bench.run_multiproc [--ranks 2]
        [--device cuda] [--logn 15] [--limbs 4] [--preset reference-hempc]
        [--timeout 300] [--out record.json]

The launcher builds the CUDA kernels once (ranks must not race on the
library), takes a free port, starts the ranks as subprocesses and waits
for them with a time limit; a rank that fails or hangs fails the run and
every child is killed.  Each rank initialises the group
(``parallel.multihost.init_distributed``), builds the mesh over all ranks
and asserts, on its own shard, bit-equality with the single-device port:

  * the sharded NTT and its round trip at ``--logn`` x ``--limbs``;
  * ``negacyclic_mul`` over the preset's data chain;
  * ``rescale_pair``, ``rotate`` (r = 1) and the hoisted gemv (diagonals 0
    and 3) on a real ciphertext of the preset (keys from fixed seeds, the
    same on every rank);

and times the paired chunk exchange.  With ``--device cuda`` every rank
takes a card of its own over NCCL where the host has that many; else
the ranks share card 0 over gloo, their chunks staged through the host,
and the exchange rate says nothing about a link between cards.  One JSON
record is printed; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
RESULT_TAG = "WORKER_RESULT "
EXCHANGE_REPS = 20


def worker(rank: int, port: int, ranks: int, device: str, logn: int,
           limbs: int, preset: str) -> None:
    import torch.distributed as dist

    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import make_gemv
    from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys, rotate
    from hectr_tpu_torch.ckks.ntt import (negacyclic_mul, ntt, ntt_plain,
                                          ntt_tables)
    from hectr_tpu_torch.ckks.primes import find_ntt_primes
    from hectr_tpu_torch.config import PRESETS
    from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.multihost import (init_distributed,
                                                    make_pod_mesh)
    from hectr_tpu_torch.parallel.ntt_shard import WIRE_BYTES, local_ntt_fns

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available on this machine")
    if not init_distributed(f"127.0.0.1:{port}", ranks, rank, device):
        raise RuntimeError("init_distributed returned False")
    if device == "cuda":
        # under NCCL init_distributed gave this rank a card of its own
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mesh = make_pod_mesh()
    if mesh.size != ranks or mesh.rank != rank:
        raise RuntimeError(f"mesh of {mesh.size}, rank {mesh.rank}")

    # --- the sharded NTT, bit-equal on this rank's shard ---------------
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, limbs, 2 * n))
    t = ntt_tables(n, primes, dev)
    rng = np.random.default_rng(0)     # same seed: same data on all ranks
    a = torch.from_numpy(rng.integers(
        0, np.array(primes).reshape(-1, 1), size=(limbs, n))).to(dev)
    fwd, inv = local_ntt_fns(t, mesh)
    got = fwd(mesh.shard(a))
    whole = dev.type == "cpu" or logn <= MAX_LOGN
    ref = ntt(a, t) if whole else ntt_plain(a, t)
    if not torch.equal(got, mesh.shard(ref)):
        raise AssertionError(f"NTT shard {rank} diverged")
    if not torch.equal(inv(got), mesh.shard(a)):
        raise AssertionError(f"NTT round trip diverged on shard {rank}")

    # --- the paired chunk exchange, timed -------------------------------
    chunk = mesh.shard(a)
    mesh.ppermute(chunk, 1)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(EXCHANGE_REPS):
        chunk = mesh.ppermute(chunk, 1)
    sync()
    exchange_s = (time.perf_counter() - t0) / EXCHANGE_REPS
    exchange_bytes = chunk.numel() * WIRE_BYTES

    # --- sharded scheme ops over the preset's chain ---------------------
    ctx = make_context(PRESETS[preset])
    k = ctx.max_limbs
    cops = CoeffOps(ctx, mesh)
    tt = ctx.tables(k, dev)
    pcol = np.array(ctx.data_primes[:k]).reshape(-1, 1)
    b1, b2 = (torch.from_numpy(rng.integers(0, pcol, size=(k, ctx.n))).to(dev)
              for _ in range(2))
    if not torch.equal(cops.negacyclic_mul(cops.shard(b1), cops.shard(b2)),
                       cops.shard(negacyclic_mul(b1, b2, tt))):
        raise AssertionError(f"negacyclic shard {rank} diverged")

    keys = S.keygen(ctx, S.TorchSampler(40, dev), dev)
    rot = gen_rotation_keys(ctx, keys, S.TorchSampler(41, dev),
                            rotations=[1, 3])
    v = torch.linspace(-1.0, 1.0, ctx.slots, dtype=torch.float64, device=dev)
    ct = S.encrypt(ctx, keys, S.encode(ctx, (v, torch.zeros_like(v)), k),
                   S.TorchSampler(42, dev))

    def sharded(c):
        return S.Ciphertext(data=cops.shard(c.data), scale=c.scale)

    def same(got_ct, want_ct, what):
        if (got_ct.scale != want_ct.scale
                or not torch.equal(got_ct.data, cops.shard(want_ct.data))):
            raise AssertionError(f"{what} diverged on shard {rank}")

    pt2 = S.encode(ctx, (torch.full_like(v, 2.0), torch.zeros_like(v)), k,
                   scale=ctx.pair_scale(k))
    prod = S.mul_pt(ctx, ct, pt2)
    same(cops.rescale_pair(sharded(prod)), S.rescale_pair(ctx, prod),
         "rescale_pair")
    same(cops.rotate(sharded(ct), 1, rot), rotate(ctx, ct, 1, rot), "rotate")
    M = np.zeros((ctx.slots, ctx.slots))
    idx = np.arange(ctx.slots)
    M[idx, idx] = 0.5
    M[idx, (idx + 3) % ctx.slots] = -0.25
    same(cops.make_gemv(M, k, rot, dev)(sharded(ct)),
         make_gemv(ctx, M, k, rot, dev, method="diag")(ct), "gemv")
    sync()

    print(RESULT_TAG + json.dumps({
        "rank": rank, "mesh": mesh.describe(dev), "backend": mesh.backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "exchange_bytes": exchange_bytes,
        "exchange_gb_per_s": exchange_bytes / exchange_s / 1e9,
    }), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(ranks: int = 2, device: str = "cuda", logn: int = 15,
           limbs: int = 4, preset: str = "reference-hempc",
           timeout: float = 300.0) -> dict:
    """Start `ranks` worker processes, wait at most `timeout` seconds for
    all of them, and return the run's record.  Raises RuntimeError, with
    the ranks' output, if any rank failed, hung or reported nothing."""
    if device == "cuda":
        from hectr_tpu_torch.ops import build

        build.build("ntt.cu")
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("HECTR_COORDINATOR", "HECTR_NUM_PROCS",
                        "HECTR_PROC_ID")}
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(ranks)]
    procs = []
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "hectr_tpu_torch.bench.run_multiproc",
                 "--worker", str(r), "--port", str(port),
                 "--ranks", str(ranks), "--device", device,
                 "--logn", str(logn), "--limbs", str(limbs),
                 "--preset", preset],
                stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        deadline = time.monotonic() + timeout
        hung = False
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    results = [json.loads(line[len(RESULT_TAG):]) for out in outs
               for line in out.splitlines() if line.startswith(RESULT_TAG)]
    ok = (not hung and all(p.returncode == 0 for p in procs)
          and sorted(r["rank"] for r in results) == list(range(ranks)))
    if not ok:
        detail = "\n".join(f"----- rank {r} (rc={p.returncode}) -----\n{out}"
                           for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{ranks}-rank run failed"
                           f"{' (time limit)' if hung else ''}:\n{detail}")
    first = min(results, key=lambda r: r["rank"])
    return {
        "kind": "multiproc_execution", "ranks": ranks, "ok": True,
        "device": first["device"], "backend": first["backend"],
        "mesh": first["mesh"], "ntt": f"logN={logn} x {limbs} limbs",
        "scheme_ops": f"negacyclic_mul, rescale_pair, rotate, gemv at "
                      f"{preset}",
        "bitexact_per_shard": True,
        "exchange_bytes": first["exchange_bytes"],
        "exchange_gb_per_s": [r["exchange_gb_per_s"] for r in
                              sorted(results, key=lambda r: r["rank"])],
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None) -> None:
    from hectr_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--logn", type=int, default=15)
    ap.add_argument("--limbs", type=int, default=4)
    ap.add_argument("--preset", default="reference-hempc",
                    choices=sorted(PRESETS))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.port, args.ranks, args.device, args.logn,
               args.limbs, args.preset)
        return
    try:
        record = launch(args.ranks, args.device, args.logn, args.limbs,
                        args.preset, args.timeout)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
