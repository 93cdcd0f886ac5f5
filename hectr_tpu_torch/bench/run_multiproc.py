"""Run the process meshes for real: R ``torch.distributed`` ranks on this
host in a pod mesh of batch x limb x coeff = R
(``parallel.multihost.make_pod_mesh``), as the JAX package's
``scripts/run_multihost_cpu.py`` runs two ``jax.distributed`` processes.

    python -m hectr_tpu_torch.bench.run_multiproc [--ranks 2]
        [--batch 1] [--limb 1] [--device cuda] [--logn 15] [--limbs 4]
        [--preset reference-hempc] [--timeout 300] [--out record.json]

The launcher builds the CUDA kernels once (ranks must not race on the
library), takes a free port, starts the ranks as subprocesses and waits
for them with a time limit; a rank that fails or hangs fails the run and
every child is killed.  Each rank initialises the group
(``parallel.multihost.init_distributed``), builds the pod mesh and
asserts, on its own shard, bit-equality with the single-device port.

On its coefficient subgroup (when it has more than one rank, or when the
mesh is the coefficient axis alone):

  * the sharded NTT and its round trip at ``--logn`` x ``--limbs``;
  * ``negacyclic_mul`` over the preset's data chain;
  * ``rescale_pair``, ``rotate`` (r = 1) and the hoisted gemv (diagonals 0
    and 3) on a real ciphertext of the preset (keys from fixed seeds, the
    same on every rank);

and the paired chunk exchange, timed.  On the card the cross-shard
stages run K4/K5's received form (``ops.ntt_exchange_cuda``): the record
gives their launches by shape over the checks above, then holds them
against the plain stages (``cross_stages_plain``) on one chunk, and
profiles a few forward transforms a rank (host ms; device ms by kernel,
the transport's own kernels apart).

On its limb subgroup (when
``--batch`` or ``--limb`` exceeds 1): one closed-loop step of the
preset's reference-shaped regulator (BSGS rotation keys) over its batch
group's loops (``LOOPS_PER_GROUP`` each) with keys, materials and
ciphertexts sharded by row (``entry.limb_step``: x_next, u and every
ciphertext bit-equal on this rank's rows to the unsharded step).  Then
the global keys are freed and the step is timed again (mean of
``STEP_REPS``), with the bytes a step gathers by kind, the bytes of the
rotation keys' blocks this rank holds, its device memory (what it holds
for the sharded step, the peak of the timed steps, and the peak of the
check, global keys and unsharded reference included) and the rate of a
digit-stack gather.

With ``--device cuda`` every rank takes a card of its own over NCCL
where the host has that many; else the ranks share card 0 over gloo,
their tensors staged through the host, and the exchange rates say
nothing about a link between cards.  One JSON record is printed;
``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import gc
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
LOOPS_PER_GROUP = 2
GATHER_REPS = 10
STEP_REPS = 3


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worker(rank: int, port: int, ranks: int, device: str, logn: int,
           limbs: int, preset: str, batch: int = 1, limb: int = 1) -> None:
    import torch.distributed as dist

    from hectr_tpu_torch.parallel.multihost import (init_distributed,
                                                    make_pod_mesh)

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

    pod = make_pod_mesh(batch, limb, device=dev)
    record = {"rank": rank, "backend": dist.get_backend(),
              "pod": pod.describe(),
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")}
    if pod.coeff.size > 1 or batch == limb == 1:
        record.update(coeff_checks(pod.coeff, dev, logn, limbs, preset))
    if batch > 1 or limb > 1:
        record["limb_step"] = limb_checks(pod, dev, preset)
    print(RESULT_TAG + json.dumps(record), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def limb_checks(pod, dev, preset: str) -> dict:
    """One closed-loop step of the preset's regulator on this rank's limb
    subgroup, bit-equal to the unsharded step on its rows, then timed."""
    import torch.distributed as dist

    from hectr_tpu_torch.ckks import scheme as S
    from hectr_tpu_torch.ckks.context import make_context
    from hectr_tpu_torch.ckks.gemv import bsgs_rotations
    from hectr_tpu_torch.ckks.keyswitch import gen_rotation_keys
    from hectr_tpu_torch.config import PRESETS
    from hectr_tpu_torch.entry import limb_step
    from hectr_tpu_torch.hempc import hempc_init_state
    from hectr_tpu_torch.parallel.limb_ops import LimbOps

    ctx = make_context(PRESETS[preset])
    keys = S.keygen(ctx, S.TorchSampler(40, dev), dev)
    rot = gen_rotation_keys(ctx, keys, S.TorchSampler(41, dev),
                            rotations=bsgs_rotations(ctx.slots))
    ops = LimbOps(ctx, pod)
    loops = LOOPS_PER_GROUP * pod.shape["batch"]
    p = np.linspace(0.01, 0.02, loops).reshape(loops, 1, 1)
    p = np.split(p, pod.shape["batch"])[pod.batch_index]
    res = limb_step(ctx, keys, rot, ops, p, 50 + pod.batch_index, dev)
    key_block_bytes = sum(sum(ops.key_bytes(ops.shard_key(x)))
                          for x in rot.values())

    # the global keys go; the sharded regulator keeps its own blocks
    cuda = dev.type == "cuda"
    check_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del keys, rot
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else None

    # the sharded step again, timed (mean of STEP_REPS), its gathers
    # counted per step
    state = hempc_init_state(S.TorchSampler(7, dev), dev, (len(p),))
    ops.gathered.clear()
    _sync(dev)
    dist.barrier(group=pod.limb.group)
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        u, state = res["regulator"](state, *res["inputs"])
    _sync(dev)
    step_s = (time.perf_counter() - t0) / STEP_REPS
    step_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("non-finite u in the timed steps")

    # a digit-stack gather at the top level, timed
    k = ctx.max_limbs
    own = torch.zeros((len(p), ops.rows.data_sizes(k)[pod.limb.rank], ctx.n),
                      dtype=torch.int64, device=dev)
    sizes = ops.rows.data_sizes(k)
    pod.limb.gather((own,), sizes)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(GATHER_REPS):
        pod.limb.gather((own,), sizes)
    _sync(dev)
    gather_s = (time.perf_counter() - t0) / GATHER_REPS
    gather_bytes = len(p) * k * ctx.n * 4
    return {
        "preset": preset, "loops": len(p), "limb_mesh":
            pod.limb.describe(dev), "checked": res["checked"],
        "step_ms": step_s * 1e3, "gathered_bytes": {
            w: n // STEP_REPS for w, n in ops.gathered.items()},
        "key_block_bytes": key_block_bytes, "held_bytes": held,
        "step_peak_bytes": step_peak, "check_peak_bytes": check_peak,
        "gather_bytes": gather_bytes, "gather_gb_per_s":
            gather_bytes / gather_s / 1e9,
        "x_next": res["x"][:, -1].tolist(),
    }


def coeff_checks(mesh, dev, logn: int, limbs: int, preset: str) -> dict:
    """The sharded NTT and scheme ops on this rank's coefficient
    subgroup, bit-equal on its shard, and the paired exchange, timed."""
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
    from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
    from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
    from hectr_tpu_torch.parallel.ntt_shard import WIRE_BYTES, local_ntt_fns

    rank = mesh.rank
    EX.reset_launches()

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
    _sync(dev)
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(EXCHANGE_REPS):
        chunk = mesh.ppermute(chunk, 1)
    _sync(dev)
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
    _sync(dev)
    out = {"mesh": mesh.describe(dev), "exchange_bytes": exchange_bytes,
           "exchange_gb_per_s": exchange_bytes / exchange_s / 1e9}
    if dev.type == "cuda":
        # K4/K5's received form: its launches on the sharded transform
        # and the scheme ops above, then held against the plain stages
        out["exchange_launches"] = dict(EX.LAUNCHES)
        out["exchange_shapes"] = {
            f"{name} {form} {list(shape)}": count
            for (name, form, shape), count in sorted(EX.LAUNCH_SHAPES.items())}
        out["exchange_checked"] = received_form_checks(mesh, t,
                                                       mesh.shard(a))
        out["transform_profile"] = profile_transform(fwd, mesh.shard(a),
                                                     mesh, dev)
    return out


def received_form_checks(mesh, t, x) -> int:
    """K4/K5's received form (``ntt_shard.cross_stages`` on this rank's
    CUDA chunk x) against ``cross_stages_plain`` on the same chunk, each
    direction; returns the stages compared.  Collective: every rank of
    the mesh calls it."""
    from hectr_tpu_torch.parallel.ntt_shard import (cross_stages,
                                                    cross_stages_plain)

    for inverse in (False, True):
        if not torch.equal(cross_stages(x, t, mesh, inverse),
                           cross_stages_plain(x, t, mesh, inverse)):
            raise AssertionError(f"received form != plain on shard "
                                 f"{mesh.rank}, inverse={inverse}")
    return 2 * (mesh.size.bit_length() - 1)


PROFILED_TRANSFORMS = 5


def profile_transform(fwd, x, mesh, dev) -> dict:
    """``PROFILED_TRANSFORMS`` sharded forward transforms of this rank's
    chunk x under torch.profiler, after a warm call and a barrier: each
    one's host ms, and launches and device ms by kernel over all of them
    (the exchange's transport kernels apart from K4/K5 and K1).
    Collective: every rank calls it."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from hectr_tpu_torch.utils import pmu

    fwd(x)
    _sync(dev)
    dist.barrier(group=mesh.group)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        host_ms = []
        for _ in range(PROFILED_TRANSFORMS):
            t0 = time.perf_counter()
            fwd(x)
            _sync(dev)
            host_ms.append((time.perf_counter() - t0) * 1e3)
    us, launches = pmu.device_ops(prof.key_averages())
    kernels = {k[:72]: [launches[k], us[k] / 1e3] for k in us}
    return {"host_ms": host_ms, "device_ms_by_kernel": kernels}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(ranks: int = 2, device: str = "cuda", logn: int = 15,
           limbs: int = 4, preset: str = "reference-hempc",
           timeout: float = 300.0, batch: int = 1, limb: int = 1) -> dict:
    """Start `ranks` worker processes in a pod mesh of `batch` x `limb` x
    the rest, wait at most `timeout` seconds for all of them, and return
    the run's record.  Raises RuntimeError, with the ranks' output, if any
    rank failed, hung or reported nothing."""
    if ranks % (batch * limb):
        raise ValueError(f"{ranks} ranks do not split into batch {batch} x "
                         f"limb {limb}")
    if device == "cuda":
        from hectr_tpu_torch.ops import build

        build.build("ntt.cu", "ntt_exchange.cu")
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
                 "--preset", preset, "--batch", str(batch),
                 "--limb", str(limb)],
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
    results.sort(key=lambda r: r["rank"])
    first = results[0]
    record = {"kind": "multiproc_execution", "ranks": ranks, "ok": True,
              "device": first["device"], "backend": first["backend"],
              "pod": first["pod"], "bitexact_per_shard": True}
    if "mesh" in first:
        record.update({
            "mesh": first["mesh"], "ntt": f"logN={logn} x {limbs} limbs",
            "scheme_ops": f"negacyclic_mul, rescale_pair, rotate, gemv at "
                          f"{preset}",
            "exchange_bytes": first["exchange_bytes"],
            "exchange_gb_per_s": [r["exchange_gb_per_s"] for r in results]})
    if "exchange_launches" in first:
        record["exchange_launches"] = [r["exchange_launches"]
                                       for r in results]
        record["exchange_shapes"] = first["exchange_shapes"]
        record["exchange_checked"] = [r["exchange_checked"] for r in results]
        record["transform_profiles"] = [r["transform_profile"]
                                        for r in results]
    if "limb_step" in first:
        record["limb_steps"] = [r["limb_step"] for r in results]
    record["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return record


def main(argv=None) -> None:
    from hectr_tpu_torch.config import PRESETS

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--limb", type=int, default=1)
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
               args.limbs, args.preset, args.batch, args.limb)
        return
    try:
        record = launch(args.ranks, args.device, args.logn, args.limbs,
                        args.preset, args.timeout, args.batch, args.limb)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        raise SystemExit(1)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
