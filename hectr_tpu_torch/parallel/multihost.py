"""Multi-process scale-out: ``torch.distributed`` initialisation, the
pod mesh over its ranks, and the NTT scaling-efficiency harness, as
``hectr_tpu/parallel/multihost.py``.

One process per device (or per host): every process sets
HECTR_COORDINATOR (``host:port`` of rank 0), HECTR_NUM_PROCS and
HECTR_PROC_ID, calls ``init_distributed()``, builds the mesh with
``make_pod_mesh(batch, limb, coeff)`` and runs the same per-shard
functions a local mesh runs (``parallel.ntt_shard`` / ``coeff_ops`` on
its coefficient subgroup, ``parallel.limb_ops`` on its limb subgroup).
The harness measures whatever mesh it is given; on a local mesh (all
shards on one device) its number says what sharding costs there, not
what a link would carry.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from hectr_tpu_torch.ckks.ntt import ntt, ntt_tables
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.config import resolve_device
from hectr_tpu_torch.ops.ntt_cuda import MAX_LOGN
from hectr_tpu_torch.parallel import Mesh, ProcessLimbMesh, ProcessMesh
from hectr_tpu_torch.parallel.ntt_shard import (
    local_ntt_fns,
    ppermute_bytes_per_transform,
)


def _backend(device: torch.device, num_processes: int) -> str:
    """NCCL where the ranks compute on cards and this host has one for
    each of them; else gloo, which carries CPU tensors and, staged through
    the host by ``ProcessMesh``, the CUDA tensors of ranks sharing a
    card."""
    own_card = (device.type == "cuda" and dist.is_nccl_available()
                and torch.cuda.device_count() >= num_processes)
    return "nccl" if own_card else "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> bool:
    """Initialise ``torch.distributed`` for multi-process execution.

    Arguments default from the environment (HECTR_COORDINATOR,
    HECTR_NUM_PROCS, HECTR_PROC_ID); returns False (no-op) when no
    coordinator is configured: single-process runs need nothing.  Safe
    to call twice.  `device` is where the ranks' tensors will lie and
    decides the backend (``_backend``); under NCCL the process takes
    card ``process_id mod device_count`` as its current device before
    the group forms."""
    coordinator = coordinator or os.environ.get("HECTR_COORDINATOR")
    if not coordinator:
        return False
    if dist.is_initialized():
        return True
    num_processes = num_processes or int(os.environ.get("HECTR_NUM_PROCS", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("HECTR_PROC_ID", "0"))
    backend = _backend(torch.device(device), num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def make_pod_mesh(batch: int = 1, limb: int = 1,
                  coeff: int | None = None, device="cuda") -> Mesh:
    """A batch x limb x coeff mesh over every rank of the initialised
    default group (every host's, after ``init_distributed``), ranks in
    the order batch > limb > coeff: rank = (b * limb + l) * coeff + c, as
    the JAX package orders its devices.  `coeff` None takes what the
    world leaves; it must be a power of two, `batch` and `limb` need not
    be.  Every rank creates every subgroup, in the same order.  The
    result holds this rank's batch index, its ``ProcessLimbMesh`` (the
    `limb` ranks that share its b and c) and its ``ProcessMesh`` (the
    `coeff` ranks that share its b and l).  `device`: where this rank's
    tensors lie ("cuda": its current card, the one ``init_distributed``
    gave it under NCCL); placing a tensor from elsewhere raises."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if batch < 1 or limb < 1:
        raise ValueError(f"batch {batch} and limb {limb} must be positive")
    if coeff is None:
        if world % (batch * limb):
            raise ValueError(f"{world} ranks do not split into batch {batch} "
                             f"x limb {limb}")
        coeff = world // (batch * limb)
    if batch * limb * coeff != world:
        raise ValueError(f"a pod mesh of {batch} x {limb} x {coeff} over "
                         f"{world} ranks")
    b, rest = divmod(rank, limb * coeff)
    l, c = divmod(rest, coeff)

    def rank_of(bi, li, ci):
        return (bi * limb + li) * coeff + ci

    limb_group = coeff_group = None
    for bi in range(batch):
        for ci in range(coeff):
            g = dist.new_group([rank_of(bi, li, ci) for li in range(limb)])
            if (bi, ci) == (b, c):
                limb_group = g
    for bi in range(batch):
        for li in range(limb):
            g = dist.new_group([rank_of(bi, li, ci) for ci in range(coeff)])
            if (bi, li) == (b, l):
                coeff_group = g
    return Mesh(shape={"batch": batch, "limb": limb, "coeff": coeff},
                limb=ProcessLimbMesh(limb_group), device=resolve_device(device),
                batch_index=b, coeff=ProcessMesh(coeff_group))


def ntt_scaling_efficiency(logn: int, limbs: int, mesh, device,
                           iters: int = 8) -> dict:
    """Measure the D-way coefficient-sharded NTT of `mesh` against the
    single-device transform on `device` and report the scaling
    efficiency (speedup / D) plus the analytic exchange traffic.

    On a process mesh of cards joined by links it is the scaling metric
    itself; on a local mesh or on ranks sharing a device it is a
    stand-in.  A ring above 2^15 has no single-device transform on a
    card (one kernel row holds at most 2^15): the single-device fields
    are then None and ``single_dev`` says why."""
    device = resolve_device(device)
    n = 1 << logn
    D = mesh.size
    primes = tuple(find_ntt_primes(30, limbs, 2 * n))
    t = ntt_tables(n, primes, device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(
        0, np.array(primes).reshape(-1, 1), size=(limbs, n))).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def rate(fn, x):
        # the first call may build and load the kernels, at each rank's own
        # pace; the second brings the ranks of a process mesh back in step
        r = fn(fn(x))
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(r)   # output feeds input: valid residues every time
        sync()
        return iters / (time.perf_counter() - t0)

    fwd_local, _ = local_ntt_fns(t, mesh)
    rD = rate(fwd_local, mesh.shard(a))
    if device.type == "cuda" and logn > MAX_LOGN:
        r1 = speedup = None
        single = (f"none: a ring of 2^{logn} exceeds one kernel row "
                  f"(2^{MAX_LOGN})")
    else:
        r1 = rate(lambda x: ntt(x, t), a)
        speedup = rD / r1
        single = "ckks.ntt.ntt"
    return {
        "logn": logn, "limbs": limbs, "devices": D,
        "single_dev_ntt_per_s": r1, "sharded_ntt_per_s": rD,
        "speedup": speedup,
        "efficiency": None if speedup is None else speedup / D,
        "ppermute_bytes_per_transform":
            ppermute_bytes_per_transform(n, limbs, D),
        "single_dev": single, "mesh": mesh.describe(device),
    }
