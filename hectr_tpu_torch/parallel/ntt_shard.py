"""Coefficient-axis sharded negacyclic NTT, as
``hectr_tpu/parallel/ntt_shard.py``.

Shard the N coefficients into D contiguous chunks of C = N/D.  A
Cooley-Tukey stage with butterfly distance `half`:

  half >= C  (the first log2 D stages): the partner element lives on
      shard  s ^ (half/C).  Each shard computes its output from its own
      chunk and its partner's --
          u-shard:  out = u_own + S * v_recv
          v-shard:  out = u_recv - S * v_own
      The twiddle S is scalar per (limb, shard) at these stages because
      a butterfly group (2*half elements) spans whole chunks.  In plain
      PyTorch each stage is one ``mesh.ppermute`` and one
      ``exchange_stage_plain`` (``cross_stages_plain``).  On the card
      (``cross_stages``) the kernel K4, or K5 for the inverse, runs
      them: where every shard lies in one tensor (a local mesh) the
      partner is row s ^ d of the same tensor and one launch does all
      log2 D stages (``ops.ntt_exchange_cuda.exchange_local_cuda``);
      where a process holds one shard, each stage is one exchange of
      whole chunks and one launch on the chunk as it arrived
      (``exchange_recv_cuda``, reading the wire's int32 words).

  half < C  (the remaining log2 C stages): fully local.  They are
      exactly a negacyclic transform of size C over a gathered twiddle
      table: local index q = 2^j + i (stage j, 0 <= i < 2^j) reads the
      ring's table at (D + s) * 2^j + i for shard s.  So they run through
      ``ckks.ntt.ntt`` / ``intt`` on ``[..., L*S, C]`` rows, row l*S + i
      holding limb l of the i-th held shard: the CUDA kernels K1/K2 on a
      CUDA tensor, the plain stages on a CPU tensor, in one call for all
      the shards a process holds.

The inverse mirrors this: the local Gentleman-Sande stages first, then
log2 D cross-shard stages.  The local tables carry the whole ring's
N^-1, so the local pass applies it; every later operation is exact
mod p on canonical residues, so the result equals scaling last, bit for
bit.

Dispatch is by the tensor's device, as ``ckks.ntt``'s: a CUDA tensor
goes to K4/K5, which raise on what they do not take; a CPU tensor to
the plain stages.

Communication per transform: log2(D) chunk exchanges of C residues per
limb, the least a butterfly network needs without an all-to-all
re-layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hectr_tpu_torch.ckks.modmath import (add_mod_plain, mul_mod_shoup_plain,
                                          sub_mod_plain)
from hectr_tpu_torch.ckks.ntt import NTTTables, intt, ntt, ntt_tables

# K1 (ntt_fwd) at [11, 24, 2^15] on an NVIDIA H100 80GB HBM3 at 700.00 W:
# 0.0828 ms by CUDA-graph replay (python -m
# hectr_tpu_torch.bench.ntt_kernels; PERF.md section 6), over its 264 rows
T_LIMB_NTT_LOGN15_US = 0.0828e3 / 264
# residues travel between processes as int32 (ProcessMesh)
WIRE_BYTES = 4


def local_table_index(n: int, size: int, shards) -> np.ndarray:
    """[S, C] int64: where entry q of a held shard's size-C twiddle table
    lies in the ring's table, (D + s) * 2^j + i for q = 2^j + i.  Entry 0
    is read by no stage and points at 0."""
    C = n // size
    q = np.arange(C, dtype=np.int64)
    top = np.ones(C, dtype=np.int64)          # 2^floor(log2 q)
    for j in range(1, C.bit_length()):
        top[q >> j > 0] = 1 << j
    s = np.asarray(shards, dtype=np.int64)[:, None]
    g = q + (size + s - 1) * top
    g[:, 0] = 0
    return g


@functools.lru_cache(maxsize=None)
def _local_tables(n: int, primes: tuple[int, ...], size: int,
                  shards: tuple[int, ...], device: torch.device) -> NTTTables:
    t = ntt_tables(n, primes, device)
    S = len(shards)
    idx = torch.from_numpy(local_table_index(n, size, shards)).to(device)

    def rows(table):              # [L, N] -> [L*S, C], row l*S + i
        return table[:, idx].flatten(0, 1).contiguous()

    def per_limb(v):              # [L, ...] -> [L*S, ...]
        return v.repeat_interleave(S, dim=0)

    return NTTTables(
        n=n // size, primes=tuple(p for p in primes for _ in shards),
        device=device, p=per_limb(t.p), mu=per_limb(t.mu), k=per_limb(t.k),
        psi_rev=rows(t.psi_rev), psi_rev_shoup=rows(t.psi_rev_shoup),
        psi_inv_rev=rows(t.psi_inv_rev),
        psi_inv_rev_shoup=rows(t.psi_inv_rev_shoup),
        n_inv=per_limb(t.n_inv), n_inv_shoup=per_limb(t.n_inv_shoup),
        p32=per_limb(t.p32), psi_rev32=rows(t.psi_rev32),
        psi_rev_shoup32=rows(t.psi_rev_shoup32),
        psi_inv_rev32=rows(t.psi_inv_rev32),
        psi_inv_rev_shoup32=rows(t.psi_inv_rev_shoup32),
        n_inv32=per_limb(t.n_inv32), n_inv_shoup32=per_limb(t.n_inv_shoup32),
    )


def local_tables(t: NTTTables, mesh) -> NTTTables:
    """The tables of the shard-local transform of size C = N/D for the
    shards `mesh` holds here: `t`'s twiddles gathered by
    ``local_table_index``, limbs repeated once per held shard, and the
    whole ring's N^-1.  Cached per (n, primes, D, shards, device); the
    tables are as large as the ring's own and stay on the device until
    ``clear_local_tables``."""
    return _local_tables(t.n, t.primes, mesh.size, tuple(mesh.shards),
                         t.device)


def clear_local_tables() -> None:
    """Drop every cached local table and cross-shard twiddle (a program
    that is done with a ring or a mesh size gets their device memory
    back; they are rebuilt at the next use)."""
    _local_tables.cache_clear()
    _exchange_constants.cache_clear()


@functools.lru_cache(maxsize=None)
def _exchange_constants(n: int, primes: tuple[int, ...], size: int,
                        shards: tuple[int, ...], device: torch.device):
    """Per cross-shard stage, butterfly distance in chunks from D/2 down
    to 1: (dist, is_u [S, 1], forward twiddle and companion [L, S, 1],
    inverse twiddle and companion).  The forward pass walks the list
    front to back, the inverse back to front."""
    t = ntt_tables(n, primes, device)
    s = torch.tensor(shards, dtype=torch.int64, device=device)
    out = []
    m, d = 1, size // 2
    while d >= 1:
        idx = m + s // (2 * d)
        out.append((d, ((s // d) % 2 == 0)[:, None],
                    t.psi_rev[:, idx, None], t.psi_rev_shoup[:, idx, None],
                    t.psi_inv_rev[:, idx, None],
                    t.psi_inv_rev_shoup[:, idx, None]))
        m *= 2
        d //= 2
    return tuple(out)


def exchange_stage_plain(own: torch.Tensor, recv: torch.Tensor, w, w_shoup,
                         is_u, p, inverse: bool) -> torch.Tensor:
    """One cross-shard stage against the partner's chunk, in plain
    PyTorch: the reference of K4/K5's received form.  own: int64
    ``[..., L, S, C]``; recv: what each shard received from its partner,
    int64 or the wire's int32 bit patterns; w, w_shoup [L, S, 1] the
    stage's twiddles, is_u [S, 1], p [L, 1, 1].
      forward:  u-shard u + S v_recv,  v-shard u_recv - S v_own
      inverse:  u-shard u + v_recv,    v-shard (u_recv - v_own) S"""
    recv = recv.to(own.dtype)
    if inverse:
        return torch.where(is_u, add_mod_plain(own, recv, p),
                           mul_mod_shoup_plain(sub_mod_plain(recv, own, p), w,
                                               w_shoup, p))
    sv_own = mul_mod_shoup_plain(own, w, w_shoup, p)
    sv_recv = mul_mod_shoup_plain(recv, w, w_shoup, p)
    return torch.where(is_u, add_mod_plain(own, sv_recv, p),
                       sub_mod_plain(recv, sv_own, p))


def cross_stages_plain(x: torch.Tensor, t: NTTTables, mesh,
                       inverse: bool) -> torch.Tensor:
    """Every cross-shard stage of the ring of `t` on the shards `mesh`
    holds here, in plain PyTorch: one ``exchange_stage_plain`` against
    ``mesh.ppermute`` a stage, in ``_exchange_constants``' order (the
    inverse back to front).  x: int64 ``[..., L, S, C]``.  On a local
    mesh the partner at distance d is row s ^ d of the same tensor, so
    nothing travels; this is the CPU path of both mesh kinds and the
    reference of K4/K5's local form.  Collective on a process mesh."""
    S = len(mesh.shards)
    if x.shape[-2] != S or mesh.size * x.shape[-1] != t.n:
        raise ValueError(f"expected [..., {len(t.primes)}, {S}, "
                         f"{t.n // mesh.size}], got {tuple(x.shape)}")
    stages = _exchange_constants(t.n, t.primes, mesh.size,
                                 tuple(mesh.shards), x.device)
    pcol = t.p[..., None]                                  # [L, 1, 1]
    for d, is_u, w, wsh, wi, wish in (reversed(stages) if inverse
                                      else stages):
        tw = (wi, wish) if inverse else (w, wsh)
        x = exchange_stage_plain(x, mesh.ppermute(x, d), *tw, is_u, pcol,
                                 inverse)
    return x


def cross_stages(x: torch.Tensor, t: NTTTables, mesh,
                 inverse: bool) -> torch.Tensor:
    """``cross_stages_plain``, dispatched by device: on a CUDA tensor
    K4 (forward) or K5 (inverse), the local form's one launch when
    every shard is here, else one received-form launch per exchange on
    the chunk as it arrives (``mesh.ppermute_wire``); on a CPU tensor
    the plain stages.  Collective on a process mesh."""
    if x.device.type != "cuda":
        return cross_stages_plain(x, t, mesh, inverse)
    from hectr_tpu_torch.ops.ntt_exchange_cuda import (exchange_local_cuda,
                                                       exchange_recv_cuda)

    if len(mesh.shards) == mesh.size:          # every shard here
        return (x if mesh.size == 1 else
                exchange_local_cuda(x.contiguous(), t, inverse))
    stages = _exchange_constants(t.n, t.primes, mesh.size,
                                 tuple(mesh.shards), x.device)
    for d, *_ in (reversed(stages) if inverse else stages):
        x = exchange_recv_cuda(x.contiguous(), mesh.ppermute_wire(x, d), t,
                               mesh.shards[0], d, inverse)
    return x


def local_ntt_fns(t: NTTTables, mesh):
    """(fwd_local, inv_local) on sharded tensors ``[..., L, S, C]``: L is
    `t`'s limb count, S the shards `mesh` holds in this process and
    C = N/D the chunk.  Exposed apart from ``make_sharded_ntt`` so whole
    scheme ops (rescale, negacyclic product, key-switch stages) chain
    several transforms on sharded operands."""
    n, D = t.n, mesh.size
    C = n // D
    if n % D or C < 2:
        raise ValueError(f"a ring of {n} over {D} shards leaves chunks "
                         f"of {n / D:g}; need at least 2")
    L, S = len(t.primes), len(mesh.shards)

    def check(x):
        if x.shape[-3:] != (L, S, C):
            raise ValueError(f"expected [..., {L}, {S}, {C}], "
                             f"got {tuple(x.shape)}")

    def fwd_local(x: torch.Tensor) -> torch.Tensor:
        check(x)
        x = cross_stages(x, t, mesh, False)
        rows = ntt(x.flatten(-3, -2), local_tables(t, mesh))
        return rows.unflatten(-2, (L, S))

    def inv_local(x: torch.Tensor) -> torch.Tensor:
        check(x)
        rows = intt(x.flatten(-3, -2), local_tables(t, mesh))
        return cross_stages(rows.unflatten(-2, (L, S)), t, mesh, True)

    return fwd_local, inv_local


def make_sharded_ntt(t: NTTTables, mesh):
    """(ntt_fn, intt_fn) taking global ``[..., L, N]`` tensors (the same
    on every process of a process mesh) to sharded ``[..., L, S, C]``
    results; ``mesh.gather`` makes them global again."""
    fwd_local, inv_local = local_ntt_fns(t, mesh)

    def ntt_fn(a):
        return fwd_local(mesh.shard(a))

    def intt_fn(a):
        return inv_local(mesh.shard(a))

    return ntt_fn, intt_fn


def ppermute_bytes_per_transform(n: int, limbs: int, D: int) -> int:
    """Bytes one shard sends (and receives) in one sharded [limbs, n]
    transform on a process mesh: log2(D) chunk exchanges x n/D residues x
    limbs x 4 bytes.  The port's residues are int64 tensors but are below
    2^31, and ``ProcessMesh`` sends them as int32.  On a local mesh
    nothing leaves the device."""
    if D <= 1:
        return 0
    return (D.bit_length() - 1) * (n // D) * WIRE_BYTES * limbs


def analytic_link_efficiency(logn: int, limbs: int, D: int, *, bw_gbs: float,
                             latency_us: float,
                             t_limb_us: float | None = None) -> dict:
    """Predicted scaling efficiency of one coefficient-sharded transform
    over D devices joined by links of `bw_gbs` GB/s one way and
    `latency_us` per exchange: checkable arithmetic, not a measurement.

      T_comp(D) = limbs * t_limb(logn) / D
      T_comm(D) = log2(D) * (latency + (n/D) * 4 B * limbs / bw)
      eff(D)    = T_comp(D) / (T_comp(D) + T_comm(D))

    t_limb defaults to ``T_LIMB_NTT_LOGN15_US`` scaled by N / 2^15: the
    kernel is bound by device memory (16 bytes per coefficient), so its
    time follows the bytes, and divides with the shard.  Each stage is
    one paired exchange of the whole local chunk; no overlap of compute
    with communication is assumed.

    This models sharding ONE transform's coefficient axis, the
    latency-bound regime.  Throughput workloads shard the limb and batch
    axes first (no communication inside a transform); coefficient
    sharding is for a ring that does not fit one device's kernel."""
    n = 1 << logn
    if t_limb_us is None:
        t_limb_us = T_LIMB_NTT_LOGN15_US * n / (1 << 15)
    t_comp = limbs * t_limb_us / D
    if D <= 1:
        return {"D": D, "efficiency": 1.0, "t_comp_us": t_comp,
                "t_comm_us": 0.0}
    bytes_per_stage = (n // D) * WIRE_BYTES * limbs
    t_comm = (D.bit_length() - 1) * (latency_us + bytes_per_stage
                                     / (bw_gbs * 1e3))      # GB/s -> B/us
    return {"D": D, "efficiency": round(t_comp / (t_comp + t_comm), 4),
            "t_comp_us": round(t_comp, 3), "t_comm_us": round(t_comm, 3),
            "bytes_per_device": ppermute_bytes_per_transform(n, limbs, D)}


def link_efficiency_table(limbs: int, *, bw_gbs: float, latency_us: float,
                          logns=(15, 16, 17), Ds=(2, 4, 8)) -> dict:
    """The prediction grid of ``analytic_link_efficiency`` and the cells
    that reach 70%, for the scaling record."""
    grid = {}
    crossover = []
    for logn in logns:
        row = {}
        for D in Ds:
            e = analytic_link_efficiency(logn, limbs, D, bw_gbs=bw_gbs,
                                         latency_us=latency_us)
            row[f"{D}dev"] = e["efficiency"]
            if e["efficiency"] >= 0.70:
                crossover.append(f"logN={logn},D={D}")
        grid[f"logn{logn}"] = row
    return {
        "model": (f"eff = T_comp/(T_comp+T_comm); T_comp = limbs*t_limb"
                  f"(logn)/D with t_limb(15) = {T_LIMB_NTT_LOGN15_US:.4f} us "
                  f"(K1 on an NVIDIA H100 80GB HBM3, 700 W), scaled by N; "
                  f"T_comm = log2(D)*({latency_us} us + (N/D)*4B*limbs / "
                  f"{bw_gbs} GB/s)"),
        "limbs": limbs,
        "predicted_efficiency": grid,
        "meets_70pct": crossover,
        "note": ("coefficient sharding of a single transform; limb and "
                 "batch sharding have no communication inside a "
                 "transform"),
    }
