"""Meshes for the CKKS compute path: the coefficient axis, the limb axis
and the batch axis.

The JAX package shards arrays over a ``jax.sharding.Mesh`` and lets
GSPMD or ``shard_map`` derive the collectives (``hectr_tpu/parallel/``).
PyTorch has no such partitioner, so a mesh here is an object the
per-shard functions talk to, and every exchange is written out.

Coefficient meshes split the coefficient axis of a ring of N into D
contiguous chunks of C = N/D.  They answer which shards this process
holds (``shards``), how a global tensor becomes this process's part and
back (``shard``, ``gather``), and how a shard reaches its partner
``s ^ dist`` in a butterfly stage that crosses chunks (``ppermute``).  A
sharded tensor carries its shards on an explicit axis, ``[..., S, C]``
with S = ``len(mesh.shards)``:

  * ``LocalMesh(D)``: all D shards of one tensor on one device, S = D.
    ``[..., N]`` viewed as ``[..., D, C]`` costs nothing, ``ppermute``
    is an index flip on the D axis.  The counterpart of the virtual CPU
    devices the JAX package's tests run on; it also runs on one card at
    full width, where it carries rings larger than one kernel row.
  * ``ProcessMesh(group=None)``: one shard per rank of a
    ``torch.distributed`` group (the default group when None), S = 1.
    ``ppermute`` is one paired send and receive with the rank
    ``r ^ dist``; ``gather`` is an all-gather.

Limb meshes split the RNS rows (the JAX package's "limb" axis, its
tensor-parallel analogue).  A limb mesh of D shards owns the rows of the
top-level extended chain, the K data rows then the S special rows, in D
contiguous blocks (``LimbRows``); a tensor at level k holds the rows of
[0, k) its block covers, so a shard may hold none.  Shards are carried
as a tuple of per-shard tensors (uneven blocks are no single view):

  * ``LocalLimbMesh(D)``: all D shards on one device; ``gather`` is a
    ``cat`` in row order.
  * ``ProcessLimbMesh(group=None)``: one shard per rank of a group;
    ``gather`` is an all-gather in row order (contributions padded to the
    largest, int32 on the wire), or a broadcast where one shard holds
    every row gathered.

The per-shard functions run on both kinds: ``parallel.ntt_shard`` and
``parallel.coeff_ops`` on coefficient meshes, ``parallel.limb_ops`` on
limb meshes.  ``make_mesh(batch, limb)`` is the batch x limb mesh of one
process (the batch axis is the leading dim every op takes);
``multihost.make_pod_mesh`` builds batch x limb x coeff over ranks.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist

from hectr_tpu_torch.config import resolve_device


def _check_size(size: int) -> None:
    if size < 1 or size & (size - 1):
        raise ValueError(f"a coefficient mesh has a power-of-two size, "
                         f"got {size}")


class LocalMesh:
    """D coefficient shards of one tensor, all on that tensor's device."""

    def __init__(self, size: int):
        _check_size(size)
        self.size = size
        self.shards = tuple(range(size))

    def describe(self, device) -> str:
        return f"local mesh, {self.size} shards on {torch.device(device)}"

    def shard(self, a: torch.Tensor) -> torch.Tensor:
        """Global ``[..., N]`` -> ``[..., D, C]`` (a view)."""
        return a.unflatten(-1, (self.size, a.shape[-1] // self.size))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., D, C]`` -> global ``[..., N]``."""
        return x.flatten(-2)

    def ppermute(self, x: torch.Tensor, dist_: int) -> torch.Tensor:
        """What each shard s receives from shard ``s ^ dist_``."""
        half = self.size // (2 * dist_)
        pairs = x.unflatten(-2, (half, 2, dist_))
        return pairs.flip(-3).flatten(-4, -2)


class _Ranks:
    """One shard per rank of a ``torch.distributed`` group, and how a
    tensor travels between them.

    The transport follows from the group's backend and the tensor's
    device: NCCL sends device tensors as they are (each rank a card of
    its own); gloo sends CPU tensors as they are and stages a CUDA
    tensor through a pinned host buffer (several ranks sharing one card,
    where NCCL refuses to run).  Residues are below 2^31, so they travel
    as int32 and are widened on arrival."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised "
                               "(parallel.multihost.init_distributed)")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shards = (self.rank,)
        self.backend = dist.get_backend(group)
        self._pinned: dict = {}     # host staging buffers, by (role, shape)

    def _global(self, rank: int) -> int:
        """A rank of the group as the default group numbers it."""
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def _staged(self, device) -> bool:
        device = torch.device(device)
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError("an NCCL mesh moves CUDA tensors only")
            return False
        return device.type == "cuda"

    def _host(self, role: str, shape) -> torch.Tensor:
        key = (role, tuple(shape))
        if key not in self._pinned:
            self._pinned[key] = torch.empty(key[1], dtype=torch.int32,
                                            pin_memory=True)
        return self._pinned[key]

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """x as it travels: int32, on the host where the transport is
        staged (a blocking copy, so the buffer may be reused)."""
        wire = x.to(torch.int32).contiguous()
        if self._staged(x.device):
            return self._host("send", wire.shape).copy_(wire)
        return wire

    def _recv(self, shape, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for int32 residues headed for like's device."""
        if self._staged(like.device):
            return self._host("recv", shape)
        return torch.empty(shape, dtype=torch.int32, device=like.device)


class ProcessMesh(_Ranks):
    """One coefficient shard per rank of a ``torch.distributed`` group
    (the default group when `group` is None); the group's size must be a
    power of two."""

    def __init__(self, group=None):
        super().__init__(group)
        _check_size(self.size)

    def describe(self, device) -> str:
        device = torch.device(device)
        how = ", host-staged" if self._staged(device) else ""
        return (f"process mesh, {self.backend}{how}, {self.size} ranks, "
                f"rank {self.rank} on {device}")

    def shard(self, a: torch.Tensor) -> torch.Tensor:
        """Global ``[..., N]`` (the same on every rank) -> this rank's
        chunk ``[..., 1, C]``."""
        return a.unflatten(-1, (self.size, -1))[..., self.rank:self.rank + 1,
                                                :].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather: every rank's ``[..., 1, C]`` -> global ``[..., N]``
        on every rank."""
        send = self._wire(x)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, dim=-2).to(x.device).to(x.dtype).flatten(-2)

    def ppermute_wire(self, x: torch.Tensor, dist_: int) -> torch.Tensor:
        """This rank's chunk goes to rank ``r ^ dist_``, whose chunk
        comes back as it travels: int32 residues on x's device (the
        receive buffer itself under NCCL; copied off the host where the
        transport is staged).  One paired isend/irecv."""
        peer = self._global(self.rank ^ dist_)
        send = self._wire(x)
        recv = self._recv(send.shape, x)
        ops = [dist.P2POp(dist.isend, send, peer, self.group),
               dist.P2POp(dist.irecv, recv, peer, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device)

    def ppermute(self, x: torch.Tensor, dist_: int) -> torch.Tensor:
        """``ppermute_wire`` widened to x's dtype."""
        return self.ppermute_wire(x, dist_).to(x.dtype)


# ---------------------------------------------------------------------------
# the limb axis
# ---------------------------------------------------------------------------


class LimbRows:
    """Which rows of the extended chain each of D limb shards owns: D
    contiguous blocks of the K + S top-level rows (data rows 0..K-1, then
    the special rows), the first (K + S) mod D blocks one row longer.
    The map is the same at every level, so a level-k tensor's shard holds
    the rows of [0, k) its block covers and a top-level switching key's
    shard serves every level."""

    def __init__(self, data: int, special: int, size: int):
        if size < 1:
            raise ValueError(f"a limb mesh has at least one shard, got {size}")
        self.data, self.special, self.size = data, special, size
        edges = np.cumsum([0] + [len(b) for b in np.array_split(
            np.arange(data + special), size)])
        self.blocks = tuple((int(lo), int(hi))
                            for lo, hi in zip(edges[:-1], edges[1:]))

    def data_rows(self, s: int, k: int) -> tuple[int, int]:
        """Shard s's data rows [lo, hi) at level k."""
        lo, hi = self.blocks[s]
        return min(lo, k), min(hi, k)

    def special_rows(self, s: int) -> tuple[int, int]:
        """Shard s's special rows [lo, hi), counted from the first."""
        lo, hi = self.blocks[s]
        return max(lo, self.data) - self.data, max(hi, self.data) - self.data

    def data_sizes(self, k: int) -> list[int]:
        return [hi - lo for lo, hi in (self.data_rows(s, k)
                                       for s in range(self.size))]

    def special_sizes(self) -> list[int]:
        return [hi - lo for lo, hi in (self.special_rows(s)
                                       for s in range(self.size))]

    def key_index(self, s: int, k: int) -> torch.Tensor | None:
        """Rows of shard s's top-level key block that a level-k key
        keeps (its data rows below k, its special rows); None: all."""
        lo, hi = self.blocks[s]
        n_data = self.data_rows(s, k)[1] - self.data_rows(s, k)[0]
        first_special = min(max(lo, self.data), hi) - lo
        if n_data == first_special:
            return None
        return torch.cat([torch.arange(n_data),
                          torch.arange(first_special, hi - lo)])


class LocalLimbMesh:
    """D limb shards, all on one device: a tuple of D tensors."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a limb mesh has at least one shard, got {size}")
        self.size = size
        self.shards = tuple(range(size))

    def describe(self, device) -> str:
        return f"local limb mesh, {self.size} shards on {torch.device(device)}"

    def gather(self, parts, sizes) -> torch.Tensor:
        """Every shard's rows ``[..., sizes[s], M]`` -> ``[..., sum, M]``
        in row order."""
        return torch.cat(parts, dim=-2)


class ProcessLimbMesh(_Ranks):
    """One limb shard per rank of a ``torch.distributed`` group (the
    default group when `group` is None); any number of ranks."""

    def describe(self, device) -> str:
        device = torch.device(device)
        how = ", host-staged" if self._staged(device) else ""
        return (f"process limb mesh, {self.backend}{how}, {self.size} ranks, "
                f"rank {self.rank} on {device}")

    def gather(self, parts, sizes) -> torch.Tensor:
        """This rank's rows ``parts[0]`` ``[..., sizes[rank], M]`` -> every
        rank's, ``[..., sum(sizes), M]`` in row order on every rank.  One
        broadcast where a single rank holds rows, else one all-gather of
        contributions padded to the largest."""
        (x,) = parts
        lead, width = x.shape[:-2], x.shape[-1]
        holders = [r for r, n in enumerate(sizes) if n]
        if len(holders) == 1:
            owner = holders[0]
            buf = (self._wire(x) if owner == self.rank
                   else self._recv((*lead, sizes[owner], width), x))
            dist.broadcast(buf, self._global(owner), group=self.group)
            return buf.to(x.device).to(x.dtype)
        most = max(sizes)
        if x.shape[-2] < most:
            x = torch.cat([x, x.new_zeros((*lead, most - x.shape[-2], width))],
                          dim=-2)
        send = self._wire(x)
        got = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(got, send, group=self.group)
        out = torch.cat([g[..., :n, :] for g, n in zip(got, sizes)], dim=-2)
        return out.to(parts[0].device).to(parts[0].dtype)


# ---------------------------------------------------------------------------
# batch x limb (x coeff) meshes and the sharding helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes this process takes part in: ``shape`` maps each axis name
    to its size, outermost first (as ``jax.sharding.Mesh.shape``).
    `batch_index` is this process's position on the batch axis (None: it
    holds every batch row); `limb` its limb mesh; `coeff` its
    coefficient mesh (None where the mesh has no coeff axis)."""

    shape: dict
    limb: LocalLimbMesh | ProcessLimbMesh
    device: torch.device
    batch_index: int | None = None
    coeff: LocalMesh | ProcessMesh | None = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def describe(self) -> str:
        return (f"{dict(self.shape)}: {self.limb.describe(self.device)}"
                + ("" if self.batch_index is None
                   else f", batch index {self.batch_index}"))


def make_mesh(batch: int = 1, limb: int = 1, device="cuda") -> Mesh:
    """A (batch, limb) mesh for one process on `device`: all batch rows
    here (the leading dim of every op), the limb axis a
    ``LocalLimbMesh(limb)``."""
    if batch < 1:
        raise ValueError(f"a batch axis has at least one entry, got {batch}")
    return Mesh(shape={"batch": batch, "limb": limb},
                limb=LocalLimbMesh(limb), device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: one entry per trailing dim, an axis
    name or None (replicated), as a ``jax.sharding.PartitionSpec``.  A
    tensor with more dims carries the extra leading ones whole (the
    batch dims every op takes)."""

    mesh: Mesh
    spec: tuple


def ct_sharding(mesh: Mesh, batched: bool = False) -> Sharding:
    """Ciphertext data [2, L, N] (or [B, 2, L, N])."""
    return Sharding(mesh, ("batch", None, "limb", None) if batched
                    else (None, "limb", None))


def pt_sharding(mesh: Mesh, batched: bool = False) -> Sharding:
    """Plaintext / polynomial data [L, N] (or [B, L, N])."""
    return Sharding(mesh, ("batch", "limb", None) if batched
                    else ("limb", None))


def key_sharding(mesh: Mesh) -> Sharding:
    """Switching keys [dnum, 2 or 4, K+S, N]: the extended limb axis
    sharded, digits replicated."""
    return Sharding(mesh, (None, None, "limb", None))


def place(x: torch.Tensor, sharding: Sharding, ranges) -> tuple:
    """This process's parts of a global tensor: its chunk of the "batch"
    dim (every row where the mesh gives it no batch index), then along
    the "limb" dim the rows [lo, hi) of each held shard, from `ranges`
    (one pair per shard of the mesh).  x must lie on the mesh's device.
    A process that holds only some shards copies them, so that the
    global tensor can be freed.  Every placement onto a limb mesh, in
    ``LimbOps`` too, comes through here."""
    mesh, spec = sharding.mesh, sharding.spec
    if x.dim() < len(spec):
        raise ValueError(f"a {x.dim()}-dim tensor under spec {spec}")
    if x.device != mesh.device:
        raise ValueError(f"a tensor on {x.device} for a mesh on "
                         f"{mesh.device}")
    if "batch" in spec and mesh.batch_index is not None:
        dim, groups = spec.index("batch") - len(spec), mesh.shape["batch"]
        if x.shape[dim] % groups:
            raise ValueError(f"a batch of {x.shape[dim]} does not split over "
                             f"{groups} batch groups")
        x = x.chunk(groups, dim=dim)[mesh.batch_index]
    return split_rows(x, ranges, mesh.limb, spec.index("limb") - len(spec))


def split_rows(x: torch.Tensor, ranges, limb_mesh, axis: int = -2) -> tuple:
    """The held shards' rows of x along `axis`, shard s taking
    ``ranges[s]`` = (lo, hi).  Views where the process holds every
    shard; copies where it holds only some, so that x can be freed."""
    parts = tuple(x.narrow(axis, ranges[s][0], ranges[s][1] - ranges[s][0])
                  for s in limb_mesh.shards)
    if len(limb_mesh.shards) < limb_mesh.size:
        parts = tuple(p.contiguous() for p in parts)
    return parts


@dataclasses.dataclass(frozen=True)
class LimbCiphertext:
    """A ciphertext's rows on a limb mesh: `parts` holds each held
    shard's ``[..., 2, rows, N]``; `limbs` is the level's k."""

    parts: tuple
    scale: Fraction
    limbs: int


@dataclasses.dataclass(frozen=True)
class LimbPlaintext:
    parts: tuple        # each held shard's [..., rows, N]
    scale: Fraction
    limbs: int


def _rows(ctx, mesh: Mesh) -> LimbRows:
    return LimbRows(ctx.max_limbs, len(ctx.special_primes), mesh.limb.size)


def shard_ciphertext(ctx, ct, mesh: Mesh, batched: bool = False
                     ) -> LimbCiphertext:
    """This process's rows of a Ciphertext (scale metadata unchanged)."""
    rows = _rows(ctx, mesh)
    ranges = [rows.data_rows(s, ct.limbs) for s in range(rows.size)]
    return LimbCiphertext(place(ct.data, ct_sharding(mesh, batched), ranges),
                          ct.scale, ct.limbs)


def shard_plaintext(ctx, pt, mesh: Mesh, batched: bool = False
                    ) -> LimbPlaintext:
    rows = _rows(ctx, mesh)
    ranges = [rows.data_rows(s, pt.limbs) for s in range(rows.size)]
    return LimbPlaintext(place(pt.data, pt_sharding(mesh, batched), ranges),
                         pt.scale, pt.limbs)


def shard_key(ctx, ksk: torch.Tensor, mesh: Mesh) -> tuple:
    """This process's blocks of a top-level switching key
    ``[dnum, 2 or 4, K+S, N]``."""
    return place(ksk, key_sharding(mesh), _rows(ctx, mesh).blocks)


def gather_ciphertext(ctx, lct: LimbCiphertext, mesh: Mesh):
    """A limb-sharded ciphertext -> the whole Ciphertext on every process
    (an all-gather on a process mesh)."""
    from hectr_tpu_torch.ckks.scheme import Ciphertext

    sizes = _rows(ctx, mesh).data_sizes(lct.limbs)
    return Ciphertext(data=mesh.limb.gather(lct.parts, sizes),
                      scale=lct.scale)

