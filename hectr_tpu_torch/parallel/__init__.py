"""Coefficient meshes for the CKKS compute path.

The JAX package shards arrays over a ``jax.sharding.Mesh`` and lets
``shard_map`` run one per-shard program on every device
(``hectr_tpu/parallel/``).  PyTorch has no such partitioner, so a mesh
here is an object the per-shard functions talk to.  It splits the
coefficient axis of a ring of N into D contiguous chunks of C = N/D and
answers four questions: which shards this process holds (``shards``),
how a global tensor becomes this process's part and back (``shard``,
``gather``), and how a shard reaches its partner ``s ^ dist`` in a
butterfly stage that crosses chunks (``ppermute``).

A sharded tensor always carries its shards on an explicit axis,
``[..., S, C]`` with S = ``len(mesh.shards)``:

  * ``LocalMesh(D)``: all D shards of one tensor on one device, S = D.
    ``[..., N]`` viewed as ``[..., D, C]`` costs nothing, ``ppermute``
    is an index flip on the D axis.  The counterpart of the virtual CPU
    devices the JAX package's tests run on; it also runs on one card at
    full width, where it carries rings larger than one kernel row.
  * ``ProcessMesh()``: one shard per rank of the ``torch.distributed``
    default group, S = 1.  ``ppermute`` is one paired send and receive with the
    rank ``r ^ dist``; ``gather`` is an all-gather.  The counterpart of
    a mesh over ``jax.distributed`` processes.

The same per-shard functions (``parallel.ntt_shard``,
``parallel.coeff_ops``) run on both.  The limb and batch axes of the JAX
package's meshes are not ported yet.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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


class ProcessMesh:
    """One coefficient shard per rank of the initialised
    ``torch.distributed`` default group.

    The transport follows from the group's backend and the tensor's
    device: NCCL sends device tensors as they are (each rank a card of
    its own); gloo sends CPU tensors as they are and stages a CUDA
    tensor through a pinned host buffer (several ranks sharing one card,
    where NCCL refuses to run).  Residues are below 2^31, so they travel
    as int32 and are widened on arrival."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised "
                               "(parallel.multihost.init_distributed)")
        self.size = dist.get_world_size()
        _check_size(self.size)
        self.rank = dist.get_rank()
        self.shards = (self.rank,)
        self.backend = dist.get_backend()
        self._pinned: dict = {}     # host staging buffers, by (role, shape)

    def _staged(self, device) -> bool:
        device = torch.device(device)
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError("an NCCL mesh moves CUDA tensors only")
            return False
        return device.type == "cuda"

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

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather: every rank's ``[..., 1, C]`` -> global ``[..., N]``
        on every rank."""
        send = self._wire(x)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send)
        return torch.cat(parts, dim=-2).to(x.device).to(x.dtype).flatten(-2)

    def ppermute(self, x: torch.Tensor, dist_: int) -> torch.Tensor:
        """This rank's chunk goes to rank ``r ^ dist_``, whose chunk
        comes back: one paired isend/irecv."""
        peer = self.rank ^ dist_
        send = self._wire(x)
        recv = (self._host("recv", send.shape) if self._staged(x.device)
                else torch.empty_like(send))
        ops = [dist.P2POp(dist.isend, send, peer),
               dist.P2POp(dist.irecv, recv, peer)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device).to(x.dtype)
