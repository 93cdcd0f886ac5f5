"""The cross-shard stages of the port's sharded NTT
(``hectr_tpu_torch.parallel.ntt_shard``): ``exchange_stage_plain``, one
stage against a partner's chunk, and ``cross_stages_plain``, every stage
on the shards a mesh holds, one ``exchange_stage_plain`` over
``mesh.ppermute`` a stage.  They are the CPU path and the references of
the card's kernels K4/K5 (``hectr_tpu_torch.ops.ntt_exchange_cuda``),
held bit for bit against the JAX package: its single-device transform at
logN 8 and 10 and its own ``shard_map`` transform on the virtual CPU
mesh at logN 8.  Inputs come from numpy seeds; every residue comparison
is exact (as uint32).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hectr_tpu.ckks import ntt as JN
from hectr_tpu.parallel import ntt_shard as JSH
from hectr_tpu_torch import bench
from hectr_tpu_torch.ckks import ntt as TN
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.ops import ntt_exchange_cuda as EX
from hectr_tpu_torch.parallel import LocalMesh
from hectr_tpu_torch.parallel import ntt_shard as TSH

torch.set_num_threads(1)

CPU = torch.device("cpu")
LIMBS = 3


def problem(logn, batch=(), seed=None):
    """(port tables, JAX tables, residues [*batch, LIMBS, n])."""
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, LIMBS, 2 * n))
    rng = np.random.default_rng(100 + logn if seed is None else seed)
    a = rng.integers(0, np.array(primes).reshape(-1, 1),
                     size=batch + (LIMBS, n))
    return TN.ntt_tables(n, primes, CPU), JN.build_ntt_tables(n, primes), a


def u32(x):
    return x.numpy().astype(np.uint32)


def forward(x, t, mesh):
    """The cross-shard stages, then the local ones: the sharded forward
    transform of a tensor holding every shard, gathered."""
    y = TSH.cross_stages_plain(x, t, mesh, False)
    rows = TN.ntt(y.flatten(-3, -2), TSH.local_tables(t, mesh))
    return mesh.gather(rows.unflatten(-2, y.shape[-3:-1]))


def inverse(x, t, mesh):
    rows = TN.intt(x.flatten(-3, -2), TSH.local_tables(t, mesh))
    y = TSH.cross_stages_plain(rows.unflatten(-2, x.shape[-3:-1]), t, mesh,
                               True)
    return mesh.gather(y)


class RankMesh:
    """Shard `rank` of a coefficient mesh of `size` shards, each held by
    a thread of its own: ``ppermute_wire`` hands the int32 chunks over
    through a shared board, as ``ProcessMesh`` does between ranks."""

    def __init__(self, rank, size, board, barrier):
        self.size, self.rank, self.shards = size, rank, (rank,)
        self.board, self.barrier = board, barrier

    def ppermute_wire(self, x, dist_):
        self.board[self.rank] = x.to(torch.int32)
        self.barrier.wait()
        recv = self.board[self.rank ^ dist_]
        self.barrier.wait()
        return recv

    def ppermute(self, x, dist_):
        return self.ppermute_wire(x, dist_).to(x.dtype)


def per_rank(fn, x, D):
    """fn(chunk, mesh) on every shard of x ``[..., L, D, C]`` alone, one
    thread a shard over a ``RankMesh``, the results in shard order."""
    board, barrier = [None] * D, threading.Barrier(D, timeout=60)
    with ThreadPoolExecutor(D) as pool:
        parts = pool.map(
            lambda s: fn(x[..., s:s + 1, :].contiguous(),
                         RankMesh(s, D, board, barrier)), range(D))
        return torch.cat(list(parts), dim=-2)


def one_by_one(x, t, D, inverse_):
    """cross_stages_plain as a mesh of one shard a rank runs it."""
    return per_rank(lambda v, m: TSH.cross_stages_plain(v, t, m, inverse_),
                    x, D)


# ---- against the JAX package --------------------------------------------


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("logn", [8, 10])
def test_cross_stages_then_local_match_jax_single_device(logn, size):
    """Forward and inverse over a batch of 2 and 3 limbs against
    hectr_tpu.ckks.ntt.ntt / intt, and the round trip."""
    t, jt, a = problem(logn, batch=(2,))
    mesh = LocalMesh(size)
    at = torch.from_numpy(a)
    aj = jnp.asarray(a.astype(np.uint32))
    fwd = forward(mesh.shard(at), t, mesh)
    assert np.array_equal(u32(fwd), np.asarray(
        jax.jit(lambda v: JN.ntt(v, jt))(aj)))
    assert np.array_equal(u32(inverse(mesh.shard(at), t, mesh)), np.asarray(
        jax.jit(lambda v: JN.intt(v, jt))(aj)))
    assert torch.equal(inverse(mesh.shard(fwd), t, mesh), at)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_cross_stages_then_local_match_jax_sharded(size):
    """Against hectr_tpu.parallel.ntt_shard.make_sharded_ntt on the
    virtual CPU mesh, logN = 8."""
    t, jt, a = problem(8)
    jmesh = Mesh(np.array(jax.devices()[:size]), ("coeff",))
    jntt, jintt = JSH.make_sharded_ntt(jt, jmesh, axis="coeff")
    aj = jnp.asarray(a.astype(np.uint32))
    mesh = LocalMesh(size)
    x = mesh.shard(torch.from_numpy(a))
    assert np.array_equal(u32(forward(x, t, mesh)), np.asarray(jntt(aj)))
    assert np.array_equal(u32(inverse(x, t, mesh)), np.asarray(jintt(aj)))


# ---- the two plain forms against each other -----------------------------


@pytest.mark.parametrize("inverse_", [False, True])
@pytest.mark.parametrize("size", [2, 4, 8])
def test_cross_stages_equal_the_per_stage_exchanges(size, inverse_):
    """The stages on a local mesh (every shard in one tensor, the partner
    row s ^ d of it) = each shard alone against the int32 chunk its
    partner sent, stage by stage, as a mesh of one shard a rank runs
    them; and so do the whole sharded transforms (local_ntt_fns) of the
    two meshes."""
    t, _, a = problem(8, batch=(2,), seed=size)
    mesh = LocalMesh(size)
    x = mesh.shard(torch.from_numpy(a))
    got = TSH.cross_stages_plain(x, t, mesh, inverse_)
    assert got.shape == x.shape
    assert torch.equal(got, one_by_one(x, t, size, inverse_))
    fwd_fn, inv_fn = TSH.local_ntt_fns(t, mesh)
    want = inverse(x, t, mesh) if inverse_ else forward(x, t, mesh)
    assert torch.equal(mesh.gather((inv_fn if inverse_ else fwd_fn)(x)), want)
    ranks = per_rank(lambda v, m: TSH.local_ntt_fns(t, m)[inverse_](v), x,
                     size)
    assert torch.equal(mesh.gather(ranks), want)


@pytest.mark.parametrize("inverse_", [False, True])
def test_exchange_stage_takes_the_wire_int32(inverse_):
    """A received chunk as it travels (int32 bit patterns, as
    ProcessMesh.ppermute_wire returns it) gives what the int64 chunk
    gives, on every shard of every stage."""
    t, _, a = problem(8, batch=(2,), seed=7)
    D = 4
    mesh = LocalMesh(D)
    x = mesh.shard(torch.from_numpy(a))
    stages = TSH._exchange_constants(t.n, t.primes, D, mesh.shards, CPU)
    pcol = t.p[..., None]
    for d, is_u, w, wsh, wi, wish in stages:
        recv = mesh.ppermute(x, d)
        wire = recv.to(torch.int32)
        assert wire.dtype == torch.int32
        tw = (wi, wish) if inverse_ else (w, wsh)
        want = TSH.exchange_stage_plain(x, recv, *tw, is_u, pcol, inverse_)
        got = TSH.exchange_stage_plain(x, wire, *tw, is_u, pcol, inverse_)
        assert got.dtype == torch.int64 and torch.equal(got, want)
        assert bool((got >= 0).all()) and bool((got < pcol).all())
        x = want


# ---- edge cases -----------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4, 8])
def test_residues_zero_and_p_minus_one(size):
    """Rows of only 0 and p - 1 (and a mix) through both directions,
    against one shard a rank and the plain whole-ring transform."""
    t, jt, _ = problem(8)
    p = np.array(t.primes, dtype=np.int64).reshape(-1, 1)
    n = t.n
    rng = np.random.default_rng(size)
    a = np.stack([np.zeros((LIMBS, n), np.int64),
                  np.broadcast_to(p - 1, (LIMBS, n)).copy(),
                  np.where(rng.integers(0, 2, (LIMBS, n)) == 1, p - 1, 0)])
    mesh = LocalMesh(size)
    at = torch.from_numpy(a)
    x = mesh.shard(at)
    for inv in (False, True):
        got = TSH.cross_stages_plain(x, t, mesh, inv)
        assert torch.equal(got, one_by_one(x, t, size, inv))
    fwd = forward(x, t, mesh)
    assert torch.equal(fwd, TN.ntt_plain(at, t))
    assert np.array_equal(u32(fwd), np.asarray(
        jax.jit(lambda v: JN.ntt(v, jt))(jnp.asarray(a.astype(np.uint32)))))
    assert torch.equal(inverse(mesh.shard(fwd), t, mesh), at)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_chunks_of_two(size):
    """The smallest chunk the transform takes (N = 2D), against the JAX
    package and the plain transform."""
    logn = size.bit_length()          # N = 2 * size
    t, jt, a = problem(logn, batch=(2,))
    mesh = LocalMesh(size)
    at = torch.from_numpy(a)
    x = mesh.shard(at)
    assert x.shape[-1] == 2
    fwd = forward(x, t, mesh)
    assert torch.equal(fwd, TN.ntt_plain(at, t))
    assert np.array_equal(u32(fwd), np.asarray(
        jax.jit(lambda v: JN.ntt(v, jt))(jnp.asarray(a.astype(np.uint32)))))
    assert torch.equal(inverse(mesh.shard(fwd), t, mesh), at)
    for inv in (False, True):
        assert torch.equal(TSH.cross_stages_plain(x, t, mesh, inv),
                           one_by_one(x, t, size, inv))


def test_one_shard_is_a_no_op():
    t, _, a = problem(8)
    x = LocalMesh(1).shard(torch.from_numpy(a))
    for inv in (False, True):
        assert TSH.cross_stages_plain(x, t, LocalMesh(1), inv) is x
    assert TSH._exchange_constants(t.n, t.primes, 1, (0,), CPU) == ()
    with pytest.raises(ValueError, match="expected"):
        TSH.cross_stages_plain(x, t, LocalMesh(2), False)   # not [.., 2, C]


# ---- the kernels' arithmetic that the CPU can check ---------------------


@pytest.mark.parametrize("size", [2, 4, 8, 16, 32])
def test_stage_twiddles(size):
    """The received form's per-shard (twiddle index m + s // (2d), is_u),
    which the kernel wrapper computes itself, agree with the constants the
    plain stages gather, for every shard of every stage (d = D/2 ... 1,
    m = D / (2d))."""
    t, _, _ = problem(8)
    shards = tuple(range(size))
    stages = TSH._exchange_constants(t.n, t.primes, size, shards, CPU)
    assert [st[0] for st in stages] == [size >> (j + 1) for j in
                                        range(size.bit_length() - 1)]
    for d, is_u, w, _, wi, _ in stages:
        m = size // (2 * d)
        for s in shards:
            index, u = EX.stage_twiddle(s, d, size)
            assert index == m + s // (2 * d) and 1 <= index < size
            assert u == bool(is_u[s, 0])
            assert torch.equal(w[:, s, 0], t.psi_rev[:, index])
            assert torch.equal(wi[:, s, 0], t.psi_inv_rev[:, index])


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the wrappers raise before they build anything: the
    plain stages are the CPU's path (dispatch is by device)."""
    t, _, a = problem(8)
    x = LocalMesh(4).shard(torch.from_numpy(a)).contiguous()
    before = dict(EX.LAUNCHES)
    with pytest.raises(ValueError, match="on cpu"):
        EX.exchange_local_cuda(x, t)
    own = x[..., :1, :].contiguous()
    with pytest.raises(ValueError, match="on cpu"):
        EX.exchange_recv_cuda(own, own.to(torch.int32), t, 0, 1, True)
    assert EX.LAUNCHES == before


def test_exchange_bound_arithmetic():
    """bench.exchange_bound by hand: the local form at [22, 2^17], D = 4,
    moves 22 * 2^17 * 16 B (+ the twiddles and primes) and is bound by
    bytes; the received form moves 8 + 4 + 8 B an element of its chunk."""
    peak = 5.58e12
    ms, by = bench.exchange_bound(22, 22, 17, 4, "local", peak)
    nbytes = 22 * (1 << 17) * 16 + 22 * (3 * 8 + 4)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    assert abs(ms - 0.01377) < 1e-4
    ms, by = bench.exchange_bound(22, 22, 17, 4, "received", peak)
    assert by == "bytes"
    assert abs(ms - (22 * (1 << 15) * 20 + 22 * 12) / 3.35e12 * 1e3) < 1e-12
    # a slow enough multiplier makes the operations bind
    ms, by = bench.exchange_bound(22, 22, 17, 8, "local", 1e9)
    assert by == "operations"
    assert abs(ms - 22 * 3 * (1 << 16) / 1e9 * 1e3) < 1e-12
    with pytest.raises(ValueError, match="form"):
        bench.exchange_bound(1, 1, 10, 2, "both", peak)
