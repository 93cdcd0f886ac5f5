"""The port's coefficient meshes and sharded NTT
(``hectr_tpu_torch.parallel``) held bit for bit against the JAX package:
against its single-device transform at logN 8 and 10, and at logN 8
against its own ``shard_map`` transform on the virtual CPU mesh.  Inputs
come from numpy seeds and go to both packages; every residue comparison
is exact.  The traffic formula and the link-efficiency model are
checked as arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hectr_tpu.ckks import ntt as JN
from hectr_tpu.parallel import ntt_shard as JSH
from hectr_tpu_torch.ckks import ntt as TN
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.parallel import LocalMesh, ProcessMesh
from hectr_tpu_torch.parallel import ntt_shard as TSH

torch.set_num_threads(1)

CPU = torch.device("cpu")
LIMBS = 3


def problem(logn, batch=(), seed=None):
    """(primes, port tables, JAX tables, residues [*batch, LIMBS, n])."""
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, LIMBS, 2 * n))
    rng = np.random.default_rng(logn if seed is None else seed)
    a = rng.integers(0, np.array(primes).reshape(-1, 1),
                     size=batch + (LIMBS, n))
    return (primes, TN.ntt_tables(n, primes, CPU),
            JN.build_ntt_tables(n, primes), a)


def u32(x):
    return x.numpy().astype(np.uint32)


# ---- the meshes ---------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4, 8])
def test_local_mesh_shards_and_pairs(size):
    """shard/gather are inverse views, and ppermute(x, dist) hands shard s
    the chunk of shard s ^ dist (hectr_tpu/parallel/ntt_shard.py:114)."""
    mesh = LocalMesh(size)
    a = torch.arange(2 * 3 * 64).reshape(2, 3, 64)
    x = mesh.shard(a)
    assert x.shape == (2, 3, size, 64 // size)
    assert x.data_ptr() == a.data_ptr()                     # a view
    assert torch.equal(mesh.gather(x), a)
    assert mesh.shards == tuple(range(size))
    dist = 1
    while dist < size:
        recv = mesh.ppermute(x, dist)
        for s in range(size):
            assert torch.equal(recv[..., s, :], x[..., s ^ dist, :])
        dist *= 2


def test_mesh_rejects_bad_sizes():
    for size in (0, 3, 6):
        with pytest.raises(ValueError, match="power-of-two"):
            LocalMesh(size)
    with pytest.raises(RuntimeError, match="not initialised"):
        ProcessMesh()
    _, t, _, _ = problem(3)
    with pytest.raises(ValueError, match="need at least 2"):
        TSH.local_ntt_fns(t, LocalMesh(8))                  # chunks of 1
    fwd, _ = TSH.local_ntt_fns(t, LocalMesh(2))
    with pytest.raises(ValueError, match="expected"):
        fwd(torch.zeros(LIMBS, 8, dtype=torch.int64))       # not sharded


# ---- the gathered local tables ------------------------------------------


@pytest.mark.parametrize("size", [2, 4, 8])
def test_local_tables_follow_the_index_rule(size):
    """Entry q = 2^j + i of shard s's size-C table is the ring's entry
    (D + s) 2^j + i: exactly the slices the JAX package's local stages
    read, psi_rev[m + s*loc : m + (s+1)*loc] with loc = m / D
    (hectr_tpu/parallel/ntt_shard.py:63-67, :86-91)."""
    logn = 8
    n, C = 1 << logn, (1 << logn) // size
    _, t, _, _ = problem(logn)
    idx = TSH.local_table_index(n, size, range(size))
    assert idx.shape == (size, C) and (idx[:, 0] == 0).all()
    for s in range(size):
        m, m_loc = size, 1          # the ring's and the chunk's group counts
        while m_loc < C:
            loc = m // size
            assert loc == m_loc
            assert np.array_equal(idx[s, m_loc:2 * m_loc],
                                  np.arange(m + s * loc, m + (s + 1) * loc))
            m, m_loc = 2 * m, 2 * m_loc
    lt = TSH.local_tables(t, LocalMesh(size))
    assert lt is TSH.local_tables(t, LocalMesh(size))       # cached
    assert lt.n == C and len(lt.primes) == LIMBS * size
    assert lt.primes == tuple(p for p in t.primes for _ in range(size))
    gather = torch.from_numpy(idx)
    for name in ("psi_rev", "psi_rev_shoup", "psi_inv_rev",
                 "psi_inv_rev_shoup", "psi_rev32", "psi_rev_shoup32",
                 "psi_inv_rev32", "psi_inv_rev_shoup32"):
        got, ring = getattr(lt, name), getattr(t, name)
        assert got.shape == (LIMBS * size, C) and got.is_contiguous()
        for limb in range(LIMBS):
            for s in range(size):
                assert torch.equal(got[limb * size + s, 1:],
                                   ring[limb, gather[s, 1:]]), name
    # the whole ring's N^-1, once per row, in both widths
    assert torch.equal(lt.n_inv, t.n_inv.repeat_interleave(size, 0))
    assert torch.equal(lt.n_inv32, t.n_inv32.repeat_interleave(size, 0))
    assert torch.equal(lt.p32, t.p32.repeat_interleave(size, 0))
    # a process rank holds one shard: its rows are that shard's rows
    one = TSH._local_tables(t.n, t.primes, size, (size - 1,), CPU)
    assert torch.equal(one.psi_rev, lt.psi_rev[size - 1::size])


def test_clear_local_tables_drops_and_rebuilds():
    """The cached tables go (their memory with them) and come back equal
    at the next use; the transform is unchanged."""
    _, t, _, a = problem(8)
    mesh = LocalMesh(4)
    fwd, _ = TSH.local_ntt_fns(t, mesh)
    before = fwd(mesh.shard(torch.from_numpy(a)))
    lt = TSH.local_tables(t, mesh)
    assert TSH._local_tables.cache_info().currsize > 0
    assert TSH._exchange_constants.cache_info().currsize > 0
    TSH.clear_local_tables()
    assert TSH._local_tables.cache_info().currsize == 0
    assert TSH._exchange_constants.cache_info().currsize == 0
    again = TSH.local_tables(t, mesh)
    assert again is not lt and torch.equal(again.psi_rev, lt.psi_rev)
    assert torch.equal(fwd(mesh.shard(torch.from_numpy(a))), before)


# ---- the sharded transform against the JAX package ----------------------


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("logn", [8, 10])
def test_sharded_ntt_matches_jax_single_device(logn, size):
    """Forward, inverse and round trip over a batch of 2 and 3 limbs,
    against hectr_tpu.ckks.ntt.ntt / intt."""
    _, t, jt, a = problem(logn, batch=(2,))
    mesh = LocalMesh(size)
    ntt_fn, intt_fn = TSH.make_sharded_ntt(t, mesh)
    at = torch.from_numpy(a)
    aj = jnp.asarray(a.astype(np.uint32))
    fwd = mesh.gather(ntt_fn(at))
    want_fwd = np.asarray(jax.jit(lambda x: JN.ntt(x, jt))(aj))
    assert np.array_equal(u32(fwd), want_fwd)
    assert torch.equal(mesh.gather(intt_fn(fwd)), at)
    want_inv = np.asarray(jax.jit(lambda x: JN.intt(x, jt))(aj))
    assert np.array_equal(u32(mesh.gather(intt_fn(at))), want_inv)


@pytest.mark.parametrize("size", [2, 4, 8])
def test_sharded_ntt_matches_jax_sharded(size):
    """Against hectr_tpu.parallel.ntt_shard.make_sharded_ntt itself on
    the virtual CPU mesh, logN = 8."""
    _, t, jt, a = problem(8)
    jmesh = Mesh(np.array(jax.devices()[:size]), ("coeff",))
    jntt, jintt = JSH.make_sharded_ntt(jt, jmesh, axis="coeff")
    aj = jnp.asarray(a.astype(np.uint32))
    mesh = LocalMesh(size)
    ntt_fn, intt_fn = TSH.make_sharded_ntt(t, mesh)
    at = torch.from_numpy(a)
    assert np.array_equal(u32(mesh.gather(ntt_fn(at))), np.asarray(jntt(aj)))
    assert np.array_equal(u32(mesh.gather(intt_fn(at))), np.asarray(jintt(aj)))


@pytest.mark.parametrize("logn", [4, 5, 6, 7])
def test_small_chunks(logn):
    """D = 8 down to chunks of 2 (the smallest the transform takes),
    against the port's own plain transform."""
    _, t, _, a = problem(logn, batch=(2,))
    mesh = LocalMesh(8)
    ntt_fn, intt_fn = TSH.make_sharded_ntt(t, mesh)
    at = torch.from_numpy(a)
    fwd = mesh.gather(ntt_fn(at))
    assert torch.equal(fwd, TN.ntt_plain(at, t))
    assert torch.equal(mesh.gather(intt_fn(fwd)), at)


def test_one_shard_is_the_plain_transform():
    _, t, _, a = problem(8)
    mesh = LocalMesh(1)
    ntt_fn, _ = TSH.make_sharded_ntt(t, mesh)
    at = torch.from_numpy(a)
    assert torch.equal(mesh.gather(ntt_fn(at)), TN.ntt_plain(at, t))


# ---- traffic and the efficiency model -----------------------------------


def test_traffic_formula_counts_int32_on_the_wire():
    """log2(D) exchanges of n/D residues per limb at 4 bytes: the port's
    int64 residues travel as int32, so the count equals the JAX
    package's."""
    assert TSH.WIRE_BYTES == 4
    for n, limbs, D in ((1 << 15, 22, 2), (1 << 15, 22, 8), (1 << 17, 4, 4),
                        (1 << 10, 3, 1)):
        assert (TSH.ppermute_bytes_per_transform(n, limbs, D)
                == JSH.ppermute_bytes_per_transform(n, limbs, D))
    assert TSH.ppermute_bytes_per_transform(1 << 15, 22, 2) == 16384 * 4 * 22


def test_link_efficiency_model():
    """Checkable arithmetic, as tests/test_ntt_shard.py:46-71 checks the
    JAX package's: 1.0 at D = 1, falling with D, rising with N, the table
    consistent with the single call; no TPU constant in it."""
    link = dict(bw_gbs=450.0, latency_us=5.0)
    assert TSH.analytic_link_efficiency(15, 22, 1, **link)["efficiency"] == 1.0
    e2 = TSH.analytic_link_efficiency(15, 22, 2, **link)
    # by hand: T_comp = 22 * (82.8 / 264) / 2 = 3.45 us; bytes = 16384 * 4 *
    # 22 = 1,441,792; T_comm = 5 + 1441792 / 450000 = 8.204 us
    assert abs(e2["t_comp_us"] - 3.45) < 0.001
    assert abs(e2["t_comm_us"] - 8.204) < 0.001
    assert abs(e2["efficiency"] - 3.45 / (3.45 + 8.204)) < 1e-4
    assert e2["bytes_per_device"] == TSH.ppermute_bytes_per_transform(
        1 << 15, 22, 2)
    e4 = TSH.analytic_link_efficiency(15, 22, 4, **link)
    e8 = TSH.analytic_link_efficiency(15, 22, 8, **link)
    assert e2["efficiency"] > e4["efficiency"] > e8["efficiency"]
    assert (TSH.analytic_link_efficiency(16, 22, 2, **link)["efficiency"]
            > e2["efficiency"])
    # a given limb time is used as it is
    slow = TSH.analytic_link_efficiency(15, 22, 2, t_limb_us=7.0, **link)
    assert abs(slow["t_comp_us"] - 77.0) < 1e-9
    tab = TSH.link_efficiency_table(22, **link)
    assert tab["predicted_efficiency"]["logn15"]["2dev"] == e2["efficiency"]
    assert tab["meets_70pct"] == [
        f"logN={logn},D={D}" for logn in (15, 16, 17) for D in (2, 4, 8)
        if TSH.analytic_link_efficiency(logn, 22, D, **link)["efficiency"]
        >= 0.70]
    assert "7.9" not in tab["model"] and "v5e" not in tab["model"]
    # a faster link and no latency: sharding pays
    fast = TSH.link_efficiency_table(22, bw_gbs=1e6, latency_us=0.0)
    assert "logN=15,D=2" in fast["meets_70pct"]
