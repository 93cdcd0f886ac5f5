"""The port's prime chains, modular arithmetic, NTT tables and NTT held
bit for bit against the JAX package (``hectr_tpu``).

The JAX side runs as its own tests run it on the CPU: the XLA path, and
the Pallas kernels in interpret mode.  The CUDA kernels are held to the
plain version in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu import config as jcfg
from hectr_tpu.ckks import modmath as jmm
from hectr_tpu.ckks import ntt as jntt
from hectr_tpu.ckks.context import make_context as jmake_context
from hectr_tpu.ops.ntt_pallas import intt_pallas, ntt_pallas
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch.ckks import modmath as tmm
from hectr_tpu_torch.ckks import ntt as tntt
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.ckks.primes import find_ntt_primes, is_prime, primitive_root

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _u32(t):
    return t.cpu().numpy().astype(np.uint32)


def _rand_res(primes, shape, seed):
    """Random residues < p per limb (axis -2), with 0 and p-1 planted."""
    rng = np.random.default_rng(seed)
    pcol = np.array(primes, dtype=np.int64).reshape(-1, 1)
    a = rng.integers(0, pcol, size=shape).astype(np.int64)
    a[..., 0] = 0
    a[..., 1] = pcol[:, 0] - 1
    return a


# ---- primes and chains ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_prime_chains_match_reference(name):
    ours = make_context(tcfg.PRESETS[name])
    ref = jmake_context(jcfg.PRESETS[name])
    assert ours.base_primes == ref.base_primes
    assert ours.scale_primes == ref.scale_primes
    assert ours.special_primes == ref.special_primes
    assert tcfg.PRESETS[name] == tcfg.CKKSPreset(
        **{f: getattr(jcfg.PRESETS[name], f)
           for f in jcfg.CKKSPreset.__dataclass_fields__})


def test_primality_and_primitive_roots_match_sympy():
    import sympy

    for n in list(range(0, 400)) + [2**31 - 1, 1073692673, 1073692675]:
        assert is_prime(n) == sympy.isprime(n), n
    for p in find_ntt_primes(30, 4, 1 << 13) + [3, 5, 7, 257, 65537]:
        assert primitive_root(p) == sympy.primitive_root(p), p


# ---- tables ----------------------------------------------------------------


@pytest.mark.parametrize("logn,count", [(8, 3), (12, 5)])
def test_tables_bit_equal(logn, count):
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, count, 2 * n))
    ours = tntt.build_ntt_tables(n, primes)
    ref = jntt.build_ntt_tables(n, primes)
    for f in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "psi_inv_rev_shoup",
              "n_inv", "n_inv_shoup"):
        assert np.array_equal(getattr(ours, f).astype(np.uint32),
                              np.asarray(getattr(ref, f)).astype(np.uint32)), f
    for f in ("p", "mu", "k"):
        assert np.array_equal(getattr(ours, f).astype(np.uint64),
                              getattr(ref, f)), f


def test_reference_chain_tables_bit_equal():
    ctx = make_context(tcfg.REFERENCE_HEMPC)
    ours = ctx.tables_full(CPU)
    ref = jmake_context(jcfg.REFERENCE_HEMPC).tables_full()
    assert np.array_equal(_u32(ours.psi_rev), np.asarray(ref.psi_rev))
    assert np.array_equal(_u32(ours.psi_inv_rev_shoup),
                          np.asarray(ref.psi_inv_rev_shoup))
    assert ctx.tables_full(CPU) is ctx.tables_full("cpu")   # cached


def test_int32_view_keeps_shoup_patterns():
    """Kernel tables hold 32-bit patterns in int32 tensors: companions
    >= 2^31 must come back unchanged as uint32."""
    n = 1 << 10
    primes = tuple(find_ntt_primes(30, 3, 2 * n))
    h = tntt.build_ntt_tables(n, primes)
    assert (h.psi_rev_shoup >= 1 << 31).any()
    t = tntt.ntt_tables(n, primes, CPU)
    for f in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "psi_inv_rev_shoup"):
        back = getattr(t, f + "32").numpy().view(np.uint32)
        assert np.array_equal(back, getattr(h, f)), f
        assert np.array_equal(getattr(t, f).numpy(), getattr(h, f).astype(np.int64))
    assert np.array_equal(t.n_inv_shoup32.numpy().view(np.uint32),
                          h.n_inv_shoup.reshape(-1))


# ---- modular arithmetic ---------------------------------------------------


def _mm_inputs(seed=0):
    primes = find_ntt_primes(30, 2, 1 << 11) + [33574913, 40961]
    a = _rand_res(primes, (len(primes), 512), seed)
    b = _rand_res(primes, (len(primes), 512), seed + 1)
    b[:, 2] = 0                       # 0 op 0, (p-1) op (p-1), 0 op (p-1)
    b[:, 3] = np.array(primes) - 1
    a[:, 3] = np.array(primes) - 1
    return primes, a, b


def test_modmath_bit_equal_with_edges():
    primes, a, b = _mm_inputs()
    p, mu, k = tmm.barrett_constants(primes)
    jp, jmu, jk = jmm.barrett_constants(primes)
    assert np.array_equal(p.astype(np.uint64), jp)
    assert np.array_equal(mu.astype(np.uint64), jmu)
    tp, tmu, tk = (torch.from_numpy(x) for x in (p, mu, k))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    pairs = [
        (tmm.add_mod(ta, tb, tp), jmm.add_mod(ja, jb, jp)),
        (tmm.sub_mod(ta, tb, tp), jmm.sub_mod(ja, jb, jp)),
        (tmm.neg_mod(ta, tp), jmm.neg_mod(ja, jp)),
        (tmm.mul_mod(ta, tb, tp, tmu, tk), jmm.mul_mod(ja, jb, jp, jmu, jk)),
    ]
    w = b
    wsh = tmm.shoup(w, p)
    assert np.array_equal(wsh.astype(np.uint64), jmm.shoup(w.astype(np.uint64), jp))
    pairs.append((tmm.mul_mod_shoup(ta, tb, torch.from_numpy(wsh), tp),
                  jmm.mul_mod_shoup(ja, jb, jnp.asarray(wsh.astype(np.uint32)), jp)))
    exact = [(a.astype(object) + b) % p, (a.astype(object) - b) % p,
             (-a.astype(object)) % p, a.astype(object) * b % p,
             a.astype(object) * b % p]
    for (got, want), oracle in zip(pairs, exact):
        assert np.array_equal(_u32(got), np.asarray(want))
        assert np.array_equal(_u32(got), oracle.astype(np.uint32))


def test_shoup_wide_cross_modulus_bit_equal():
    """Residues of one prime times constants mod a different, smaller
    prime (base conversion): any a < 2^31."""
    primes, _, w = _mm_inputs(3)
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 30, size=w.shape).astype(np.int64)
    a[:, 0] = 0
    a[:, 1] = (1 << 30) - 1
    p = tmm.barrett_constants(primes)[0]
    wsh = tmm.shoup(w, p)
    got = tmm.mul_mod_shoup_wide(torch.from_numpy(a), torch.from_numpy(w),
                                 torch.from_numpy(wsh), torch.from_numpy(p))
    want = jmm.mul_mod_shoup_wide(jnp.asarray(a.astype(np.uint32)),
                                  jnp.asarray(w.astype(np.uint32)),
                                  jnp.asarray(wsh.astype(np.uint32)),
                                  jnp.asarray(p.astype(np.uint64)))
    assert np.array_equal(_u32(got), np.asarray(want))
    assert np.array_equal(_u32(got), (a.astype(object) * w % p).astype(np.uint32))


@pytest.mark.parametrize("terms", [1, 11, 64])
def test_sum_mod_bound(terms):
    """One Barrett pass over a sum of `terms` residues, all at p-1 in
    the worst column."""
    primes = find_ntt_primes(30, 2, 1 << 11) + [33574913]
    p, mu, k = tmm.barrett_constants(primes)
    a = np.stack([_rand_res(primes, (len(primes), 64), s) for s in range(terms)])
    a[:, :, 5] = p[:, 0] - 1
    got = tmm.sum_mod(torch.from_numpy(a), 0, *(torch.from_numpy(x) for x in (p, mu, k)))
    want = jmm.sum_mod(jnp.asarray(a.astype(np.uint32)), 0,
                       *jmm.barrett_constants(primes))
    assert np.array_equal(_u32(got), np.asarray(want))
    assert np.array_equal(_u32(got), (a.astype(object).sum(0) % p).astype(np.uint32))


# ---- the plain NTT against the reference ---------------------------------


def _xla(fn, jt):
    """The JAX package's XLA-path transform, jitted (its eager form
    compiles op by op)."""
    return jax.jit(lambda x: fn(x, jt))


@pytest.mark.parametrize("logn", [8, 9, 10, 11, 12])
@pytest.mark.parametrize("batch", [(), (2,), (3, 2)])
def test_plain_ntt_matches_xla(logn, batch):
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, 3, 2 * n))
    a = _rand_res(primes, batch + (3, n), logn)
    t = tntt.ntt_tables(n, primes, CPU)
    jt = jntt.build_ntt_tables(n, primes)
    fwd = tntt.ntt(torch.from_numpy(a), t)
    jfwd = _xla(jntt.ntt, jt)(jnp.asarray(a.astype(np.uint32)))
    assert np.array_equal(_u32(fwd), np.asarray(jfwd))
    inv = tntt.intt(fwd, t)
    assert np.array_equal(_u32(inv), np.asarray(_xla(jntt.intt, jt)(jfwd)))
    assert np.array_equal(inv.numpy(), a)


@pytest.mark.parametrize("logn", [8, 10])
def test_plain_ntt_matches_pallas_interpret(logn):
    n = 1 << logn
    primes = tuple(find_ntt_primes(30, 3, 2 * n))
    a = _rand_res(primes, (2, 3, n), 10 + logn)
    t = tntt.ntt_tables(n, primes, CPU)
    jt = jntt.build_ntt_tables(n, primes)
    ja = jnp.asarray(a.astype(np.uint32))
    fwd = tntt.ntt_plain(torch.from_numpy(a), t)
    assert np.array_equal(_u32(fwd), np.asarray(ntt_pallas(ja, jt, interpret=True)))
    jf = jnp.asarray(_u32(fwd))
    assert np.array_equal(_u32(tntt.intt_plain(fwd, t)),
                          np.asarray(intt_pallas(jf, jt, interpret=True)))


def test_mixed_prime_chain_rows():
    """A chain that mixes 30-bit and 25-bit primes, as the key-switch
    chain does: each row is transformed under its own prime."""
    ctx = make_context(tcfg.REFERENCE_HEMPC)
    t = ctx.tables_ks(4, CPU)
    jt = jmake_context(jcfg.REFERENCE_HEMPC).tables_ks(4)
    a = _rand_res(t.primes, (2, len(t.primes), ctx.n), 7)
    got = tntt.ntt(torch.from_numpy(a), t)
    assert np.array_equal(_u32(got), np.asarray(
        _xla(jntt.ntt, jt)(jnp.asarray(a.astype(np.uint32)))))


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; the dispatcher sends
    CPU tensors to the plain path (no build is attempted)."""
    from hectr_tpu_torch.ops import ntt_cuda

    n = 256
    primes = tuple(find_ntt_primes(30, 1, 2 * n))
    t = tntt.ntt_tables(n, primes, CPU)
    a = torch.zeros((1, n), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.ntt_cuda(a, t)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_cuda.intt_cuda(a, t)
    before = dict(ntt_cuda.LAUNCHES)
    tntt.intt(tntt.ntt(a, t), t)
    assert ntt_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        tntt.ntt(torch.zeros((2, n), dtype=torch.int64), t)


def test_pointwise_mul_bit_equal():
    n = 1 << 8
    primes = tuple(find_ntt_primes(30, 3, 2 * n))
    a = _rand_res(primes, (2, 3, n), 30)
    b = _rand_res(primes, (2, 3, n), 31)
    got = tntt.pointwise_mul(torch.from_numpy(a), torch.from_numpy(b),
                             tntt.ntt_tables(n, primes, CPU))
    want = jntt.pointwise_mul(jnp.asarray(a.astype(np.uint32)),
                              jnp.asarray(b.astype(np.uint32)),
                              jntt.build_ntt_tables(n, primes))
    assert np.array_equal(_u32(got), np.asarray(want))
