"""The port's encoding, keygen, encryption, decryption, arithmetic and
rescale held against the JAX package.

Integer results are compared bit for bit (as uint32).  Randomness is
the reference's own: ``JaxReplay`` draws the JAX package's samples with
its own key splits and hands them to the port through its sampler hook.
Float results (embedding, decode) differ only in summation order and
are held to 1e-12 absolute.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu import config as jcfg
from hectr_tpu.ckks import encoding as jenc
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks.context import make_context as jmake_context
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import encoding as tenc
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.context import make_context

torch.set_num_threads(1)

CPU = torch.device("cpu")

# logN=10 as tests/test_ckks_rotation.py: alpha=1, one special prime
PRESET = dict(name="test-rot", logn=10, slots=16, scale_bits=50,
              limb_bits=25, mult_depth=2)
# ... and hybrid: two specials, width-2 digit groups
PRESET_HYBRID = dict(PRESET, name="test-hybrid", special_limbs=2,
                     digit_width=2)


def contexts(fields):
    return (make_context(tcfg.CKKSPreset(**fields)),
            jmake_context(jcfg.CKKSPreset(**fields)))


def u32(t):
    return interop.to_u32(t)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


class JaxReplay:
    """A port sampler that replays the JAX package's draws: the key
    splits of hectr_tpu/ckks/scheme.py (keygen, encrypt) and
    hectr_tpu/ckks/keyswitch.py (_gen_switching_key)."""

    def __init__(self, keygen_key=None, enc_keys=(), switch_keys=()):
        self.keygen_key = keygen_key
        self.enc_keys = iter(enc_keys)
        self.switch_keys = iter(switch_keys)

    def keygen(self, ctx, device):
        k_s, k_a, k_e = jax.random.split(self.keygen_key, 3)
        pcol = np.array(ctx.data_primes, dtype=np.uint64).reshape(-1, 1)
        return (_t(JS._sample_ternary(k_s, ctx.n)),
                _t(JS._sample_uniform(k_a, pcol, ctx.n)),
                _t(JS._sample_gauss(k_e, ctx.n)))

    def encryption(self, ctx, k, batch, device):
        # one encryption key per row of the batch, taken in row order
        draws = []
        for _ in range(int(np.prod(batch, dtype=np.int64))):
            k_v, k_e0, k_e1 = jax.random.split(next(self.enc_keys), 3)
            draws.append((JS._sample_ternary(k_v, ctx.n),
                          JS._sample_gauss(k_e0, ctx.n),
                          JS._sample_gauss(k_e1, ctx.n)))
        return tuple(_t(np.stack(d)).reshape(*batch, ctx.n) for d in zip(*draws))

    def switching_key(self, ctx, dnum, primes, device):
        k_a, k_e = jax.random.split(next(self.switch_keys))
        pcol = np.array(primes, dtype=np.uint32).reshape(-1, 1)
        a = jax.random.randint(k_a, (dnum, len(primes), ctx.n),
                               jnp.zeros((len(primes), 1), dtype=jnp.uint32),
                               jnp.asarray(pcol), dtype=jnp.uint32)
        e = jnp.round(3.2 * jax.random.normal(k_e, (dnum, ctx.n),
                                              dtype=jnp.float64))
        return _t(a), _t(e)


def regulator_enc_keys(key):
    """The encryption keys of the JAX regulator, step after step:
    key, k1..k4 = split(key, 5) (hectr_tpu/hempc/regulator.py)."""
    while True:
        key, *ks = jax.random.split(key, 5)
        yield from ks


def rotation_switch_keys(key, rotations):
    """The per-rotation keys of hectr_tpu's gen_rotation_keys."""
    return list(jax.random.split(key, len(rotations)))


@pytest.fixture(scope="module")
def pair():
    ctx, jctx = contexts(PRESET)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    keys = TS.keygen(ctx, JaxReplay(jax.random.PRNGKey(0)), CPU)
    return ctx, jctx, keys, jkeys


def _slots(seed, n=16, scale=5.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, n), rng.uniform(-scale, scale, n)


# ---- encoding --------------------------------------------------------------


def test_embedding_and_unembedding_close():
    vre, vim = _slots(0)
    for s in (4, 16, 64):
        vre, vim = _slots(s, s)
        m = tenc.embed_ri(torch.from_numpy(vre), torch.from_numpy(vim), s)
        jm = jenc.embed_ri(jnp.asarray(vre), jnp.asarray(vim), s)
        assert np.max(np.abs(m.numpy() - np.asarray(jm))) <= 1e-12
        re, im = tenc.unembed(m, s)
        jre, jim = jenc.unembed(jm, s)
        assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= 1e-12
        assert np.max(np.abs(im.numpy() - np.asarray(jim))) <= 1e-12
        assert np.max(np.abs(re.numpy() - vre)) <= 1e-12


def test_matrix_branch_only():
    """The branch boundary: up to MATRIX_MAX_SLOTS = 64 slots the matrix
    embedding runs (the result is its matrix product, bit for bit); at
    128 slots the FFT branch runs, and equals the JAX package's to
    1e-12."""
    assert tenc.MATRIX_MAX_SLOTS == jenc._MATRIX_MAX_SLOTS == 64
    vre, vim = _slots(64, 64)
    ReE, ImE = (torch.from_numpy(a) for a in tenc.embedding_matrices(64))
    tre, tim = torch.from_numpy(vre), torch.from_numpy(vim)
    assert torch.equal(tenc.embed_ri(tre, tim, 64),
                       (ReE.T @ tre + ImE.T @ tim) / 64)
    vre, vim = _slots(128, 128)
    tre, tim = torch.from_numpy(vre), torch.from_numpy(vim)
    m = tenc.embed_ri(tre, tim, 128)
    w = torch.zeros(256, dtype=torch.float64).index_copy(
        0, torch.from_numpy(np.concatenate(tenc.slot_indices(128))),
        torch.cat([tre, tre]))
    wi = torch.zeros(256, dtype=torch.float64).index_copy(
        0, torch.from_numpy(np.concatenate(tenc.slot_indices(128))),
        torch.cat([tim, -tim]))
    assert torch.equal(m, tenc.cfft_inv(w, wi, 256)[0])
    jm = jax.jit(lambda a, b: jenc.embed_ri(a, b, 128))(jnp.asarray(vre),
                                                        jnp.asarray(vim))
    assert np.max(np.abs(m.numpy() - np.asarray(jm))) <= 1e-12
    re, im = tenc.unembed(m, 128)
    assert np.max(np.abs(re.numpy() - vre)) <= 1e-12
    assert np.max(np.abs(im.numpy() - vim)) <= 1e-12


def jencode(jctx, vre, vim, k, scale=None):
    """The JAX package's encode, jitted (eager it compiles op by op)."""
    return jax.jit(lambda a, b: JS.encode(jctx, (a, b), k, scale))(
        jnp.asarray(vre), jnp.asarray(vim))


@pytest.mark.parametrize("k,pair_scale", [(2, False), (4, True), (6, False)])
def test_encode_bit_equal_given_embedding(pair, k, pair_scale):
    ctx, jctx, _, _ = pair
    vre, vim = _slots(k, scale=1e3)
    jm = jenc.embed_ri(jnp.asarray(vre), jnp.asarray(vim), ctx.slots)
    scale = ctx.pair_scale(k) if pair_scale else ctx.delta
    pt = TS.encode_embedded(ctx, torch.from_numpy(np.array(jm)), k, scale)
    jpt = jencode(jctx, vre, vim, k, scale)
    assert pt.scale == jpt.scale
    assert np.array_equal(u32(pt.data), np.asarray(jpt.data))


def test_integer_residues_signs_and_magnitudes():
    ctx, jctx = contexts(PRESET)
    rng = np.random.default_rng(5)
    y = np.concatenate([[0.0, -1.0, 1.0, 2.0**59, -2.0**59, 2.0**54, -2.0**27],
                        np.round(rng.uniform(-2**59, 2**59, 64))])
    pcol = np.array(ctx.data_primes, dtype=np.int64).reshape(-1, 1)
    got = tenc.integer_residues(torch.from_numpy(y), torch.from_numpy(pcol))
    want = jenc.integer_residues(jnp.asarray(y), pcol.astype(np.uint64))
    assert np.array_equal(u32(got), np.asarray(want))
    assert np.array_equal(
        u32(got), (y.astype(np.int64).astype(object)[None] % pcol).astype(np.uint32))


def test_decode_close(pair):
    ctx, jctx, keys, jkeys = pair
    vre, vim = _slots(3)
    jpt = jencode(jctx, vre, vim, 6)
    pt = interop.plaintext(jpt.data, jpt.scale, CPU)
    re, im = TS.decode_ri(ctx, pt)
    jre, jim = jax.jit(lambda p: JS.decode_ri(jctx, p))(jpt)
    assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= 1e-12
    assert np.max(np.abs(im.numpy() - np.asarray(jim))) <= 1e-12
    assert np.max(np.abs(re.numpy() - vre)) <= 1e-9


# ---- keys, encryption, decryption -----------------------------------------


def test_keygen_bit_equal_with_replayed_draws(pair):
    _, _, keys, jkeys = pair
    assert np.array_equal(u32(keys.sk), np.asarray(jkeys.sk))
    assert np.array_equal(u32(keys.pk), np.asarray(jkeys.pk))


def test_hybrid_keygen_bit_equal():
    ctx, jctx = contexts(PRESET_HYBRID)
    jk = JS.keygen(jctx, jax.random.PRNGKey(4))
    k = TS.keygen(ctx, JaxReplay(jax.random.PRNGKey(4)), CPU)
    assert np.array_equal(u32(k.sk), np.asarray(jk.sk))
    assert np.array_equal(u32(k.pk), np.asarray(jk.pk))


@pytest.mark.parametrize("k", [2, 6])
def test_encrypt_decrypt_bit_equal(pair, k):
    ctx, jctx, keys, jkeys = pair
    vre, vim = _slots(10 + k)
    jpt = jencode(jctx, vre, vim, k)
    pt = interop.plaintext(jpt.data, jpt.scale, CPU)
    key = jax.random.PRNGKey(20 + k)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, key))(jpt)
    ct = TS.encrypt(ctx, keys, pt, JaxReplay(enc_keys=[key]))
    assert ct.scale == jct.scale
    assert np.array_equal(u32(ct.data), np.asarray(jct.data))
    dec = TS.decrypt(ctx, keys, ct)
    assert np.array_equal(u32(dec.data), np.asarray(JS.decrypt(jctx, jkeys, jct).data))
    re, im = TS.decode_ri(ctx, dec)
    assert np.max(np.abs(re.numpy() - vre)) < 1e-6


@pytest.mark.parametrize("k", [2, 6])
def test_encrypt_k14_route_bit_equal_with_replayed_draws(pair, monkeypatch, k):
    """``encrypt`` down K14's route (the CPU standing in for the card, the
    launch for K14's floor-mod and arithmetic, ``encrypt_model``) with the
    JAX package's draws: three ciphertexts in one launch, each row bit-equal
    to the JAX package's encryption under its own key."""
    from encrypt_model import kernel_model
    from hectr_tpu_torch.ops import encrypt_cuda as EC

    ctx, jctx, keys, jkeys = pair
    vre, vim = _slots(30 + k)
    jpt = jencode(jctx, vre, vim, k)
    pt = interop.plaintext(jpt.data, jpt.scale, CPU)
    enc_keys = list(jax.random.split(jax.random.PRNGKey(40 + k), 3))
    jencrypt = jax.jit(lambda p, key: JS.encrypt(jctx, jkeys, p, key))
    want = [np.asarray(jencrypt(jpt, key).data) for key in enc_keys]
    monkeypatch.setattr(TS, "on_card", lambda x: True)
    monkeypatch.setattr(EC, "_launch", kernel_model)
    before = EC.LAUNCHES["encrypt"]
    ct = TS.encrypt(ctx, keys, TS.Plaintext(pt.data.expand(3, -1, -1),
                                            pt.scale),
                    JaxReplay(enc_keys=enc_keys))
    assert EC.LAUNCHES["encrypt"] == before + 1
    assert ct.data.shape == (3, 2, k, ctx.n)
    for row, w in zip(ct.data, want):
        assert np.array_equal(u32(row), w)


def test_torch_sampler_roundtrip_and_distribution():
    ctx, _ = contexts(PRESET)
    sampler = TS.TorchSampler(7, CPU)
    keys = TS.keygen(ctx, sampler, CPU)
    s, a, e = TS.TorchSampler(7, CPU).keygen(ctx, CPU)
    assert set(s.unique().tolist()) <= {-1, 0, 1}
    assert a.shape == (ctx.max_limbs, ctx.n)
    assert bool((a < torch.tensor(ctx.data_primes)[:, None]).all())
    assert e.abs().max() < 40
    vre, vim = _slots(8)
    ct = TS.encrypt(ctx, keys, TS.encode(
        ctx, (torch.from_numpy(vre), torch.from_numpy(vim)), ctx.max_limbs),
        sampler)
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, ct))
    assert np.max(np.abs(re.numpy() - vre)) < 1e-6
    assert np.max(np.abs(im.numpy() - vim)) < 1e-6


# ---- arithmetic and rescale -----------------------------------------------


def _jct(jctx, jkeys, seed, k=6):
    vre, vim = _slots(seed)
    jpt = jencode(jctx, vre, vim, k)
    return jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(seed)))(jpt)


def test_arithmetic_bit_equal(pair):
    ctx, jctx, _, jkeys = pair
    ja, jb = _jct(jctx, jkeys, 1), _jct(jctx, jkeys, 2)
    a = interop.ciphertext(ja.data, ja.scale, CPU)
    b = interop.ciphertext(jb.data, jb.scale, CPU)
    jpt = jencode(jctx, np.linspace(-1, 1, 16), np.zeros(16), 6,
                  jctx.pair_scale(6))
    pt = interop.plaintext(jpt.data, jpt.scale, CPU)
    cases = [
        (TS.add(ctx, a, b), JS.add(jctx, ja, jb)),
        (TS.sub(ctx, a, b), JS.sub(jctx, ja, jb)),
        (TS.neg(ctx, a), JS.neg(jctx, ja)),
        (TS.mul_pt(ctx, a, pt), JS.mul_pt(jctx, ja, jpt)),
        (TS.mod_down_pair(ctx, a), JS.mod_down_pair(jctx, ja)),
        (TS.mod_down_to(ctx, a, 3), JS.mod_down_to(jctx, ja, 3)),
    ]
    for got, want in cases:
        assert got.scale == want.scale
        assert np.array_equal(u32(got.data), np.asarray(want.data))
    jp0 = jencode(jctx, np.ones(16), np.zeros(16), 6)
    got = TS.add_pt(ctx, a, interop.plaintext(jp0.data, jp0.scale, CPU))
    assert np.array_equal(u32(got.data), np.asarray(JS.add_pt(jctx, ja, jp0).data))
    with pytest.raises(ValueError):
        TS.add(ctx, a, TS.mod_down_pair(ctx, b))


def test_drop_one_and_rescale_pair_bit_equal(pair):
    ctx, jctx, keys, jkeys = pair
    ja = _jct(jctx, jkeys, 3)
    a = interop.ciphertext(ja.data, ja.scale, CPU)
    want = jax.jit(lambda d: JS._drop_one(jctx, d))(ja.data)
    assert np.array_equal(u32(TS._drop_one(ctx, a.data)), np.asarray(want))
    jpt = jencode(jctx, np.linspace(-1, 1, 16), np.zeros(16), 6,
                  jctx.pair_scale(6))
    jprod = JS.mul_pt(jctx, ja, jpt)
    prod = TS.mul_pt(ctx, a, interop.plaintext(jpt.data, jpt.scale, CPU))
    got = TS.rescale_pair(ctx, prod)
    want = jax.jit(lambda c: JS.rescale_pair(jctx, c))(jprod)
    assert got.scale == want.scale == Fraction(ja.scale)
    assert np.array_equal(u32(got.data), np.asarray(want.data))
    re, _ = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    jre, _ = jax.jit(lambda c: JS.decode_ri(jctx, JS.decrypt(jctx, jkeys, c)))(want)
    assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= 1e-12


def test_double_double_ops_bit_equal():
    """The error-free transforms give the same float64 pairs as the JAX
    package's, op for op."""
    from hectr_tpu.ckks import dd as jdd
    from hectr_tpu_torch.ckks import dd as tdd

    rng = np.random.default_rng(9)
    a = rng.uniform(-1e6, 1e6, 256) * 10.0 ** rng.integers(-8, 8, 256)
    b = rng.uniform(-1e6, 1e6, 256)
    c = rng.uniform(1e8, 2**30, 256)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    ja, jb, jc = (jnp.asarray(x) for x in (a, b, c))
    x, jx = tdd.two_sum(ta, tb), jdd.two_sum(ja, jb)
    y, jy = tdd.two_prod(ta, tc), jdd.two_prod(ja, jc)
    cases = [
        (x, jx), (y, jy),
        (tdd.dd_add(x, y), jdd.dd_add(jx, jy)),
        (tdd.dd_add_f(x, tc), jdd.dd_add_f(jx, jc)),
        (tdd.dd_mul(x, y), jdd.dd_mul(jx, jy)),
        (tdd.dd_div_ff(tb, tc), jdd.dd_div_ff(jb, jc)),
        (tdd.dd_neg(x), jdd.dd_neg(jx)),
        ((tdd.dd_round(y),), (jdd.dd_round(jy),)),
        ((tdd.dd_to_float(y),), (jdd.dd_to_float(jy),)),
    ]
    for i, (got, want) in enumerate(cases):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), i
