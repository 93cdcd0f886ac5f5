"""Full-slot packing in the port: the FFT embedding branch, batched
encode, complex decode, and encrypt / rotate / ct x ct / dense BSGS gemv
at slots = N/2, held against the JAX package.

Float results: the port's FFT keeps the JAX package's float64 operation
order stage for stage, so on the CPU it is bit-equal to the JAX code run
eagerly; the jitted JAX code differs in the last ulp (XLA contracts
multiply-adds into FMAs), and is held at 1e-12.  Integer results are
bit-equal (as uint32) given the reference's draws (``JaxReplay``) and
the JAX package's plaintexts, as in tests/test_torch_scheme.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import encoding as jenc
from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import encoding as tenc
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.context import make_context
from tests.test_torch_keyswitch import _reference_diag_encoding
from tests.test_torch_scheme import (
    CPU,
    JaxReplay,
    contexts,
    jencode,
    rotation_switch_keys,
    u32,
)

torch.set_num_threads(1)

# full packing at logN=8 (slots = N/2 = 128, the FFT branch), two special
# primes, width-2 digits, 8 data limbs: three mul_ct + rescale steps
FULL = dict(name="test-fullslot-8", logn=8, slots=128, scale_bits=50,
            limb_bits=25, mult_depth=3, special_limbs=2, digit_width=2)


def _uniform(seed, s, lo, hi):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, s), rng.uniform(lo, hi, s)


# ---- the embedding ---------------------------------------------------------


@pytest.mark.parametrize("s", [128, 1024])
def test_fft_embedding_matches_jax(s):
    vre, vim = _uniform(s, s, -1, 1)
    tre, tim = torch.from_numpy(vre), torch.from_numpy(vim)
    m = tenc.embed_ri(tre, tim, s)
    jre, jim = jnp.asarray(vre), jnp.asarray(vim)
    # eager: the same float64 operations in the same order -> bit-equal
    assert np.array_equal(m.numpy(), np.asarray(jenc.embed_ri(jre, jim, s)))
    assert torch.equal(tenc.embed(vre + 1j * vim, s), m)
    re, im = tenc.unembed(m, s)
    jr, ji = jenc.unembed(jnp.asarray(m.numpy()), s)
    assert np.array_equal(re.numpy(), np.asarray(jr))
    assert np.array_equal(im.numpy(), np.asarray(ji))
    # jitted: FMA contraction moves the last ulp
    jm = jax.jit(lambda a, b: jenc.embed_ri(a, b, s))(jre, jim)
    assert np.max(np.abs(m.numpy() - np.asarray(jm))) <= 1e-12
    jr, ji = jax.jit(lambda x: jenc.unembed(x, s))(jm)
    assert np.max(np.abs(re.numpy() - np.asarray(jr))) <= 1e-12
    assert np.max(np.abs(im.numpy() - np.asarray(ji))) <= 1e-12
    # the roundtrip, and the matrix embedding of the same slots
    assert np.max(np.abs(re.numpy() - vre)) <= 1e-12
    assert np.max(np.abs(im.numpy() - vim)) <= 1e-12
    ReE, ImE = tenc.embedding_matrices(s)
    assert np.max(np.abs(m.numpy() - (ReE.T @ vre + ImE.T @ vim) / s)) <= 1e-12


@pytest.mark.parametrize("s", [64, 128])
def test_slot_indices_partition_and_match_jax(s):
    pos, cpos = tenc.slot_indices(s)
    assert sorted(np.concatenate([pos, cpos]).tolist()) == list(range(2 * s))
    if s > jenc._MATRIX_MAX_SLOTS:
        jpos, jcpos = jenc._slot_indices(s)
        assert np.array_equal(pos, jpos) and np.array_equal(cpos, jcpos)
        assert all(np.array_equal(a, b) for a, b in
                   zip(tenc.cfft_tables(2 * s), jenc._cfft_tables(2 * s)))


@pytest.mark.parametrize("s", [16, 128])
def test_batched_embedding_equals_rows(s):
    """[..., s] -> [..., 2s]: each row of a batch is bit-equal to its own
    1-D embedding, on both branches."""
    rng = np.random.default_rng(s + 1)
    vre = torch.from_numpy(rng.uniform(-3, 3, (2, 3, s)))
    vim = torch.from_numpy(rng.uniform(-3, 3, (2, 3, s)))
    m = tenc.embed_ri(vre, vim, s)
    re, im = tenc.unembed(m, s)
    assert m.shape == (2, 3, 2 * s) and re.shape == im.shape == (2, 3, s)
    for i in range(2):
        for j in range(3):
            assert torch.equal(m[i, j], tenc.embed_ri(vre[i, j], vim[i, j], s))
            r1, i1 = tenc.unembed(m[i, j], s)
            assert torch.equal(re[i, j], r1) and torch.equal(im[i, j], i1)


@pytest.mark.parametrize("fields", [dict(FULL), dict(FULL, slots=16)],
                         ids=["fft", "matrix"])
def test_batched_encode_equals_rows_and_complex_input(fields):
    """encode over [R, s] equals R one-row encodes bit for bit (the gemv
    grid's batched encode), and a complex array encodes as its (re, im)
    pair."""
    ctx, _ = contexts(fields)
    s = ctx.slots
    rng = np.random.default_rng(3)
    V = rng.uniform(-2, 2, (5, s)) + 1j * rng.uniform(-2, 2, (5, s))
    k = 4
    pts = TS.encode(ctx, V, k, ctx.pair_scale(k))
    assert pts.data.shape == (5, k, ctx.n)
    for r in range(5):
        one = TS.encode(ctx, (torch.from_numpy(V[r].real),
                              torch.from_numpy(V[r].imag)), k, ctx.pair_scale(k))
        assert torch.equal(pts.data[r], one.data), r
    D = TG._encode_diags(ctx, V, k, ctx.pair_scale(k), CPU)
    assert torch.equal(D, pts.data)


# ---- decode, and the crypto at full packing --------------------------------


@pytest.fixture(scope="module")
def full():
    ctx, jctx = contexts(FULL)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    keys = TS.keygen(ctx, JaxReplay(jax.random.PRNGKey(0)), CPU)
    return ctx, jctx, keys, jkeys


def _encrypt_both(ctx, jctx, keys, jkeys, v, seed, k=None):
    """The JAX package's plaintext of v, encrypted by both packages with
    the same draws -> (ct, jct)."""
    k = ctx.max_limbs if k is None else k
    jpt = jencode(jctx, v.real, v.imag, k)
    key = jax.random.PRNGKey(seed)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, key))(jpt)
    ct = TS.encrypt(ctx, keys, interop.plaintext(jpt.data, jpt.scale, CPU),
                    JaxReplay(enc_keys=[key]))
    return ct, jct


def test_full_packing_keys_encrypt_decode(full):
    ctx, jctx, keys, jkeys = full
    assert ctx.slots == ctx.n // 2
    assert np.array_equal(u32(keys.sk), np.asarray(jkeys.sk))
    assert np.array_equal(u32(keys.pk), np.asarray(jkeys.pk))
    vre, vim = _uniform(1, ctx.slots, -5, 5)
    v = vre + 1j * vim
    ct, jct = _encrypt_both(ctx, jctx, keys, jkeys, v, 2)
    assert ct.scale == jct.scale
    assert np.array_equal(u32(ct.data), np.asarray(jct.data))
    pt = TS.decrypt(ctx, keys, ct)
    got = TS.decode(ctx, pt)
    assert got.dtype == torch.complex128 and got.shape == (ctx.slots,)
    want = jax.jit(lambda d: JS.decode(jctx, JS.Plaintext(d, pt.scale)))(
        jnp.asarray(u32(pt.data)))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-12
    assert np.max(np.abs(got.numpy().real - vre)) <= 1e-6
    assert np.max(np.abs(got.numpy().imag - vim)) <= 1e-6


def test_full_packing_rotation_bit_equal(full):
    ctx, jctx, keys, jkeys = full
    rots = [1, 7]
    key = jax.random.PRNGKey(3)
    jrk = JK.gen_rotation_keys(jctx, jkeys, key, rotations=rots)
    rk = TK.gen_rotation_keys(
        ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(key, rots)),
        rotations=rots)
    vre, _ = _uniform(4, ctx.slots, -3, 3)
    ct, jct = _encrypt_both(ctx, jctx, keys, jkeys, vre + 0j, 5)
    for r in rots:
        assert np.array_equal(u32(rk[r]), np.asarray(jrk[r])), r
        got = TK.rotate(ctx, ct, r, rk)
        want = jax.jit(lambda c: JK.rotate(jctx, c, r, jrk))(jct)
        assert np.array_equal(u32(got.data), np.asarray(want.data)), r
        dec = TS.decode(ctx, TS.decrypt(ctx, keys, got)).numpy()
        assert np.max(np.abs(dec.real - np.roll(vre, -r))) <= 1e-6
        assert np.max(np.abs(dec.imag)) < 1e-4


def test_full_packing_mul_ct_chain_bit_equal(full):
    """enc(v) * enc(w) (mod-downed to the running level), relinearised
    with a compact key and rescaled, three times (8 -> 2 limbs): each
    level bit-equal to the JAX package's, and within 1e-6 of v w^i."""
    ctx, jctx, keys, jkeys = full
    key = jax.random.PRNGKey(11)
    jrelin = JK.gen_relin_key(jctx, jkeys, key, compact=True)
    relin = TK.gen_relin_key(ctx, keys, JaxReplay(switch_keys=[key]),
                             compact=True)
    assert np.array_equal(u32(relin), np.asarray(jrelin))
    vre, vim = _uniform(6, ctx.slots, -0.7, 0.7)
    wre, wim = _uniform(7, ctx.slots, -0.7, 0.7)
    v, w = vre + 1j * vim, wre + 1j * wim
    a, ja = _encrypt_both(ctx, jctx, keys, jkeys, v, 8)
    b, jb = _encrypt_both(ctx, jctx, keys, jkeys, w, 9)
    want = v
    for step in range(3):
        k = a.limbs
        bk = TS.mod_down_to(ctx, b, k)
        a = TS.rescale_pair(ctx, TK.mul_ct(ctx, a, bk, relin))
        sa, sb = ja.scale, jb.scale

        def jstep(x, y, r):
            prod = JK.mul_ct(jctx, JS.Ciphertext(data=x, scale=sa),
                             JS.Ciphertext(data=y[:, :k], scale=sb), r)
            return JS.rescale_pair(jctx, prod).data

        ja = JS.Ciphertext(data=jax.jit(jstep)(ja.data, jb.data, jrelin),
                           scale=sa * sb / jctx.pair_scale(k))
        assert a.scale == ja.scale and a.limbs == k - 2
        assert np.array_equal(u32(a.data), np.asarray(ja.data)), step
        want = want * w
        got = TS.decode(ctx, TS.decrypt(ctx, keys, a)).numpy()
        assert np.max(np.abs(got - want)) <= 1e-6, step
    assert a.limbs == 2


def test_full_packing_dense_bsgs_gemv_bit_equal(full, monkeypatch):
    """A dense 128 x 128 matrix through BSGS with compact keys: the
    materials (permutations, keys, the rolled diagonal grid) and the
    output equal the JAX package's, given its diagonal plaintexts; the
    decoded output is within 1e-4 of M v."""
    ctx, jctx, keys, jkeys = full
    s = ctx.slots
    rots = TG.bsgs_rotations(s)
    assert len(rots) <= 2 * np.sqrt(s)
    key = jax.random.PRNGKey(10)
    jrk = JK.gen_rotation_keys(jctx, jkeys, key, rotations=rots, compact=True)
    rk = TK.gen_rotation_keys(
        ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(key, rots)),
        rotations=rots, compact=True)
    rng = np.random.default_rng(9)
    M = rng.normal(size=(s, s)) / np.sqrt(s)
    vre = rng.uniform(-2, 2, s)
    ct, jct = _encrypt_both(ctx, jctx, keys, jkeys, vre + 0j, 11)
    k = ctx.max_limbs

    monkeypatch.setattr(TG, "_encode_diags", _reference_diag_encoding(jctx))
    mat = TG.gemv_materials(ctx, M, k, rk, CPU, method="bsgs")["bsgs"]
    jmat = JG.gemv_materials(jctx, M, k, jrk, method="bsgs")
    jb = jmat["bsgs"]
    assert np.array_equal(np.stack([x["perm"].numpy() for x in mat["baby"]]),
                          np.asarray(jb["baby_perms"]))
    assert np.array_equal(u32(torch.stack([x["ksk"] for x in mat["baby"]])),
                          np.asarray(jb["baby_ksk"]))
    assert np.array_equal(np.stack([x["perm"].numpy() for x in mat["giant"]]),
                          np.asarray(jb["giant"]["perms"]))
    assert np.array_equal(u32(torch.stack([x["ksk"] for x in mat["giant"]])),
                          np.asarray(jb["giant"]["ksk"]))
    assert np.array_equal(u32(torch.stack([x["pt"] for x in mat["giant"]])),
                          np.asarray(jb["giant"]["pt"]))
    assert np.array_equal(u32(mat["pt0"]), np.asarray(jb["pt0"]))

    got = TG.gemv(ctx, M, ct, rk, method="bsgs")
    want = jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(jmat, jct.data)
    assert got.scale == ct.scale and got.limbs == k - 2
    assert np.array_equal(u32(got.data), np.asarray(want))
    dec = TS.decode(ctx, TS.decrypt(ctx, keys, got)).numpy()
    assert np.max(np.abs(dec.real - M @ vre)) <= 1e-4
    assert np.max(np.abs(dec.imag)) < 1e-3


def test_medium_preset_full_width():
    """MEDIUM itself (logN=14, 8192 slots, 12 limbs) on the CPU: encode,
    encrypt, rotate, ct x ct multiply + rescale, decode within the bars
    of tests/test_encoding_fullslot.py."""
    ctx = make_context(tcfg.MEDIUM)
    s, k = ctx.slots, ctx.max_limbs
    assert (ctx.n, s, k, ctx.dnum(k)) == (1 << 14, 8192, 12, 6)
    keys = TS.keygen(ctx, TS.TorchSampler(0, CPU), CPU)
    sampler = TS.TorchSampler(1, CPU)
    vre, vim = _uniform(12, s, -0.7, 0.7)
    v = vre + 1j * vim
    ct = TS.encrypt(ctx, keys, TS.encode(ctx, v, k), sampler)
    got = TS.decode(ctx, TS.decrypt(ctx, keys, ct)).numpy()
    assert np.max(np.abs(got - v)) <= 1e-6
    rk = TK.gen_rotation_keys(ctx, keys, sampler, rotations=[1], compact=True)
    got = TS.decode(ctx, TS.decrypt(ctx, keys, TK.rotate(ctx, ct, 1, rk)))
    assert np.max(np.abs(got.numpy() - np.roll(v, -1))) <= 1e-6
    relin = TK.gen_relin_key(ctx, keys, sampler, compact=True)
    sq = TS.rescale_pair(ctx, TK.mul_ct(ctx, ct, ct, relin))
    assert sq.limbs == k - 2
    got = TS.decode(ctx, TS.decrypt(ctx, keys, sq)).numpy()
    assert np.max(np.abs(got - v * v)) <= 1e-6
