"""The port's key switching, rotations and encrypted gemv held bit for
bit against the JAX package, at a logN=10 preset with alpha=1 and one
special prime, and at one with two specials and width-2 digits.

Rotation keys are made twice: by the port with the reference's draws
replayed through its sampler hook (and compared), and by the JAX
package, then carried over with ``hectr_tpu_torch.interop`` for the
gemv cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import scheme as TS
from tests.test_torch_scheme import (
    CPU,
    PRESET,
    PRESET_HYBRID,
    JaxReplay,
    contexts,
    jencode,
    rotation_switch_keys,
    u32,
)

torch.set_num_threads(1)

ROTATIONS = [1, 2, 3, 7, 15]


@pytest.fixture(scope="module", params=[PRESET, PRESET_HYBRID],
                ids=["alpha1", "hybrid"])
def setup(request):
    ctx, jctx = contexts(request.param)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(1))
    rk = interop.rotation_keys({r: np.asarray(k) for r, k in jrk.items()}, CPU)
    v = np.linspace(-2, 2, 16)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(2)))(
        jencode(jctx, v, np.zeros(16), ctx.max_limbs))
    ct = interop.ciphertext(jct.data, jct.scale, CPU)
    return ctx, jctx, keys, jkeys, rk, jrk, ct, jct


def test_rotation_keys_bit_equal_with_replayed_draws(setup):
    ctx, jctx, keys, jkeys, _, _, _, _ = setup
    key = jax.random.PRNGKey(5)
    want = JK.gen_rotation_keys(jctx, jkeys, key, rotations=ROTATIONS)
    got = TK.gen_rotation_keys(
        ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(key, ROTATIONS)),
        rotations=ROTATIONS)
    assert sorted(got) == sorted(want) == ROTATIONS
    for r in ROTATIONS:
        assert got[r].shape == want[r].shape
        assert np.array_equal(u32(got[r]), np.asarray(want[r])), r


def test_eval_permutation_matches(setup):
    ctx = setup[0]
    for r in (1, 5, 15):
        g = TK.galois_element(r, ctx.n)
        assert g == JK.galois_element(r, ctx.n)
        assert np.array_equal(TK.eval_permutation(ctx.n, g),
                              JK.eval_permutation(ctx.n, g))


@pytest.mark.parametrize("k_drop", [0, 2])
def test_decompose_and_key_switch_bit_equal(setup, k_drop):
    """At the top level and one level down (keys sliced)."""
    ctx, jctx, _, _, rk, jrk, ct, jct = setup
    k = ctx.max_limbs - k_drop
    c1, jc1 = ct.data[1, :k], jct.data[1, :k]
    dig = TK.decompose_digits(ctx, c1)
    jdig = jax.jit(lambda c: JK.decompose_digits(jctx, c))(jc1)
    assert np.array_equal(u32(dig), np.asarray(jdig))
    ks = TK.key_switch(ctx, c1, rk[3])
    jks = jax.jit(lambda c, key: JK.key_switch(jctx, c, key))(jc1, jrk[3])
    assert np.array_equal(u32(ks), np.asarray(jks))


@pytest.mark.parametrize("r", [1, 7, 15])
def test_rotate_bit_equal(setup, r):
    ctx, jctx, keys, _, rk, jrk, ct, jct = setup
    got = TK.rotate(ctx, ct, r, rk)
    want = jax.jit(lambda c: JK.rotate(jctx, c, r, jrk))(jct)
    assert np.array_equal(u32(got.data), np.asarray(want.data))
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    assert np.max(np.abs(re.numpy() - np.roll(np.linspace(-2, 2, 16), -r))) < 1e-7


MATRICES = {
    # the controller's shape: an [8 x 3] block of the 16 x 16 layout
    "block": np.random.default_rng(7).normal(size=(8, 3)),
    "dense": np.random.default_rng(8).normal(size=(16, 16)),
}


def _reference_diag_encoding(jctx):
    """The JAX package's own encoding of a batch of gemv diagonals
    (_encode_batch, as its gemv materials make them).  Its float64
    embedding rounds differently from one call shape to another (even
    JAX's single-vector encode differs from it in the last ulp, and so
    after scaling by 2^50 by one unit), so a bit-for-bit gemv check
    feeds both sides the same diagonal plaintexts."""
    def encode(ctx, D, k, scale, device):
        vri = jnp.asarray(np.stack([D.real, D.imag], axis=1))
        res = np.asarray(JG._encode_batch(jctx, vri, k, scale))
        return torch.from_numpy(res.astype(np.int64)).to(device)
    return encode


@pytest.mark.parametrize("method", ["diag", "bsgs"])
@pytest.mark.parametrize("shape", sorted(MATRICES))
def test_gemv_bit_equal(setup, monkeypatch, method, shape):
    ctx, jctx, keys, _, rk, jrk, ct, jct = setup
    monkeypatch.setattr(TG, "_encode_diags", _reference_diag_encoding(jctx))
    M = MATRICES[shape]
    if method == "bsgs":
        need = TG.bsgs_rotations(ctx.slots)
        rk = {r: rk[r] for r in need}
        jrk = {r: jrk[r] for r in need}
    k = ctx.max_limbs
    mat = JG.gemv_materials(jctx, M, k, jrk, method=method)
    want = jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(mat, jct.data)
    got = TG.gemv(ctx, M, ct, rk, method=method)
    assert got.scale == ct.scale and got.limbs == k - 2
    assert np.array_equal(u32(got.data), np.asarray(want))
    v = np.zeros(16)
    v[:] = np.linspace(-2, 2, 16)
    Mz = np.zeros((16, 16))
    Mz[:M.shape[0], :M.shape[1]] = M
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    assert np.max(np.abs(re.numpy() - Mz @ v)) < 1e-7
    assert np.max(np.abs(im.numpy())) < 1e-5


@pytest.mark.parametrize("method", ["diag", "bsgs"])
def test_gemv_own_encoding_close_to_reference(setup, method):
    """With its own diagonal encodings the port's gemv differs from the
    reference's by encoding rounding only: far below the CKKS noise."""
    ctx, jctx, keys, jkeys, rk, jrk, ct, jct = setup
    M = MATRICES["dense"]
    k = ctx.max_limbs
    mat = JG.gemv_materials(jctx, M, k, jrk, method=method)
    want = jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)))(mat, jct.data)
    got = TG.gemv(ctx, M, ct, rk, method=method)
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    jre, jim = jax.jit(lambda c: JS.decode_ri(jctx, JS.decrypt(jctx, jkeys, c)))(want)
    assert np.max(np.abs(re.numpy() - np.asarray(jre))) < 1e-9
    assert np.max(np.abs(im.numpy() - np.asarray(jim))) < 1e-9


def test_gemv_auto_resolution_matches(setup):
    ctx, jctx, _, _, rk, jrk, _, _ = setup
    for M in MATRICES.values():
        for keyset in (None, TG.bsgs_rotations(ctx.slots)):
            sub = rk if keyset is None else {r: rk[r] for r in keyset}
            jsub = jrk if keyset is None else {r: jrk[r] for r in keyset}
            got = TG._resolve_method(ctx, M, sub, "auto")
            want = JG._resolve_method(jctx, M, jsub, "auto")
            assert got[0] == want[0] and got[2] == want[2]
    with pytest.raises(KeyError):
        TG._resolve_method(ctx, MATRICES["dense"], {1: None}, "auto")


# ---- ct x ct multiplication: relinearisation key, compact layout --------


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_relin_key_bit_equal_with_replayed_draws(setup, compact):
    ctx, jctx, keys, jkeys, _, _, _, _ = setup
    key = jax.random.PRNGKey(11)
    want = JK.gen_relin_key(jctx, jkeys, key, compact=compact)
    got = TK.gen_relin_key(ctx, keys, JaxReplay(switch_keys=[key]),
                           compact=compact)
    assert got.shape == want.shape == (
        ctx.dnum(ctx.max_limbs), 2 if compact else 4,
        ctx.max_limbs + len(ctx.special_primes), ctx.n)
    assert np.array_equal(u32(got), np.asarray(want))
    # int64 residues: twice the JAX package's uint32 bytes
    assert got.numel() * 8 == TK._key_bytes(ctx, compact) \
        == 2 * JK._key_bytes(jctx, compact)


def test_compact_rotation_keys_bit_equal_with_replayed_draws(setup):
    ctx, jctx, keys, jkeys, _, _, _, _ = setup
    key = jax.random.PRNGKey(6)
    want = JK.gen_rotation_keys(jctx, jkeys, key, rotations=ROTATIONS,
                                compact=True)
    got = TK.gen_rotation_keys(
        ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(key, ROTATIONS)),
        rotations=ROTATIONS, compact=True)
    full = TK.gen_rotation_keys(
        ctx, keys, JaxReplay(switch_keys=rotation_switch_keys(key, ROTATIONS)),
        rotations=ROTATIONS)
    assert sorted(got) == sorted(want) == ROTATIONS
    for r in ROTATIONS:
        assert got[r].shape[1] == 2
        assert np.array_equal(u32(got[r]), np.asarray(want[r])), r
        assert torch.equal(got[r], full[r][:, :2]), r   # the same (b, a)


@pytest.mark.parametrize("k_drop", [0, 2])
def test_compact_key_switch_bit_equal(setup, k_drop):
    """Barrett products with the compact key give the JAX package's
    result bit for bit, and the full layout's Shoup result too."""
    ctx, jctx, _, _, rk, jrk, ct, jct = setup
    k = ctx.max_limbs - k_drop
    c1, jc1 = ct.data[1, :k], jct.data[1, :k]
    got = TK.key_switch(ctx, c1, rk[3][:, :2].contiguous())
    want = jax.jit(lambda c, key: JK.key_switch(jctx, c, key))(
        jc1, jrk[3][:, :2])
    assert np.array_equal(u32(got), np.asarray(want))
    assert torch.equal(got, TK.key_switch(ctx, c1, rk[3]))


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_mul_ct_and_rescale_bit_equal(setup, compact):
    ctx, jctx, keys, jkeys, _, _, ct, jct = setup
    v = np.linspace(-2, 2, 16)
    w = np.cos(np.arange(16.0))
    jb = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(3)))(
        jencode(jctx, w, np.zeros(16), ctx.max_limbs))
    b = interop.ciphertext(jb.data, jb.scale, CPU)
    jrelin = JK.gen_relin_key(jctx, jkeys, jax.random.PRNGKey(12),
                              compact=compact)
    relin = interop.residues(jrelin, CPU)
    got = TK.mul_ct(ctx, ct, b, relin)
    scale = jct.scale

    def jmul(x, y, r):
        return JK.mul_ct(jctx, JS.Ciphertext(data=x, scale=scale),
                         JS.Ciphertext(data=y, scale=scale), r).data

    want = jax.jit(jmul)(jct.data, jb.data, jrelin)
    assert got.scale == scale * scale
    assert np.array_equal(u32(got.data), np.asarray(want))
    res = TS.rescale_pair(ctx, got)
    jres = jax.jit(lambda d: JS.rescale_pair(
        jctx, JS.Ciphertext(data=d, scale=scale * scale)).data)(want)
    assert res.scale == scale * scale / ctx.pair_scale(ctx.max_limbs)
    assert np.array_equal(u32(res.data), np.asarray(jres))
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, res))
    assert np.max(np.abs(re.numpy() - v * w)) < 1e-6
    assert np.max(np.abs(im.numpy())) < 1e-5
    with pytest.raises(ValueError):
        TK.mul_ct(ctx, ct, TS.mod_down_pair(ctx, b), relin)
