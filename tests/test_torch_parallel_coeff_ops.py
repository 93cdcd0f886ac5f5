"""The port's coefficient-sharded scheme ops
(``hectr_tpu_torch.parallel.coeff_ops.CoeffOps`` on a local mesh) held
bit for bit against the JAX package's single-device ops, to which the
JAX package's own tests hold its sharded ops (tests/test_coeff_ops.py).

The harness is tests/test_torch_keyswitch.py's: the JAX package makes
the keys and the ciphertext, ``hectr_tpu_torch.interop`` carries them
over, every JAX call is jitted.  logN = 10, once with alpha = 1 and one
special prime and once with two specials and width-2 digits; rotation
keys in both layouts.  Residues: tolerance 0.  Decoded values: 1e-6,
imaginary part < 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import ntt as JN
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks.modmath import mul_mod as jmul_mod
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.parallel import LocalMesh
from hectr_tpu_torch.parallel.coeff_ops import CoeffOps
from tests.test_torch_keyswitch import _reference_diag_encoding
from tests.test_torch_scheme import (
    CPU,
    PRESET,
    PRESET_HYBRID,
    contexts,
    jencode,
    u32,
)

torch.set_num_threads(1)

V = np.linspace(-2, 2, 16)
ROTATIONS = [1, 3, 5]
# diagonals 0, 1 and 5, as tests/test_coeff_ops.py::test_sharded_gemv_bit_exact
_rng = np.random.default_rng(24)
_idx = np.arange(16)
M = np.zeros((16, 16))
M[_idx, _idx] = _rng.normal(size=16)
M[_idx, (_idx + 1) % 16] = _rng.normal(size=16)
M[_idx, (_idx + 5) % 16] = _rng.normal(size=16)


@pytest.fixture(scope="module", params=[PRESET, PRESET_HYBRID],
                ids=["alpha1", "hybrid"])
def setup(request):
    ctx, jctx = contexts(request.param)
    k = ctx.max_limbs
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(20))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(21),
                               rotations=ROTATIONS)
    rk = interop.rotation_keys({r: np.asarray(x) for r, x in jrk.items()}, CPU)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(23)))(
        jencode(jctx, V, np.zeros(16), k))
    ct = interop.ciphertext(jct.data, jct.scale, CPU)
    return dict(ctx=ctx, jctx=jctx, k=k, keys=keys, rk=rk, jrk=jrk, ct=ct,
                jct=jct)


def ops_for(setup, size):
    return CoeffOps(setup["ctx"], LocalMesh(size))


def decoded(setup, ct):
    re, im = TS.decode_ri(setup["ctx"], TS.decrypt(setup["ctx"],
                                                   setup["keys"], ct))
    return re.numpy(), im.numpy()


def test_local_mesh_chunks_are_whole_rows(setup):
    """On a local mesh shard and gather cost nothing, so ciphertexts pass
    between the sharded and the single-device ops unchanged."""
    ops = ops_for(setup, 4)
    data = setup["ct"].data
    assert ops.shard(data).data_ptr() == data.data_ptr()
    assert torch.equal(ops.gather(ops.shard(data)), data)
    with pytest.raises(ValueError, match="does not split"):
        CoeffOps(setup["ctx"], LocalMesh(1 << 10))


@pytest.mark.parametrize("size", [2, 4, 8])
def test_chain_ntt_and_negacyclic_mul(setup, size):
    ctx, jctx, k = setup["ctx"], setup["jctx"], setup["k"]
    rng = np.random.default_rng(size)
    pcol = np.array(ctx.data_primes[:k]).reshape(-1, 1)
    a = rng.integers(0, pcol, size=(k, ctx.n))
    b = rng.integers(0, pcol, size=(k, ctx.n))
    jt = jctx.tables(k)
    ja, jb = (jnp.asarray(x.astype(np.uint32)) for x in (a, b))
    ops = ops_for(setup, size)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    fwd = ops.ntt(ta)
    assert np.array_equal(u32(fwd), np.asarray(jax.jit(
        lambda x: JN.ntt(x, jt))(ja)))
    assert torch.equal(ops.intt(fwd), ta)
    want = jax.jit(lambda x, y: JN.intt(jmul_mod(
        JN.ntt(x, jt), JN.ntt(y, jt), jt.p, jt.mu, jt.k), jt))(ja, jb)
    assert np.array_equal(u32(ops.negacyclic_mul(ta, tb)), np.asarray(want))
    with pytest.raises(ValueError):
        ops.negacyclic_mul(ta, tb[:-1])


@pytest.mark.parametrize("size", [2, 8])
def test_rescale_pair(setup, size):
    """ct x pt then the composite rescale, on a real ciphertext."""
    ctx, jctx, k = setup["ctx"], setup["jctx"], setup["k"]
    jct = setup["jct"]
    jpt2 = jencode(jctx, 2.0 * np.ones(16), np.zeros(16), k,
                   scale=jctx.pair_scale(k))
    jprod = JS.mul_pt(jctx, jct, jpt2)
    want = jax.jit(lambda d: JS.rescale_pair(
        jctx, JS.Ciphertext(data=d, scale=jprod.scale)).data)(jprod.data)
    prod = interop.ciphertext(jprod.data, jprod.scale, CPU)
    got = ops_for(setup, size).rescale_pair(prod)
    assert got.scale == prod.scale / ctx.pair_scale(k) == setup["ct"].scale
    assert got.limbs == k - 2
    assert np.array_equal(u32(got.data), np.asarray(want))
    re, im = decoded(setup, got)
    assert np.max(np.abs(re - 2.0 * V)) < 1e-6
    assert np.max(np.abs(im)) < 1e-5


@pytest.fixture(scope="module")
def jax_rotations(setup):
    jctx, jrk, jct = setup["jctx"], setup["jrk"], setup["jct"]
    return {r: np.asarray(jax.jit(
        lambda c, r=r: JK.rotate(jctx, c, r, jrk).data)(jct))
        for r in (1, 3)}


@pytest.mark.parametrize("layout", ["full", "compact"])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("size", [2, 8])
def test_rotate(setup, jax_rotations, size, r, layout):
    """Both key layouts give the JAX package's rotation bit for bit (its
    compact keys give what its full keys give,
    tests/test_torch_keyswitch.py)."""
    rk = setup["rk"]
    if layout == "compact":
        rk = {x: key[:, :2].contiguous() for x, key in rk.items()}
    got = ops_for(setup, size).rotate(setup["ct"], r, rk)
    assert got.scale == setup["ct"].scale
    assert np.array_equal(u32(got.data), jax_rotations[r])
    re, im = decoded(setup, got)
    assert np.max(np.abs(re - np.roll(V, -r))) < 1e-6
    assert np.max(np.abs(im)) < 1e-5


def test_rotate_by_zero_is_the_identity(setup):
    ct = setup["ct"]
    assert ops_for(setup, 4).rotate(ct, 16, setup["rk"]) is ct


@pytest.fixture(scope="module")
def jax_gemv(setup):
    jctx, jrk, jct, k = setup["jctx"], setup["jrk"], setup["jct"], setup["k"]
    mat = JG.gemv_materials(jctx, M, k, jrk, method="diag")
    return np.asarray(jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(mat, jct.data))


@pytest.mark.parametrize("layout", ["full", "compact"])
@pytest.mark.parametrize("size", [2, 8])
def test_hoisted_gemv(setup, jax_gemv, monkeypatch, size, layout):
    """The hoisted diagonal gemv on the JAX package's diagonal plaintexts
    (its batch encoder rounds an ulp apart from a single encode,
    tests/test_torch_keyswitch.py::_reference_diag_encoding)."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    monkeypatch.setattr(TG, "_encode_diags",
                        _reference_diag_encoding(setup["jctx"]))
    rk = setup["rk"]
    if layout == "compact":
        rk = {x: key[:, :2].contiguous() for x, key in rk.items()}
    apply = ops_for(setup, size).make_gemv(M, k, rk, CPU)
    got = apply(ct)
    assert got.scale == ct.scale and got.limbs == k - 2
    assert np.array_equal(u32(got.data), jax_gemv)
    re, im = decoded(setup, got)
    assert np.max(np.abs(re - M @ V)) < 1e-6
    assert np.max(np.abs(im)) < 1e-5
    with pytest.raises(ValueError, match="built for"):
        apply(TS.mod_down_pair(ctx, ct))


def test_gemv_without_rotations(setup, monkeypatch):
    """A diagonal matrix needs no key switch: ct x pt and the rescale."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    monkeypatch.setattr(TG, "_encode_diags",
                        _reference_diag_encoding(setup["jctx"]))
    D0 = np.diag(np.linspace(0.5, 1.5, 16))
    got = ops_for(setup, 4).make_gemv(D0, k, {}, CPU)(ct)
    want = TG.make_gemv(ctx, D0, k, {}, CPU, "diag")(ct)
    assert torch.equal(got.data, want.data)
    re, _ = decoded(setup, got)
    assert np.max(np.abs(re - D0 @ V)) < 1e-6
