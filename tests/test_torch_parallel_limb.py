"""The limb axis of the port (``hectr_tpu_torch.parallel``: limb meshes,
the sharding helpers, ``parallel.limb_ops.LimbOps``, the regulator and
the batch x limb step on a limb mesh) held against the JAX package.

tests/test_parallel.py's cases run through the port, each held bit for
bit to the JAX package's GSPMD run (``jax.jit`` with
``in_shardings=ct_sharding(...)`` on the conftest's 8 virtual CPU
devices).  Then every ``LimbOps`` op at logN = 10 (two special primes,
width-2 digits, so 6 + 2 rows) on ``LocalLimbMesh(D)`` for D = 1-4 and
D = 5 (the special rows split over two shards, a shard empty below the
top level), each bit-equal to the single-device op; rotate and the gemv
also to the jitted JAX op on the JAX package's keys and draws.
Residues: tolerance 0.  Decoded values: 1e-9 of the JAX decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks.modmath import add_mod as jadd_mod
from hectr_tpu.parallel import ct_sharding as jct_sharding
from hectr_tpu.parallel import make_mesh as jmake_mesh
from hectr_tpu.parallel import shard_ciphertext as jshard_ciphertext
from hectr_tpu_torch import cli, entry, interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.modmath import add_mod
from hectr_tpu_torch.control.mpc import MPCBounds
from hectr_tpu_torch.control.simulate import simulate_batch
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.parallel import (
    LimbRows,
    LocalLimbMesh,
    ct_sharding,
    place,
    gather_ciphertext,
    key_sharding,
    make_mesh,
    pt_sharding,
    shard_ciphertext,
    shard_key,
    shard_plaintext,
)
from hectr_tpu_torch.parallel.limb_ops import LimbOps
from tests.test_torch_keyswitch import _reference_diag_encoding
from tests.test_torch_scheme import CPU, PRESET_HYBRID, contexts, jencode, u32

torch.set_num_threads(1)

# tests/test_parallel.py's preset
PAR = dict(name="par-test", logn=10, slots=16, scale_bits=50, limb_bits=25,
           mult_depth=1)
SIZES = [1, 2, 3, 4, 5]
ROTATIONS = [1, 2, 3, 4, 5, 8, 12]      # diagonals 1, 5 and the BSGS set
V = np.linspace(-2, 2, 16)
_rng = np.random.default_rng(24)
_idx = np.arange(16)
M = np.zeros((16, 16))
M[_idx, _idx] = _rng.normal(size=16)
M[_idx, (_idx + 1) % 16] = _rng.normal(size=16)
M[_idx, (_idx + 5) % 16] = _rng.normal(size=16)
M_DENSE = np.random.default_rng(25).normal(size=(16, 16))


# ---------------------------------------------------------------------------
# tests/test_parallel.py through the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def par():
    """(ctx, jctx, JAX keys, port keys, the JAX encrypt (jitted: eager
    JAX CKKS compiles op by op) of a value under PRNGKey(seed))."""
    ctx, jctx = contexts(PAR)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    enc = jax.jit(lambda p, key: JS.encrypt(jctx, jkeys, p, key))

    def jencrypt(value, seed):
        jpt = jencode(jctx, value * np.ones(ctx.slots), np.zeros(ctx.slots),
                      jctx.max_limbs)
        return enc(jpt, jax.random.PRNGKey(seed))
    return (ctx, jctx, jkeys, interop.keyset(jkeys.sk, jkeys.pk, CPU),
            jencrypt)


def _port(jct):
    return interop.ciphertext(jct.data, jct.scale, CPU)


def _mesh(size):
    return make_mesh(limb=size, device="cpu")


def test_mesh_construction():
    mesh = make_mesh(batch=4, limb=2, device="cpu")
    jmesh = jmake_mesh(batch=4, limb=2)
    assert tuple(mesh.shape.values()) == jmesh.devices.shape == (4, 2)
    assert mesh.axis_names == jmesh.axis_names == ("batch", "limb")
    assert isinstance(mesh.limb, LocalLimbMesh) and mesh.limb.size == 2
    assert mesh.device == CPU and mesh.batch_index is None
    assert ct_sharding(mesh).spec == (None, "limb", None)
    assert ct_sharding(mesh, batched=True).spec == ("batch", None, "limb", None)
    assert pt_sharding(mesh, batched=True).spec == ("batch", "limb", None)
    assert key_sharding(mesh).spec == (None, None, "limb", None)
    with pytest.raises(ValueError):
        make_mesh(batch=0, limb=2, device="cpu")


def test_limb_sharded_homomorphic_add(par):
    """ct add with limb-sharded operands, bit-equal to the JAX package's
    GSPMD-sharded add."""
    ctx, jctx, _, _, jencrypt = par
    jmesh = jmake_mesh(batch=1, limb=2)
    v = np.arange(ctx.slots, dtype=np.float64)
    ca, cb = (jencrypt(v, seed) for seed in (1, 2))
    want = np.asarray(jax.jit(
        lambda a, b: JS.add(jctx, JS.Ciphertext(a, ca.scale),
                            JS.Ciphertext(b, cb.scale)).data,
        in_shardings=(jct_sharding(jmesh), jct_sharding(jmesh)))(
        jshard_ciphertext(ca, jmesh).data, jshard_ciphertext(cb, jmesh).data))
    mesh = make_mesh(batch=1, limb=2, device="cpu")
    ops = LimbOps(ctx, mesh)
    la, lb = (shard_ciphertext(ctx, _port(c), mesh) for c in (ca, cb))
    assert [x.shape[-2] for x in la.parts] == [3, 1]   # blocks of 4 + 1 rows
    got = gather_ciphertext(ctx, ops.add(la, lb), mesh)
    assert np.array_equal(u32(got.data), want)
    assert np.array_equal(u32(got.data),
                          u32(TS.add(ctx, _port(ca), _port(cb)).data))


def test_limb_sharded_full_decrypt_path(par):
    """encrypt -> mul_pt -> rescale_pair -> decrypt -> decode with the
    ciphertext sharded over the limb axis: residues bit-equal to the JAX
    package's GSPMD run, the decode within 1e-9 of it and 6.0 to 1e-8."""
    ctx, jctx, jkeys, keys, jencrypt = par
    jmesh = jmake_mesh(batch=1, limb=2)
    k = jctx.max_limbs
    jct = jencrypt(3.0, 3)
    jpt2 = jencode(jctx, 2 * np.ones(ctx.slots), np.zeros(ctx.slots), k,
                   scale=jctx.pair_scale(k))

    def f(data):
        out = JS.rescale_pair(jctx, JS.mul_pt(jctx, JS.Ciphertext(
            data, jct.scale), jpt2))
        dec = JS.decrypt(jctx, jkeys, out)
        return out.data, dec.data, JS.decode(jctx, dec)

    jout, jdec, jval = (np.asarray(x) for x in jax.jit(
        f, in_shardings=(jct_sharding(jmesh),))(
        jshard_ciphertext(jct, jmesh).data))
    mesh = make_mesh(batch=1, limb=2, device="cpu")
    ops = LimbOps(ctx, mesh)
    pt2 = interop.plaintext(jpt2.data, jpt2.scale, CPU)
    out = ops.rescale_pair(ops.mul_pt(shard_ciphertext(ctx, _port(jct), mesh),
                                      shard_plaintext(ctx, pt2, mesh)))
    assert np.array_equal(u32(gather_ciphertext(ctx, out, mesh).data), jout)
    dec = ops.decrypt(ops.shard_keyset(keys), out)
    assert np.array_equal(u32(torch.cat(dec.parts, dim=-2)), jdec)
    val = ops.decode(dec).numpy()
    assert np.max(np.abs(val - jval)) <= 1e-9
    assert np.max(np.abs(val.real - 6.0)) <= 1e-8
    assert set(ops.gathered) == {"rescale row", "decode digits"}


def test_batched_ct_sharding(par):
    """A batch of ciphertexts sharded over (batch, limb): add_mod per
    shard, bit-equal to the JAX package's sharded add_mod."""
    ctx, jctx, _, _, jencrypt = par
    jmesh = jmake_mesh(batch=4, limb=2)
    batch = jnp.stack([jencrypt(1.0, 10 + i).data
                       for i in range(4)])                   # [4, 2, L, N]
    jt = jctx.tables(jctx.max_limbs)
    want = np.asarray(jax.jit(lambda x: jadd_mod(x, x, jt.p))(
        jax.device_put(batch, jct_sharding(jmesh, batched=True))))
    mesh = make_mesh(batch=4, limb=2, device="cpu")
    ops = LimbOps(ctx, mesh)
    ct = TS.Ciphertext(interop.residues(batch, CPU), ctx.delta)
    lct = shard_ciphertext(ctx, ct, mesh, batched=True)
    assert [x.shape for x in lct.parts] == [(4, 2, 3, ctx.n), (4, 2, 1, ctx.n)]
    got = ops.add(lct, lct)
    assert np.array_equal(u32(ops.gather_ct(got).data), want)
    t = ctx.tables(ctx.max_limbs, CPU)
    assert torch.equal(ops.gather_ct(got).data, add_mod(ct.data, ct.data, t.p))


def test_limb_rows_blocks():
    """Contiguous blocks of the extended chain, the first ones longer; a
    level-k tensor's shard holds its block's rows below k."""
    rows = LimbRows(22, 2, 3)
    assert rows.blocks == ((0, 8), (8, 16), (16, 24))
    assert rows.data_sizes(22) == [8, 8, 6] and rows.special_sizes() == [0, 0, 2]
    assert rows.data_sizes(6) == [6, 0, 0]
    assert LimbRows(6, 2, 5).blocks == ((0, 2), (2, 4), (4, 6), (6, 7), (7, 8))
    assert LimbRows(6, 2, 5).special_sizes() == [0, 0, 0, 1, 1]
    idx = LimbRows(6, 2, 2).key_index(1, 5)    # block rows 4..7: data 4, specials
    assert idx.tolist() == [0, 2, 3]
    assert LimbRows(6, 2, 2).key_index(1, 6) is None
    with pytest.raises(ValueError):
        LimbRows(6, 2, 0)


# ---------------------------------------------------------------------------
# LimbOps at logN = 10 against the single device and the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    ctx, jctx = contexts(PRESET_HYBRID)
    k = ctx.max_limbs
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(20))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(21),
                               rotations=ROTATIONS)
    rk = interop.rotation_keys({r: np.asarray(x) for r, x in jrk.items()}, CPU)
    jrelin = JK.gen_relin_key(jctx, jkeys, jax.random.PRNGKey(22))
    relin = interop.residues(jrelin, CPU)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(23)))(
        jencode(jctx, V, np.zeros(16), k))
    ct = interop.ciphertext(jct.data, jct.scale, CPU)
    jrot = {r: np.asarray(jax.jit(lambda c, r=r: JK.rotate(jctx, c, r, jrk)
                                  .data)(jct)) for r in (1, 5)}
    return dict(ctx=ctx, jctx=jctx, k=k, keys=keys, rk=rk, jrk=jrk,
                relin=relin, ct=ct, jct=jct, jrot=jrot)


def _gathered(ops, lct):
    return ops.gather_ct(lct).data


@pytest.mark.parametrize("size", SIZES)
def test_rescale_pair_and_level_ops(setup, size):
    """mul_pt, rescale_pair (twice: down to the base chain), add_pt,
    sub, neg, mod_down_pair and mod_down_to, bit-equal to the single
    device at every level."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    ops = LimbOps(ctx, _mesh(size))
    pt2 = TS.encode(ctx, 2.0 * np.ones(16) + 0j, k, scale=ctx.pair_scale(k))
    want = TS.rescale_pair(ctx, TS.mul_pt(ctx, ct, pt2))
    got = ops.rescale_pair(ops.mul_pt(ops.shard_ct(ct), ops.shard_pt(pt2)))
    assert got.scale == want.scale and got.limbs == want.limbs == k - 2
    assert torch.equal(_gathered(ops, got), want.data)
    pt3 = TS.encode(ctx, 0.5 * np.ones(16) + 0j, k - 2,
                    scale=ctx.pair_scale(k - 2))
    want2 = TS.rescale_pair(ctx, TS.mul_pt(ctx, want, pt3))
    got2 = ops.rescale_pair(ops.mul_pt(got, ops.shard_pt(pt3)))
    assert torch.equal(_gathered(ops, got2), want2.data)
    ptw = TS.encode(ctx, V + 0j, k - 2, scale=want.scale)
    for name, g, w in (
            ("add_pt", ops.add_pt(got, ops.shard_pt(ptw)),
             TS.add_pt(ctx, want, ptw)),
            ("sub", ops.sub(got, got), TS.sub(ctx, want, want)),
            ("neg", ops.neg(got), TS.neg(ctx, want)),
            ("mod_down_pair", ops.mod_down_pair(ops.shard_ct(ct)),
             TS.mod_down_pair(ctx, ct)),
            ("mod_down_to", ops.mod_down_to(ops.shard_ct(ct), 3),
             TS.mod_down_to(ctx, ct, 3))):
        assert torch.equal(_gathered(ops, g), w.data), name
    with pytest.raises(ValueError):
        ops.add(got, ops.shard_ct(ct))
    with pytest.raises(ValueError):
        ops.mod_down_to(got, k)


@pytest.mark.parametrize("size", SIZES)
def test_digit_decomposition(setup, size):
    """Each shard's extended digits are its rows of decompose_digits,
    at the top level and mid-chain (a shard's target rows start inside
    the chain)."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    ops = LimbOps(ctx, _mesh(size))
    for level in (k, k - 1, k - 2):
        c1 = ct.data[1, :level]
        want = TK.decompose_digits(ctx, c1)
        got = ops.decompose(ops.shard_data(c1), level)
        for s, part in zip(ops.held, got):
            lo, hi = ops.rows.data_rows(s, level)
            a, b = ops.rows.special_rows(s)
            idx = torch.cat([torch.arange(lo, hi),
                             torch.arange(level + a, level + b)])
            assert torch.equal(part, want.index_select(-2, idx)), (level, s)


@pytest.mark.parametrize("size", SIZES)
def test_key_switch_and_rotate(setup, size):
    """key_switch and rotate bit-equal to the single device at the top
    level and at k - 2; rotate also to the jitted JAX rotation."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    ops = LimbOps(ctx, _mesh(size))
    keys = ops.shard_keys(setup["rk"])
    poly = ct.data[1]
    ks = ops.key_switch(ops.shard_data(poly), keys[3], k)
    assert torch.equal(torch.cat(ks, dim=-2),
                       TK.key_switch(ctx, poly, setup["rk"][3]))
    for r in (1, 5):
        got = ops.rotate(ops.shard_ct(ct), r, keys)
        assert np.array_equal(u32(_gathered(ops, got)), setup["jrot"][r])
    low = TS.mod_down_pair(ctx, ct)
    got = ops.rotate(ops.shard_ct(low), 3, keys)
    assert torch.equal(_gathered(ops, got),
                       TK.rotate(ctx, low, 3, setup["rk"]).data)
    lct = ops.shard_ct(ct)
    assert ops.rotate(lct, 16, keys) is lct


@pytest.mark.parametrize("layout", ["stored", "compact"])
@pytest.mark.parametrize("size", SIZES)
def test_mul_ct(setup, size, layout):
    """ct x ct + relinearisation under a [dnum, 4, K+S, N] stored or a
    [dnum, 2, K+S, N] compact key, both sharded the same way, at the top
    level and at k - 2."""
    ctx, ct = setup["ctx"], setup["ct"]
    relin = setup["relin"]
    if layout == "compact":
        relin = relin[:, :2].contiguous()
    ops = LimbOps(ctx, _mesh(size))
    rl = ops.shard_key(relin)
    for c in (ct, TS.mod_down_pair(ctx, ct)):
        want = TK.mul_ct(ctx, c, c, relin)
        got = ops.mul_ct(ops.shard_ct(c), ops.shard_ct(c), rl)
        assert got.scale == want.scale
        assert torch.equal(_gathered(ops, got), want.data)


@pytest.fixture(scope="module")
def jax_gemvs(setup):
    jctx, jrk, jct, k = setup["jctx"], setup["jrk"], setup["jct"], setup["k"]
    out = {}
    for method, mat in (("diag", M), ("bsgs", M_DENSE)):
        rk = jrk if method == "diag" else {
            r: jrk[r] for r in TG.bsgs_rotations(16)}
        jmat = JG.gemv_materials(jctx, mat, k, rk, method=method)
        out[method] = np.asarray(jax.jit(lambda m, c: JG.gemv_apply(
            jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(
            jmat, jct.data))
    return out


@pytest.mark.parametrize("method", ["diag", "bsgs"])
@pytest.mark.parametrize("size", SIZES)
def test_gemv(setup, jax_gemvs, monkeypatch, size, method):
    """The hoisted diagonal and the BSGS gemv on materials sharded by
    row, bit-equal to the single device and to the jitted JAX gemv (both
    sides given the JAX package's diagonal plaintexts)."""
    ctx, k, ct = setup["ctx"], setup["k"], setup["ct"]
    monkeypatch.setattr(TG, "_encode_diags",
                        _reference_diag_encoding(setup["jctx"]))
    mat_np = M if method == "diag" else M_DENSE
    ops = LimbOps(ctx, _mesh(size))
    mat = ops.gemv_materials(mat_np, k, setup["rk"], CPU, method)
    got = ops.gemv_apply(mat, ops.shard_ct(ct))
    want = TG.gemv_apply(ctx, TG.gemv_materials(ctx, mat_np, k, setup["rk"],
                                                CPU, method), ct)
    assert got.scale == want.scale == ct.scale and got.limbs == k - 2
    assert torch.equal(_gathered(ops, got), want.data)
    assert np.array_equal(u32(want.data), jax_gemvs[method])
    with pytest.raises(ValueError, match="built for"):
        ops.gemv_apply(mat, ops.mod_down_pair(ops.shard_ct(ct)))


@pytest.mark.parametrize("size", [2, 5])
def test_encode_encrypt_decrypt_decode(setup, size):
    """encode, encrypt (the global draws, each shard's rows), decrypt
    and decode bit-equal to the single device; sharded keys hold their
    blocks of sk and pk."""
    ctx, k, keys = setup["ctx"], setup["k"], setup["keys"]
    ops = LimbOps(ctx, _mesh(size))
    lk = ops.shard_keyset(keys)
    assert torch.equal(torch.cat(lk.sk, dim=-2), keys.sk)
    assert torch.equal(torch.cat(lk.pk, dim=-2), keys.pk)
    vals = torch.from_numpy(np.stack([V, -V])) + 0j           # two rows
    want_pt = TS.encode(ctx, vals, k)
    pt = ops.encode(vals, k)
    assert torch.equal(torch.cat(pt.parts, dim=-2), want_pt.data)
    want = TS.encrypt(ctx, keys, want_pt, TS.TorchSampler(5, CPU))
    got = ops.encrypt(lk, pt, TS.TorchSampler(5, CPU))
    assert torch.equal(_gathered(ops, got), want.data)
    dec = ops.decrypt(lk, got)
    want_dec = TS.decrypt(ctx, keys, want)
    assert torch.equal(torch.cat(dec.parts, dim=-2), want_dec.data)
    re, im = ops.decode_ri(dec)
    re1, im1 = TS.decode_ri(ctx, want_dec)
    assert torch.equal(re, re1) and torch.equal(im, im1)
    assert float((re - vals.real).abs().max()) < 1e-6


def test_sharding_helpers_and_key_bytes(setup):
    """shard_key gives the blocks of the extended chain (views on a local
    mesh); the key bytes per shard add up to the key's."""
    ctx, rk = setup["ctx"], setup["rk"]
    mesh = make_mesh(batch=1, limb=3, device="cpu")
    parts = shard_key(ctx, rk[1], mesh)
    assert [p.shape[2] for p in parts] == [3, 3, 2]
    assert parts[0].data_ptr() == rk[1].data_ptr()
    ops = LimbOps(ctx, mesh)
    assert sum(ops.key_bytes(parts)) == rk[1].numel() * 8
    assert torch.equal(torch.cat(ops.level_key(parts, 4), dim=2),
                       TK.slice_key(ctx, rk[1], 4))
    # gemv materials cut each key once: at the top level every gemv's key
    # is a view of its rotation's one set of blocks
    blocks = ops._blocks(rk[1])
    assert ops._blocks(rk[1]) is blocks
    assert ops._blocks(rk[1].clone()) is not blocks
    for m in (M, M_DENSE):
        mat = ops.gemv_materials(m, ctx.max_limbs, rk, CPU, "bsgs")
        baby = mat["bsgs"]["baby"][0]
        assert baby["r"] == 1
        assert [x.data_ptr() for x in baby["ksk"]] == [
            x.data_ptr() for x in blocks]


def test_placement_raises_off_the_mesh_device(setup):
    """A tensor on another device than the mesh's is refused, not moved."""
    ctx, ct = setup["ctx"], setup["ct"]
    mesh = make_mesh(limb=2, device="cpu")
    with pytest.raises(ValueError, match="for a mesh on cpu"):
        place(ct.data.to("meta"), ct_sharding(mesh), [(0, 3), (3, 6)])
    with pytest.raises(ValueError, match="spec"):
        place(ct.data[0, 0], ct_sharding(mesh), [(0, 3), (3, 6)])
    ops = LimbOps(ctx, mesh)
    with pytest.raises(ValueError, match="for a mesh on cpu"):
        ops.shard_ct(TS.Ciphertext(data=ct.data.to("meta"), scale=ct.scale))


# ---------------------------------------------------------------------------
# the regulator and the batch x limb step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bsgs_keys(setup):
    return {r: setup["rk"][r] for r in TG.bsgs_rotations(16)}


def test_regulator_on_a_limb_mesh(setup, bsgs_keys):
    """8 closed-loop steps over 2 loops with the reference-shaped
    regulator on LocalLimbMesh(3): x and u exactly equal to the unsharded
    batched regulator on the same draws, as is every canary."""
    ctx, keys = setup["ctx"], setup["keys"]
    model, plant = cli.cstr_setup()
    p = np.stack([cli.disturbance(8) * (1 + b / 2) for b in range(2)])
    ops = LimbOps(ctx, _mesh(3))
    out = []
    for op_set in (ops, None):
        reg = make_hempc_regulator(ctx, keys, bsgs_keys, model, plant, 4,
                                   ops=op_set)
        out.append(simulate_batch(
            model, plant, p, 1.0, 8, CPU, reg,
            hempc_init_state(TS.TorchSampler(6, CPU), CPU, (2,)), 4))
    (x, u, (_, canary)), (x1, u1, (_, canary1)) = out
    assert np.array_equal(x, x1) and np.array_equal(u, u1)
    assert torch.equal(canary, canary1) and bool((canary < 1e-5).all())
    assert set(ops.gathered) == {"digit stack", "special rows", "rescale row",
                                 "decode digits"}


def test_limb_regulator_with_du_bounds_raises(setup, bsgs_keys):
    ctx, keys = setup["ctx"], setup["keys"]
    model, plant = cli.cstr_setup()
    bounds = MPCBounds(dumin=np.array([-0.25, -0.004]),
                       dumax=np.array([0.25, 0.004]))
    with pytest.raises(ValueError, match="limb"):
        make_hempc_regulator(ctx, keys, bsgs_keys, model, plant, 4,
                             bounds=bounds, relin_key=setup["relin"],
                             ops=LimbOps(ctx, _mesh(2)))


def test_dryrun_batch_limb_step(capsys):
    """dryrun_multichip's first section at logN = 8 on the CPU: a 4 x 2
    mesh, one closed-loop step over 4 loops bit-equal to the unsharded
    batched step (x_next, u and every ciphertext)."""
    res = entry.batch_limb_step(8, "cpu")
    out = capsys.readouterr().out
    assert "mesh {'batch': 4, 'limb': 2}" in out
    assert "bit-equal to the unsharded batched step" in out
    assert res["x"].shape == (4, 2, 3) and res["u"].shape == (4, 1, 2)
    assert res["checked"] == 17 and bool(np.isfinite(res["x"]).all())
    with pytest.raises(ValueError):
        entry.batch_limb_step(3, "cpu")
