"""The port's fused single-ciphertext regulator (hempc/fused.py) held
against the JAX package's.

The packed matrices are exactly equal; one packed encryption is
bit-equal with the JAX package's draws replayed; one fused step decrypts
the same ciphertext bit for bit (both sides given the JAX package's
gemv-diagonal plaintexts) and decodes the same control to 1e-12; and
the port's fused closed loop meets the plaintext twin at the bar of
tests/test_fused.py (5e-10 per channel), at logN=10.
"""

import jax
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.hempc import fused as JF
from hectr_tpu.hempc import hempc_init_state as jinit
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.control.simulate import simulate
from hectr_tpu_torch.hempc import fused as TF
from hectr_tpu_torch.hempc import hempc_init_state
from tests.test_torch_control import port_setup
from tests.test_torch_qp_enc import reference_diag_encoding
from tests.test_torch_scheme import CPU, JaxReplay, contexts, u32

torch.set_num_threads(1)

SLICE = dict(name="test-fused", logn=10, slots=16, scale_bits=50,
             limb_bits=25, mult_depth=1)
XHAT, UHAT = np.array([0.01, -0.3, 0.004]), np.array([0.2, 0.0008])
XR, UR = np.array([0.005, -0.2, 0.002]), np.array([0.1, 0.0005])


def fused_enc_keys(key):
    """The encryption key of each step of the JAX fused regulator:
    key, k1 = split(key) (hectr_tpu/hempc/fused.py)."""
    while True:
        key, k1 = jax.random.split(key)
        yield k1


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def crypto():
    ctx, jctx = contexts(SLICE)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(3))
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(4),
                               rotations=JG.bsgs_rotations(16))
    rk = interop.rotation_keys({r: np.asarray(k) for r, k in jrk.items()}, CPU)
    return ctx, jctx, interop.keyset(jkeys.sk, jkeys.pk, CPU), jkeys, rk, jrk


def test_fused_matrices_equal():
    model, plant, _, _, _, jmodel, jplant = port_setup()
    for horizon in (2, 4):
        assert np.array_equal(TF.fused_u_matrix(model, plant, horizon, 16),
                              JF.fused_u_matrix(jmodel, jplant, horizon, 16))
        gs = np.linspace(1.0, 500.0, 2 * horizon)
        for g in (None, gs):
            assert np.array_equal(
                TF.fused_du_matrix(model, plant, horizon, 16, g),
                JF.fused_du_matrix(jmodel, jplant, horizon, 16, g))
    assert TF.pack_offset(16, 5) == JF.pack_offset(16, 5) == 8
    with pytest.raises(ValueError):
        TF.pack_offset(8, 5)


def test_enc_pack_bit_equal(crypto):
    ctx, jctx, keys, jkeys, _, _ = crypto
    key = jax.random.PRNGKey(10)
    want = jax.jit(lambda a, b, c, d: JF.enc_pack(jctx, jkeys, a, b, c, d,
                                                  key))(XHAT, UHAT, XR, UR)
    got = TF.enc_pack(ctx, keys, t64(XHAT), t64(UHAT), t64(XR), t64(UR),
                      JaxReplay(enc_keys=[key]))
    assert got.scale == want.scale and got.limbs == ctx.max_limbs
    assert np.array_equal(u32(got.data), np.asarray(want.data))
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    slots = np.zeros(16)
    slots[:3], slots[3:5], slots[8:11], slots[11:13] = XHAT, UHAT, XR, UR
    assert np.max(np.abs(re.numpy() - slots)) < 1e-8
    assert np.max(np.abs(im.numpy())) < 1e-5


def test_fused_step_bit_equal(crypto, monkeypatch):
    ctx, jctx, keys, jkeys, rk, jrk = crypto
    model, plant, _, _, _, jmodel, jplant = port_setup()
    jdecrypted = []
    jdecrypt = JS.decrypt

    def jspy(c, k, ct):
        jax.debug.callback(lambda d: jdecrypted.append(np.asarray(d)),
                           ct.data)
        return jdecrypt(c, k, ct)

    monkeypatch.setattr(JS, "decrypt", jspy)
    jmats = JF.make_fused_materials(jctx, jrk, jmodel, jplant, 4)
    jreg = jax.jit(JF.make_fused_regulator(jctx, jkeys, jmodel, jplant, 4,
                                           jmats))
    ju, _ = jreg(jinit(jax.random.PRNGKey(5)), XHAT, UHAT, XR, UR)

    monkeypatch.setattr(TG, "_encode_diag", reference_diag_encoding(jctx))
    decrypted = []
    decrypt = TS.decrypt

    def spy(c, k, ct):
        decrypted.append(u32(ct.data))
        return decrypt(c, k, ct)

    monkeypatch.setattr(TS, "decrypt", spy)
    mats = TF.make_fused_materials(ctx, rk, model, plant, 4, CPU)
    assert ("bsgs" in mats) == ("bsgs" in jmats)   # the same method
    reg = TF.make_fused_regulator(ctx, keys, model, plant, 4, mats)
    state = hempc_init_state(
        JaxReplay(enc_keys=fused_enc_keys(jax.random.PRNGKey(5))), CPU)
    u, (_, canary) = reg(state, t64(XHAT), t64(UHAT), t64(XR), t64(UR))
    assert len(decrypted) == len(jdecrypted) == 1
    assert np.array_equal(decrypted[0], jdecrypted[0])
    assert np.max(np.abs(u.numpy() - np.asarray(ju))) <= 1e-12
    assert float(canary) < 1e-5


def test_fused_loop_matches_plaintext_twin(crypto):
    """8 steps with a +10% inlet disturbance from k=3, as
    tests/test_torch_hempc.py runs the reference-shaped loop."""
    ctx, _, keys, _, rk, _ = crypto
    model, plant, _, dt, _, _, _ = port_setup()
    steps = 8
    p_seq = np.zeros((steps, 1))
    p_seq[3:, 0] = 0.1 * plant.ps[0]
    mats = TF.make_fused_materials(ctx, rk, model, plant, 4, CPU)
    reg = TF.make_fused_regulator(ctx, keys, model, plant, 4, mats)
    x, u, (_, canary) = simulate(
        model, plant, p_seq, dt, steps, CPU, regulator=reg,
        regulator_state=hempc_init_state(TS.TorchSampler(1, CPU), CPU),
        horizon=4, return_state=True)
    x_pt, u_pt = simulate(model, plant, p_seq, dt, steps, CPU, horizon=4)
    assert np.all(np.max(np.abs(x - x_pt), axis=0) < 5e-10)
    assert np.all(np.max(np.abs(u - u_pt), axis=0) < 5e-10)
    assert 0 < float(canary) < 1e-5
