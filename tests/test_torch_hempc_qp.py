"""The constrained slice as a whole: the port's encrypted regulator with
du box bounds (gemv pair -> encrypted PGD QP -> uhat + du) held against
the JAX package's on the same keys, for two steps.

JAX keys are carried over with ``hectr_tpu_torch.interop`` and the
regulator's encryption draws replayed, and both sides are given the JAX
package's gemv-diagonal and constant plaintexts (see
tests/test_torch_qp_enc.py::reference_diag_encoding).  Then the
ciphertext each step decrypts is bit-equal and the decoded control
agrees to 1e-12; the second step starts from the first one's control
and regulator state.
"""

import jax
import numpy as np
import torch

from hectr_tpu.ckks import scheme as JS
from hectr_tpu.control.mpc import MPCBounds as JBounds
from hectr_tpu.hempc import hempc_init_state as jinit
from hectr_tpu.hempc import make_hempc_regulator as jregulator
from hectr_tpu.hempc import qp_enc as JQ
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.control.mpc import MPCBounds
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.hempc import qp_enc as TQ
from tests.test_torch_control import port_setup
from tests.test_torch_qp_enc import BOX, qp_crypto, reference_diag_encoding
from tests.test_torch_scheme import CPU, JaxReplay, regulator_enc_keys, u32

torch.set_num_threads(1)

# deviations from the target inside the envelope B0 = 4 (as
# tests/test_qp_enc.py::test_constrained_encrypted_regulator_single_step)
XR = np.array([0.005, -0.2, 0.002])
UR = np.array([0.1, 0.0005])
XHAT = XR + np.array([0.00125, -0.075, 0.0005])
UHAT = UR + np.array([0.05, 0.000125])


def test_constrained_regulator_two_steps_bit_equal(monkeypatch):
    ctx, jctx, keys, jkeys, relin, jrelin, rk, jrk = qp_crypto()
    model, plant, _, _, _, jmodel, jplant = port_setup()
    kw = dict(qp_iters=1, qp_degree=3, qp_input_bound=4.0)

    jdecrypted = []
    jdecrypt = JS.decrypt

    def jspy(c, k, ct):
        jax.debug.callback(lambda d: jdecrypted.append(np.asarray(d)),
                           ct.data)
        return jdecrypt(c, k, ct)

    monkeypatch.setattr(JS, "decrypt", jspy)
    jreg = jax.jit(jregulator(jctx, jkeys, jrk, jmodel, jplant, 4,
                              bounds=JBounds(*BOX), relin_key=jrelin, **kw))
    ju1, jstate = jreg(jinit(jax.random.PRNGKey(7)), XHAT, UHAT, XR, UR)
    ju2, _ = jreg(jstate, XHAT, np.asarray(ju1), XR, UR)

    monkeypatch.setattr(TG, "_encode_diag", reference_diag_encoding(jctx))
    monkeypatch.setattr(TQ, "_const_pt", lambda c, v, k, scale, device:
                        interop.plaintext(JQ._const_pt(jctx, v, k, scale).data,
                                          scale, device))
    decrypted = []
    decrypt = TS.decrypt

    def spy(c, k, ct):
        decrypted.append(u32(ct.data))
        return decrypt(c, k, ct)

    monkeypatch.setattr(TS, "decrypt", spy)
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4,
                               bounds=MPCBounds(*BOX), relin_key=relin, **kw)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float64))

    state = hempc_init_state(
        JaxReplay(enc_keys=regulator_enc_keys(jax.random.PRNGKey(7))), CPU)
    u1, state = reg(state, t(XHAT), t(UHAT), t(XR), t(UR))
    u2, (_, canary) = reg(state, t(XHAT), u1, t(XR), t(UR))

    assert len(decrypted) == len(jdecrypted) == 2
    for got, want in zip(decrypted, jdecrypted):
        # du left at k_in - 14 = 2 limbs: the base primes
        assert got.shape == (2, 2, ctx.n)
        assert np.array_equal(got, want)
    for u, ju in ((u1, ju1), (u2, ju2)):
        assert np.max(np.abs(u.numpy() - np.asarray(ju))) <= 1e-12
        du = u.numpy() - (UHAT if u is u1 else u1.numpy())
        assert np.all(du <= BOX[1] + 1e-6) and np.all(du >= BOX[0] - 1e-6)
    assert float(canary) < 1e-5
