"""The port's encrypted box-constrained QP (hempc/qp_enc.py) held
against the JAX package's.

Host helpers (minimax fits, domains, step size, float64 reference, the
depth ledger) must be exactly equal; the encrypted pieces bit-equal on
the same keys and input ciphertexts (JAX keys carried over with
``hectr_tpu_torch.interop``); the plaintext mirror regulator equal to
1e-12 over the closed loops of tests/test_flagship_qp.py and of
scripts/run_flagship_qp_tpu.py.

The ring is small (logN=8, 18 data limbs) and the encrypted solver runs
at degree 3 with one iteration, so the JAX side compiles in seconds.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.control.mpc import MPCBounds as JBounds
from hectr_tpu.control.simulate import simulate as jsimulate
from hectr_tpu.hempc import qp_enc as JQ
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import ntt as ntt_mod
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.modmath import sub_mod
from hectr_tpu_torch.control.mpc import MPCBounds
from hectr_tpu_torch.control.simulate import simulate
from hectr_tpu_torch.hempc import qp_enc as TQ
from tests.test_qp_enc import _problem
from tests.test_torch_control import port_setup
from tests.test_torch_scheme import CPU, contexts, jencode, u32

torch.set_num_threads(1)

# 18 data limbs: the gemv pair leaves k_in = 16, and degree 3 with one
# iteration needs 6 + (2 + 6) = 14 below it, landing on the 2 base limbs
SMALL_QP = dict(name="test-qp", logn=8, slots=16, scale_bits=50,
                limb_bits=25, mult_depth=8, special_limbs=2, digit_width=2)
# the CSTR du box of tests/test_flagship_qp.py, over horizon 4
BOX = (np.array([-0.25, -0.004]), np.array([0.25, 0.004]))
LB, UB = np.tile(BOX[0], 4), np.tile(BOX[1], 4)


def qp_crypto():
    """(ctx, jctx, keys, jkeys, relin, jrelin, rk, jrk): JAX keys with
    a compact relinearisation key and compact BSGS rotation keys, and
    the same keys carried over to the port."""
    ctx, jctx = contexts(SMALL_QP)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    jrelin = JK.gen_relin_key(jctx, jkeys, jax.random.PRNGKey(1),
                              compact=True)
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(2),
                               rotations=JG.bsgs_rotations(16), compact=True)
    return (ctx, jctx, interop.keyset(jkeys.sk, jkeys.pk, CPU), jkeys,
            interop.residues(jrelin, CPU), jrelin,
            interop.rotation_keys({r: np.asarray(k) for r, k in jrk.items()},
                                  CPU), jrk)


def reference_diag_encoding(jctx):
    """The JAX package's encoding of gemv diagonals (_encode_batch).  Its
    float64 embedding may round one ulp apart from the port's matrix
    product, which after scaling is one unit of a plaintext coefficient,
    so a bit-for-bit solver check feeds both sides these plaintexts (as
    tests/test_torch_keyswitch.py::test_gemv_bit_equal does)."""
    def encode(ctx, D, k, scale, device):
        vri = jnp.asarray(np.stack([D.real, D.imag], axis=1))
        res = np.asarray(JG._encode_batch(jctx, vri, k, scale))
        return torch.from_numpy(res.astype(np.int64)).to(device)
    return encode


@pytest.fixture(scope="module")
def crypto():
    return qp_crypto()


def _jct(jctx, jkeys, v, k, seed):
    z = np.zeros(16)
    z[:v.shape[0]] = v
    jpt = jencode(jctx, z, np.zeros(16), k)
    return jax.jit(lambda p: JS.encrypt(jctx, jkeys, p,
                                        jax.random.PRNGKey(seed)))(jpt)


# ---- host helpers -----------------------------------------------------------


@pytest.mark.parametrize("domain,degree,cap", [
    (2.0, 7, True), (2.0, 7, False), (1.5, 7, False), (2.0, 3, False),
    (3.25, 5, True), (7.0, 7, True)])
def test_clip_poly_coeffs_equal(domain, degree, cap):
    assert TQ.clip_poly_coeffs(domain, degree, cap) == \
        JQ.clip_poly_coeffs(domain, degree, cap)


def test_host_helpers_equal():
    H, lb, ub, du_unc = _problem()
    mid, hw = (lb + ub) / 2, (ub - lb) / 2
    doms = np.array([0.3, 1.5, 1.51, 2.0, 2.26, 3.0, 4.9, 7.0])
    assert np.array_equal(TQ._quantize_domain(doms),
                          JQ._quantize_domain(doms))
    for degree in (3, 7):
        cs = TQ.clip_coeffs_per_slot(doms, degree)
        assert np.array_equal(cs, JQ.clip_coeffs_per_slot(doms, degree))
        y = mid + hw * np.linspace(-2, 2, 8)
        assert np.array_equal(TQ.poly_clip_np(y, mid, hw, cs),
                              JQ.poly_clip_np(y, mid, hw, cs))
        assert np.array_equal(TQ.poly_clip_np(y, mid, hw, cs[0]),
                              JQ.poly_clip_np(y, mid, hw, cs[0]))
    for B0 in (3.0, np.linspace(1, 4, 8)):
        eta = TQ.pgd_eta(H, lb, ub, B0)
        assert eta == JQ.pgd_eta(H, lb, ub, B0)
        assert TQ.eta_for_domain(H, lb, ub, B0, 2.5) == \
            JQ.eta_for_domain(H, lb, ub, B0, 2.5)
        for a, b in zip(TQ.pgd_domains(H, lb, ub, eta, B0),
                        JQ.pgd_domains(H, lb, ub, eta, B0)):
            assert np.array_equal(a, b)
        for kw in (dict(degree=7), dict(degree=3),
                   dict(poly_clip=False, degree=7)):
            assert np.array_equal(
                TQ.pgd_reference(H, du_unc, lb, ub, 2, eta, input_bound=B0,
                                 **kw),
                JQ.pgd_reference(H, du_unc, lb, ub, 2, eta, input_bound=B0,
                                 **kw))
    for degree in (3, 7):
        assert TQ.clip_pairs(degree) == JQ.clip_pairs(degree)
        for iters in range(4):
            for kind in ("du", "w_scaled"):
                assert TQ.pgd_limbs_required(degree, iters, kind) == \
                    JQ.pgd_limbs_required(degree, iters, kind)


def test_depth_ledger_fits_presets():
    """tests/test_flagship_qp.py::test_depth_ledger_fits_presets on the
    port's presets."""
    assert TQ.pgd_limbs_required(7, 1, "w_scaled") == 18 == 20 - 2
    assert TQ.pgd_limbs_required(7, 2, "w_scaled") == 28 == 30 - 2
    assert tcfg.FLAGSHIP.mult_depth * 2 + 2 == 22
    assert tcfg.FLAGSHIP_QP.mult_depth * 2 + 2 == 32
    assert 20 - TQ.pgd_limbs_required(7, 2, "w_scaled") < 2


# ---- encrypted pieces -------------------------------------------------------


def units_apart(ctx, a: torch.Tensor, b: np.ndarray) -> int:
    """max |a - b| over the integer coefficients of two NTT-domain
    plaintexts [k, N] (the difference, brought back to coefficients, must
    be one small integer on every limb)."""
    t = ctx.tables(a.shape[-2], CPU)
    d = ntt_mod.intt(sub_mod(a, interop.residues(b, CPU), t.p), t)
    d = torch.where(d > t.p // 2, d - t.p, d)
    assert torch.equal(d, d[:1].expand_as(d)), "not one integer per limb"
    return int(d.abs().max())


@pytest.mark.parametrize("degree", [3, 7])
def test_clip_build_plaintexts_equal(crypto, monkeypatch, degree):
    """Every clip constant at the JAX package's level and exact Fraction
    scale, with the JAX package's residues or, where the two float64
    embeddings round an ulp apart, integer coefficients one unit apart
    (it happens here at degree 7, whose constants carry the largest
    scales)."""
    ctx, jctx = crypto[:2]
    calls = []
    jconst = JQ._const_pt

    def record(jc, v, k, scale):
        calls.append((k, scale))
        return jconst(jc, v, k, scale)

    monkeypatch.setattr(JQ, "_const_pt", record)
    k, domain = 16, np.linspace(2.0, 3.0, 8)
    jpts, _ = JQ._clip_build(jctx, LB, UB, k, domain, degree, True)
    pts, _ = TQ._clip_build(ctx, LB, UB, k, domain, degree, True, CPU)
    assert list(pts) == list(jpts)
    for (name, pt), (jk, jscale) in zip(pts.items(), calls):
        assert isinstance(pt.scale, Fraction) and pt.scale == jscale, name
        assert pt.limbs == jk
        assert units_apart(ctx, pt.data, np.asarray(jpts[name])) <= 1, name
        if degree == 3:     # here the two embeddings round alike
            assert np.array_equal(u32(pt.data), np.asarray(jpts[name])), name


def test_encrypted_clip_bit_equal(crypto):
    """Degree 3 on one ciphertext: three ct x ct products through the
    compact relinearisation key, bit for bit, and the decoded result is
    the clip polynomial of the input."""
    ctx, jctx, keys, jkeys, relin, jrelin = crypto[:6]
    k = 16
    w = np.linspace(-1.9, 1.9, 8)
    jct = _jct(jctx, jkeys, w, k, 5)
    jclip = JQ.make_encrypted_clip(jctx, jrelin, LB, UB, k, domain=2.0,
                                   degree=3)
    want = jax.jit(lambda d: jclip(JS.Ciphertext(data=d, scale=jct.scale))
                   .data)(jct.data)
    clip = TQ.make_encrypted_clip(ctx, relin, LB, UB, k, domain=2.0,
                                  degree=3)
    got = clip(interop.ciphertext(jct.data, jct.scale, CPU))
    assert got.scale == ctx.delta and got.limbs == k - 6
    assert np.array_equal(u32(got.data), np.asarray(want))
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    doms = np.full(16, 1.5)
    doms[:8] = 2.0
    z = np.zeros(16)
    z[:8] = w
    want_re = TQ.poly_clip_np(z, 0.0, 1.0, TQ.clip_coeffs_per_slot(doms, 3))
    assert np.max(np.abs(re.numpy() - want_re)) < 1e-6
    assert np.max(np.abs(im.numpy())) < 1e-5
    with pytest.raises(ValueError, match="clip built for"):
        clip(TS.mod_down_pair(ctx, got))


def test_encrypted_pgd_bit_equal(crypto, monkeypatch):
    """make_encrypted_pgd ("du" input: normalization, centering, clip0,
    one gradient gemv and clip) gives the JAX solver's ciphertext bit
    for bit on the same input, and the plaintext reference to 1e-4."""
    ctx, jctx, keys, jkeys, relin, jrelin, rk, jrk = crypto
    monkeypatch.setattr(TG, "_encode_diags", reference_diag_encoding(jctx))
    H, lb, ub, du_unc = _problem()
    mid, hw = (lb + ub) / 2, (ub - lb) / 2
    B0 = float(np.ceil(np.max(np.abs(du_unc - mid) / hw)))
    k_in = 18
    jsolve, jeta = JQ.make_encrypted_pgd(jctx, jrelin, jrk, H, lb, ub,
                                         k_in=k_in, iters=1, degree=3,
                                         input_bound=B0)
    solve, eta = TQ.make_encrypted_pgd(ctx, relin, rk, H, lb, ub, k_in=k_in,
                                       iters=1, degree=3, input_bound=B0)
    assert eta == jeta
    jct = _jct(jctx, jkeys, du_unc, k_in, 6)
    want = jsolve(jct)
    got = solve(interop.ciphertext(jct.data, jct.scale, CPU))
    need = TQ.pgd_limbs_required(3, 1, "du")
    assert got.scale == want.scale == ctx.delta
    assert got.limbs == k_in - need
    assert np.array_equal(u32(got.data), np.asarray(want.data))
    re, im = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    ref = TQ.pgd_reference(H, du_unc, lb, ub, 1, eta, degree=3,
                           input_bound=B0)
    assert np.max(np.abs(re.numpy()[:8] - ref)) < 1e-4
    assert np.max(np.abs(im.numpy())) < 1e-5
    with pytest.raises(ValueError, match="depth"):
        TQ.make_encrypted_pgd(ctx, relin, rk, H, lb, ub, k_in=k_in - 2,
                              iters=1, degree=3, input_bound=B0)


# ---- the plaintext mirror regulator ----------------------------------------


@pytest.mark.parametrize("iters,steps,B0", [(1, 6, 4.0), (2, 10, 7.0)],
                         ids=["flagship-6", "flagship-qp-10"])
def test_mirror_loop_matches_jax(iters, steps, B0):
    """tests/test_flagship_qp.py::test_mirror_loop_binds_and_certifies
    (one iteration, 6 steps) and scripts/run_flagship_qp_tpu.py's mirror
    (two iterations, 10 steps, envelope 7): the port's mirror equals the
    JAX package's to 1e-12, binds, and certifies."""
    model, plant, _, dt, _, jmodel, jplant = port_setup()
    p_seq = np.zeros((steps, 1))
    p_seq[2:, 0] = 0.1 * plant.ps[0]
    jmirror = JQ.make_pgd_mirror_regulator(jmodel, jplant, 4, JBounds(*BOX),
                                           iters=iters, degree=7,
                                           input_bound=B0)
    jx, ju, jcert = jsimulate(jmodel, jplant, p_seq, dt, steps,
                              regulator=jmirror, horizon=4,
                              regulator_state=jnp.zeros((), jnp.float64),
                              return_state=True)
    mirror = TQ.make_pgd_mirror_regulator(model, plant, 4, MPCBounds(*BOX),
                                          CPU, iters=iters, degree=7,
                                          input_bound=B0)
    x, u, cert = simulate(model, plant, p_seq, dt, steps, CPU,
                          regulator=mirror, horizon=4,
                          regulator_state=torch.zeros((), dtype=torch.float64),
                          return_state=True)
    assert np.all(np.max(np.abs(x - np.asarray(jx)), axis=0) <= 1e-12)
    assert np.all(np.max(np.abs(u - np.asarray(ju)), axis=0) <= 1e-12)
    assert abs(float(cert) - float(jcert)) <= 1e-12
    assert float(cert) <= B0
    du = np.diff(u, axis=0)
    assert np.all(du <= BOX[1] + 1e-9) and np.all(du >= BOX[0] - 1e-9)
    assert np.max(np.abs(du[:, 0])) > 0.8 * BOX[1][0]
