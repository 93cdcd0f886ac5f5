"""The port's security accounting and its he_* facade, held against the
JAX package (hectr_tpu/ckks/security.py, hectr_tpu/he.py) and against
the reference's call sequence (tests/test_he_facade.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import facade_problem
from hectr_tpu import config as jcfg
from hectr_tpu import he as jhe
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks import security as jsec
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch import he
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import security as tsec
from tests.test_torch_scheme import CPU, JaxReplay, jencode, u32

torch.set_num_threads(1)


# ---- security accounting ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(tcfg.PRESETS))
def test_security_report_matches_jax(name):
    rep = tsec.security_report(tcfg.PRESETS[name])
    want = jsec.security_report(jcfg.PRESETS[name])
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    assert str(rep) == str(want)
    assert tsec.modulus_bits(tcfg.PRESETS[name]) == \
        jsec.modulus_bits(jcfg.PRESETS[name])


@pytest.mark.parametrize("name", sorted(tcfg.PRESETS))
@pytest.mark.parametrize("bits", [128, 192, 256, 100])
def test_assert_security_raises_as_jax(name, bits):
    def outcome(fn, preset):
        try:
            return "ok", dataclasses.asdict(fn(preset, bits))
        except ValueError as e:
            return "raised", str(e)

    got = outcome(tsec.assert_security, tcfg.PRESETS[name])
    want = outcome(jsec.assert_security, jcfg.PRESETS[name])
    assert got == want
    if bits == 100:
        assert got[0] == "raised"


def test_security_table_and_interpolation_match_jax():
    assert tsec.HE_STANDARD_MAX_LOGQP == jsec.HE_STANDARD_MAX_LOGQP
    for logn in sorted(tsec.HE_STANDARD_MAX_LOGQP[128]):
        for log_qp in range(0, 1200, 7):
            assert tsec._interp_security(logn, log_qp) == \
                jsec._interp_security(logn, log_qp)


def test_unknown_degree_rejected():
    p = tcfg.CKKSPreset(name="tiny", logn=9, slots=4, scale_bits=30,
                        limb_bits=25, mult_depth=1)
    with pytest.raises(ValueError, match="no HE-standard row"):
        tsec.security_report(p)
    with pytest.raises(ValueError, match="no HE-standard row"):
        tsec.assert_security(p)


def test_reference_parity_preset_is_flagged():
    rep = tsec.security_report(tcfg.REFERENCE_HEMPC)
    assert not rep.meets_128 and 80.0 <= rep.est_bits < 128.0
    for preset in (tcfg.MEDIUM, tcfg.FLAGSHIP, tcfg.FLAGSHIP_QP,
                   tcfg.REFERENCE_HEMPC_SECURE):
        assert tsec.assert_security(preset, 128).meets_128


# ---- the he_* facade -------------------------------------------------------


def test_reference_call_sequence():
    """hectx_init -> he_keypair -> he_genrk -> he_ecd/he_enc_pk x4 ->
    he_sub, he_gemv x2, he_add, he_neg, he_moddown, he_copy_ct ->
    he_dec/he_dcd, at logn=10: u = uhat - (K_A (xhat-xr) + K_B (uhat-ur))
    to 1e-8, canary < 1e-5."""
    xhat, xr, uhat, ur, K_A, K_B = facade_problem()
    hc = he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, device=CPU)
    he.he_keypair(hc)
    he.he_genrk(hc)
    assert sorted(hc.rot_keys) == list(range(1, 16))
    ct_xhat, ct_uhat, ct_xr, ct_ur = (he.he_enc_pk(hc, he.he_ecd(hc, v))
                                      for v in (xhat, uhat, xr, ur))
    xdiff = he.he_sub(hc, ct_xhat, ct_xr)
    udiff = he.he_sub(hc, ct_uhat, ct_ur)
    gA = he.he_gemv(hc, K_A, xdiff)
    gB = he.he_gemv(hc, K_B, udiff)
    assert len(hc._gemv_cache) == 2
    he.he_gemv(hc, K_A, xdiff)                     # cached: no new build
    assert len(hc._gemv_cache) == 2
    du = he.he_neg(hc, he.he_add(hc, gA, gB))
    u = he.he_add(hc, he.he_moddown(hc, he.he_copy_ct(hc, ct_uhat)), du)
    got = he.he_dcd(hc, he.he_dec(hc, u))
    assert got.dtype == torch.complex128
    got = got.numpy()
    want = uhat - (K_A @ (xhat - xr) + K_B @ (uhat - ur))
    assert np.max(np.abs(got.real - want.real)) <= 1e-8
    assert np.max(np.abs(got.imag)) < 1e-5
    he.hectx_exit(hc)
    assert hc.keys is None and hc.rot_keys is None and not hc._gemv_cache


def test_facade_draws_replayed_bit_equal_jax():
    """With the JAX facade's key splits replayed through the sampler
    hook, he_keypair and he_enc_pk give the JAX facade's residues."""
    key = jax.random.PRNGKey(0)
    key, k_pair = jax.random.split(key)
    key, k_enc = jax.random.split(key)
    jhc = jhe.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, seed=0)
    jhe.he_keypair(jhc)
    hc = he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, device=CPU,
                       sampler=JaxReplay(k_pair, enc_keys=[k_enc]))
    he.he_keypair(hc)
    assert np.array_equal(u32(hc.keys.sk), np.asarray(jhc.keys.sk))
    assert np.array_equal(u32(hc.keys.pk), np.asarray(jhc.keys.pk))
    v = np.linspace(-1, 1, 16)
    jpt = jencode(jhc.ctx, v, np.zeros(16), jhc.ctx.max_limbs)
    jct = jhe.he_enc_pk(jhc, jpt)
    ct = he.he_enc_pk(hc, interop.plaintext(jpt.data, jpt.scale, CPU))
    assert np.array_equal(u32(ct.data), np.asarray(jct.data))
    assert np.array_equal(u32(he.he_dec(hc, ct).data),
                          np.asarray(JS.decrypt(jhc.ctx, jhc.keys, jct).data))


def test_hectx_init_fields_match_jax():
    for logn, logq, delta in ((10, 109, 50), (12, 218, 50), (13, 160, 50)):
        got = he.hectx_init(logn=logn, logq=logq, slots=16, delta_bits=delta,
                            device=CPU)
        want = jhe.hectx_init(logn=logn, logq=logq, slots=16, delta_bits=delta)
        for f in ("requested_logq", "realized_logq", "realized_logqp", "depth",
                  "security_bits"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.ctx.full_primes == want.ctx.full_primes


def test_hectx_init_reports_realized_modulus(capsys, monkeypatch):
    monkeypatch.delenv("HECTR_VERBOSE", raising=False)
    hc = he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50,
                       verbose=True, device=CPU)
    assert hc.requested_logq == 109 and hc.depth == 1
    assert 100 <= hc.realized_logq <= 150
    assert hc.realized_logqp > hc.realized_logq and hc.security_bits > 0
    err = capsys.readouterr().err
    assert "realized logQ=" in err and "security" in err
    jhe.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, verbose=True)
    assert capsys.readouterr().err == err      # the JAX facade's line
    he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, device=CPU)
    assert "realized" not in capsys.readouterr().err
    monkeypatch.setenv("HECTR_VERBOSE", "1")
    he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, device=CPU)
    assert "realized logQ=" in capsys.readouterr().err


def test_facade_refuses_out_of_order_calls():
    hc = he.hectx_init(logn=10, logq=109, slots=16, delta_bits=50, device=CPU)
    with pytest.raises(ValueError, match="he_keypair"):
        he.he_genrk(hc)
    he.he_keypair(hc)
    ct = he.he_enc_pk(hc, he.he_ecd(hc, np.ones(16)))
    with pytest.raises(ValueError, match="he_genrk"):
        he.he_gemv(hc, np.eye(16), ct)
