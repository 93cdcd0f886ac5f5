"""The encrypted box-constrained QP over a batch of loops: the solver,
the constrained regulator, its plaintext mirror and the constrained
closed loop on inputs [B, ...], held row by row against the port's 1-D
calls and against ``jax.vmap`` of the JAX package's.

At SMALL_QP (logN=8, 18 data limbs, tests/test_torch_qp_enc.py) with
its JAX keys carried over, degree 3 and one iteration.  B = 3 equals
nx, so a gain applied with ``@`` to a [B, nx] batch would give a
product of the right shape and the wrong value; every product here goes
through ``utils.rows.matvec``.  Ciphertexts are compared bit for bit
(as uint32), with both packages given the JAX package's gemv-diagonal
and constant plaintexts (their float64 embeddings may round an ulp
apart); decoded controls to 1e-12, the mirror to 1e-12 (XLA contracts
its products into FMAs), the encrypted loop to 1e-4 of the mirror.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RowDraws
from hectr_tpu.control.mpc import MPCBounds as JBounds
from hectr_tpu.hempc import hempc_init_state as jinit
from hectr_tpu.hempc import make_hempc_regulator as jregulator
from hectr_tpu.hempc import qp_enc as JQ
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.control.mpc import MPCBounds
from hectr_tpu_torch.control.simulate import simulate, simulate_batch
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from hectr_tpu_torch.hempc import qp_enc as TQ
from tests.test_qp_enc import _problem
from tests.test_torch_batch import RowReplay
from tests.test_torch_control import port_setup
from tests.test_torch_hempc_qp import UHAT, UR, XHAT, XR
from tests.test_torch_qp_enc import (BOX, LB, UB, qp_crypto,
                                     reference_diag_encoding)
from tests.test_torch_scheme import CPU, regulator_enc_keys, u32

torch.set_num_threads(1)

B = 3                            # = nx: catches a gain applied with `@`
ROW_SCALES = (1.0, 0.5, -0.75)   # each row's deviation, inside the envelope
# the regulator against jax.vmap: the clip alone, no gradient step (the
# JAX compile of the vmapped regulator takes 70 s with one, 40 s without)
QP = dict(qp_iters=0, qp_degree=3, qp_input_bound=4.0)


@pytest.fixture(scope="module")
def crypto():
    return qp_crypto()


@pytest.fixture
def jax_plaintexts(crypto, monkeypatch):
    """Both packages encode with the JAX package's float64 embedding."""
    jctx = crypto[1]
    monkeypatch.setattr(TG, "_encode_diags", reference_diag_encoding(jctx))
    monkeypatch.setattr(TQ, "_const_pt", lambda c, v, k, scale, device:
                        interop.plaintext(JQ._const_pt(jctx, v, k, scale).data,
                                          scale, device))


def _cts(ctx, keys, rows, k, seed):
    """Ciphertexts [B, 2, k, N] of the rows zero-extended to the slots."""
    z = torch.zeros(rows.shape[0], ctx.slots, dtype=torch.float64)
    z[:, :rows.shape[1]] = _t(rows)
    return TS.encrypt(ctx, keys, TS.encode(ctx, (z, torch.zeros_like(z)), k),
                      TS.TorchSampler(seed, CPU))


def _row(ct, i):
    return TS.Ciphertext(ct.data[i], ct.scale)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("degree", [3, 7])
def test_batched_clip_rows_bit_equal(crypto, degree):
    """The encrypted clip's constants are unbatched plaintexts that
    broadcast against [B, 2, k, N]: each row of a batched clip equals
    the clip of that row alone, bit for bit."""
    ctx, _, keys, _, relin = crypto[:5]
    k = 16
    w = np.linspace(-1.9, 1.9, 8)[None] * np.array(ROW_SCALES)[:, None]
    ct = _cts(ctx, keys, w, k, 40)
    clip = TQ.make_encrypted_clip(ctx, relin, LB, UB, k, domain=2.0,
                                  degree=degree)
    got = clip(ct)
    assert got.data.shape == (B, 2, k - 2 * TQ.clip_pairs(degree), ctx.n)
    for i in range(B):
        assert torch.equal(got.data[i], clip(_row(ct, i)).data)


@pytest.mark.parametrize("iters", [0, 1])
def test_batched_solve_rows_bit_equal(crypto, iters):
    """make_encrypted_pgd on [B, 2, k, N] ("du" input: normalization,
    centering, the clip and `iters` gradient steps): every row bit-equal
    to the 1-D solve and within 1e-4 of the float64 reference.  The
    batched solve against jax.vmap of the JAX package's is held inside
    the regulator below, where it runs."""
    ctx, _, keys, _, relin, _, rk, _ = crypto
    H, lb, ub, du_unc = _problem()
    mid, hw = (lb + ub) / 2, (ub - lb) / 2
    rows = mid + (du_unc - mid) * np.array(ROW_SCALES)[:, None]
    B0 = float(np.ceil(np.max(np.abs(rows - mid) / hw)))
    k_in = 18
    solve, eta = TQ.make_encrypted_pgd(ctx, relin, rk, H, lb, ub, k_in=k_in,
                                       iters=iters, degree=3, input_bound=B0)
    ct = _cts(ctx, keys, rows, k_in, 41)
    got = solve(ct)
    assert got.data.shape == (
        B, 2, k_in - TQ.pgd_limbs_required(3, iters, "du"), ctx.n)
    for i in range(B):
        assert torch.equal(got.data[i], solve(_row(ct, i)).data)
    re, _ = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    for i in range(B):
        ref = TQ.pgd_reference(H, rows[i], lb, ub, iters, eta, degree=3,
                               input_bound=B0)
        assert np.max(np.abs(re[i, :8].numpy() - ref)) < 1e-4


def _loop_inputs():
    """[B, n] regulator inputs: row b's deviations from the target are
    ROW_SCALES[b] times tests/test_torch_hempc_qp.py's."""
    s = np.array(ROW_SCALES)[:, None]
    return (XR + (XHAT - XR) * s, UR + (UHAT - UR) * s,
            np.tile(XR, (B, 1)), np.tile(UR, (B, 1)))


def _spied_pgd(make, record):
    """make_encrypted_pgd whose solve records its input and output
    ciphertexts (JAX: a debug callback, run per row under vmap)."""
    def build(*args, **kwargs):
        solve, eta = make(*args, **kwargs)

        def spied(du):
            record("in", du.data)
            z = solve(du)
            record("out", z.data)
            return z
        return spied, eta
    return build


def test_batched_regulator_two_steps(crypto, jax_plaintexts, monkeypatch):
    """The constrained regulator over B loops for two steps, u fed back,
    against jax.jit(jax.vmap) of the JAX regulator with the same keys and
    draws (ks = split(PRNGKey(7), B)): the QP's input and output
    ciphertexts (the batched solve against the JAX package's, vmapped)
    bit-equal, u within 1e-12, one canary per loop; and each row's
    solver and decrypted ciphertexts and u bit-equal to the 1-D
    regulator given that row's draws (rows 0 and B-1)."""
    from hectr_tpu_torch.hempc import regulator as TR

    ctx, jctx, keys, jkeys, relin, jrelin, rk, jrk = crypto
    model, plant, _, _, _, jmodel, jplant = port_setup()
    xhat, uhat, xr, ur = _loop_inputs()
    ks = jax.random.split(jax.random.PRNGKey(7), B)

    jseen = {"in": [], "out": []}
    monkeypatch.setattr(JQ, "make_encrypted_pgd", _spied_pgd(
        JQ.make_encrypted_pgd, lambda kind, d: jax.debug.callback(
            lambda v: jseen[kind].append(np.asarray(v)), d)))
    # vmap of the jitted regulator: traced once unbatched, then batched as
    # a jaxpr, which compiles ~6 s sooner than tracing it under vmap
    jreg = jax.jit(jax.vmap(jax.jit(jregulator(
        jctx, jkeys, jrk, jmodel, jplant, 4, bounds=JBounds(*BOX),
        relin_key=jrelin, **QP))))
    ju1, jstate = jreg(jax.vmap(jinit)(ks), xhat, uhat, xr, ur)
    jax.effects_barrier()
    ju2, (_, jcanary) = jreg(jstate, xhat, ju1, xr, ur)
    jax.effects_barrier()
    assert len(jseen["in"]) == len(jseen["out"]) == 2 * B

    seen = []
    monkeypatch.setattr(TR, "make_encrypted_pgd", _spied_pgd(
        TQ.make_encrypted_pgd, lambda kind, d: seen.append(d.clone())))
    decrypt = TS.decrypt
    monkeypatch.setattr(TS, "decrypt", lambda c, k, ct: (
        seen.append(ct.data.clone()), decrypt(c, k, ct))[1])
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4,
                               bounds=MPCBounds(*BOX), relin_key=relin, **QP)

    def two_steps(rows, streams):
        state = hempc_init_state(RowReplay(streams, ctx.n), CPU,
                                 (len(streams),) if rows is None else ())
        sl = slice(None) if rows is None else rows
        u1, state = reg(state, _t(xhat[sl]), _t(uhat[sl]), _t(xr[sl]),
                        _t(ur[sl]))
        u2, (_, canary) = reg(state, _t(xhat[sl]), u1, _t(xr[sl]), _t(ur[sl]))
        return u1, u2, canary

    u1, u2, canary = two_steps(None, [regulator_enc_keys(k) for k in ks])
    assert u1.shape == u2.shape == (B, 2) and canary.shape == (B,)
    batched = seen[:]                 # per step: QP in, QP out, decrypted
    assert len(batched) == 6
    for step in range(2):
        for j, kind in enumerate(("in", "out")):
            got = u32(batched[3 * step + j])
            # the callbacks of one step come in no fixed row order
            want = jseen[kind][B * step:B * (step + 1)]
            assert sorted(g.tobytes() for g in got) == \
                sorted(w.tobytes() for w in want)
    for u, ju in ((u1, ju1), (u2, ju2)):
        assert np.max(np.abs(u.numpy() - np.asarray(ju))) <= 1e-12
    assert np.max(np.abs(canary.numpy() - np.asarray(jcanary))) <= 1e-12
    for i in (0, B - 1):
        seen.clear()
        r1, r2, c1 = two_steps(i, [regulator_enc_keys(ks[i])])
        assert torch.equal(u1[i], r1) and torch.equal(u2[i], r2)
        assert float(canary[i]) == float(c1)
        assert all(torch.equal(b[i], d) for b, d in zip(batched, seen))
    du = np.stack([u1.numpy() - uhat, u2.numpy() - u1.numpy()])
    assert np.all(du <= BOX[1] + 1e-6) and np.all(du >= BOX[0] - 1e-6)
    assert bool((canary < 1e-5).all())


def test_batched_mirror(crypto):
    """The plaintext mirror on [B, n]: rows bit-equal to the 1-D mirror,
    one certificate per loop, and within 1e-12 of jax.vmap of the JAX
    mirror over two steps with u fed back."""
    model, plant, _, _, _, jmodel, jplant = port_setup()
    xhat, uhat, xr, ur = _loop_inputs()
    mirror = TQ.make_pgd_mirror_regulator(model, plant, 4, MPCBounds(*BOX),
                                          CPU, iters=2, degree=7,
                                          input_bound=4.0)
    jmirror = jax.jit(jax.vmap(JQ.make_pgd_mirror_regulator(
        jmodel, jplant, 4, JBounds(*BOX), iters=2, degree=7,
        input_bound=4.0)))
    state = torch.zeros(B, dtype=torch.float64)
    jstate = jnp.zeros(B, jnp.float64)
    u = _t(uhat)
    ju = jnp.asarray(uhat)
    for _ in range(2):
        rows = [mirror(torch.zeros((), dtype=torch.float64), _t(xhat[i]), u[i],
                       _t(xr[i]), _t(ur[i])) for i in range(B)]
        u_new, state_new = mirror(state, _t(xhat), u, _t(xr), _t(ur))
        assert u_new.shape == (B, 2) and state_new.shape == (B,)
        for i, (u1, c1) in enumerate(rows):
            assert torch.equal(u_new[i], u1)
            assert torch.equal(state_new[i], torch.maximum(state[i], c1))
        ju, jstate = jmirror(jstate, xhat, ju, xr, ur)
        u, state = u_new, state_new
        assert np.max(np.abs(u.numpy() - np.asarray(ju))) <= 1e-12
        assert np.max(np.abs(state.numpy() - np.asarray(jstate))) <= 1e-12
    # the loops' certificates differ: each is its own loop's
    assert len(set(state.tolist())) == B and float(state.max()) <= 4.0
    # a 1-D call is the unbatched mirror's, state a 0-d tensor
    u1, c1 = mirror(torch.zeros((), dtype=torch.float64), _t(xhat[0]),
                    _t(uhat[0]), _t(xr[0]), _t(ur[0]))
    assert u1.shape == (2,) and c1.shape == ()


def test_simulate_batch_constrained(crypto):
    """simulate_batch with the constrained regulator over B loops, loop b
    under (1, 0.75, 0.5)[b] x the +10% inlet step: each loop within 1e-4
    of the batched mirror, the du box honoured (to 1e-4), and loops 0
    and B-1 bit-equal to simulate alone with the same draws."""
    ctx, _, keys, _, relin, _, rk, _ = crypto
    model, plant, _, dt, _, _, _ = port_setup()
    steps = 3
    p = np.zeros((B, steps, 1))
    for b, s in enumerate((1.0, 0.75, 0.5)):
        p[b, 2:, 0] = 0.1 * plant.ps[0] * s
    bounds = MPCBounds(*BOX)
    B0 = 4.0
    for _ in range(3):
        mirror = TQ.make_pgd_mirror_regulator(model, plant, 4, bounds, CPU,
                                              iters=1, degree=3,
                                              input_bound=B0)
        x_m, u_m, cert = simulate_batch(
            model, plant, p, dt, steps, CPU, regulator=mirror, horizon=4,
            regulator_state=torch.zeros(B, dtype=torch.float64))
        if float(cert.max()) <= B0:
            break
        B0 = float(np.ceil(float(cert.max())) + 1.0)
    assert cert.shape == (B,) and float(cert.max()) <= B0
    reg = make_hempc_regulator(ctx, keys, rk, model, plant, 4, bounds=bounds,
                               relin_key=relin, qp_iters=1, qp_degree=3,
                               qp_input_bound=B0)
    seeds = [300 + b for b in range(B)]
    x, u, (_, canary) = simulate_batch(
        model, plant, p, dt, steps, CPU, regulator=reg, horizon=4,
        regulator_state=hempc_init_state(RowDraws(seeds, CPU), CPU, (B,)))
    assert x.shape == (B, steps + 1, 3) and u.shape == (B, steps, 2)
    assert np.max(np.abs(x - x_m)) < 1e-4 and np.max(np.abs(u - u_m)) < 1e-4
    du = np.diff(u, axis=1)
    assert np.all(du <= BOX[1] + 1e-4) and np.all(du >= BOX[0] - 1e-4)
    assert bool((canary < 1e-5).all())
    for b in (0, B - 1):
        x1, u1, (_, c1) = simulate(
            model, plant, p[b], dt, steps, CPU, regulator=reg, horizon=4,
            regulator_state=hempc_init_state(RowDraws([seeds[b]], CPU), CPU),
            return_state=True)
        assert np.array_equal(x[b], x1) and np.array_equal(u[b], u1)
        assert float(canary[b]) == float(c1)
