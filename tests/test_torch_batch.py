"""The batch axis of the port: batched scheme, key-switch and gemv ops,
both batched regulators, the batched plant and closed loop, held row by
row against the port's 1-D calls and against ``jax.vmap`` of the JAX
package's.

At logN=10, 16 slots, B = 3 loops (the slice preset of
tests/test_torch_hempc.py).  Integer results are compared bit for bit
(as uint32); randomness is the reference's own, replayed per row.  Rows
of a batch equal the 1-D op bit for bit: every op is elementwise per
row, the embedding's batched products sum in the 1-D order
(``utils.rows.matvec``), and the plant's batched solve solves each row
as the 1-D solve does.  Decoded values are held to the JAX package's
vmapped decode at 1e-12, closed loops to their bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RowDraws
from hectr_tpu.ckks import encoding as jenc
from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.hempc import fused as JF
from hectr_tpu.hempc import hempc_init_state as jinit
from hectr_tpu.hempc import make_hempc_regulator as jregulator
from hectr_tpu_torch import interop
from hectr_tpu_torch.ckks import encoding as tenc
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import ntt as TN
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.primes import find_ntt_primes
from hectr_tpu_torch.control import ode as tode
from hectr_tpu_torch.control import stages as tst
from hectr_tpu_torch.control.plants import cstr as tcstr
from hectr_tpu_torch.control.simulate import simulate, simulate_batch
from hectr_tpu_torch.hempc import fused as TF
from hectr_tpu_torch.hempc import hempc_init_state, make_hempc_regulator
from tests.test_torch_control import port_setup
from tests.test_torch_fused import fused_enc_keys
from tests.test_torch_hempc import SLICE
from tests.test_torch_qp_enc import reference_diag_encoding
from tests.test_torch_scheme import (
    CPU,
    JaxReplay,
    contexts,
    regulator_enc_keys,
    u32,
)

torch.set_num_threads(1)

B = 3
STEPS = 8        # bench.py:593-600's inner scan, u fed back


def _enc_draws(n):
    """jit(vmap) of one encryption's draws from its key, as
    hectr_tpu/ckks/scheme.py encrypt splits it: (v, e0, e1)."""
    def one(key):
        k_v, k_e0, k_e1 = jax.random.split(key, 3)
        return (JS._sample_ternary(k_v, n), JS._sample_gauss(k_e0, n),
                JS._sample_gauss(k_e1, n))
    return jax.jit(jax.vmap(one))


class RowReplay:
    """A batched sampler: row b of every encryption replays the JAX
    package's draws from its own key stream (as jax.vmap gives loop b
    its own key), all rows in one jitted draw."""

    def __init__(self, streams, n):
        self.streams = list(streams)
        self.draw = _enc_draws(n)

    def encryption(self, ctx, k, batch, device):
        assert int(np.prod(batch, dtype=np.int64)) == len(self.streams)
        keys = jnp.stack([next(s) for s in self.streams])
        return tuple(torch.from_numpy(np.asarray(d).astype(np.int64))
                     .reshape(*batch, ctx.n) for d in self.draw(keys))


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def crypto():
    ctx, jctx = contexts(SLICE)
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(2024))
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(2025))
    jrelin = JK.gen_relin_key(jctx, jkeys, jax.random.PRNGKey(2026))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    rk = interop.rotation_keys({r: np.asarray(k) for r, k in jrk.items()}, CPU)
    relin = interop.residues(jrelin, CPU)
    k = ctx.max_limbs
    rng = np.random.default_rng(11)
    vals = rng.uniform(-1, 1, (B, ctx.slots))
    ws = rng.uniform(-1, 1, (B, ctx.slots))
    enc = jax.jit(jax.vmap(lambda v, key: JS.encrypt(
        jctx, jkeys, JS.encode(jctx, (v, jnp.zeros_like(v)), k), key).data))
    ja = enc(jnp.asarray(vals), jax.random.split(jax.random.PRNGKey(30), B))
    jb = enc(jnp.asarray(ws), jax.random.split(jax.random.PRNGKey(31), B))
    return dict(ctx=ctx, jctx=jctx, keys=keys, jkeys=jkeys, rk=rk, jrk=jrk,
                relin=relin, jrelin=jrelin, vals=vals, ja=ja, jb=jb,
                a=TS.Ciphertext(interop.residues(ja, CPU), ctx.delta),
                b=TS.Ciphertext(interop.residues(jb, CPU), ctx.delta))


def _row(ct, i):
    return TS.Ciphertext(ct.data[i], ct.scale)


def _gemv_matrix(slots):
    M = np.zeros((slots, slots))
    M[:4, :5] = np.random.default_rng(12).normal(size=(4, 5))
    M[:4, 8:13] = np.random.default_rng(13).normal(size=(4, 5))
    return M


def _batched_case(c, op):
    """(port batched result [B, ...], port 1-D results per row, jax.vmap
    of the JAX op) for one op of the scheme."""
    ctx, jctx, keys, jkeys = c["ctx"], c["jctx"], c["keys"], c["jkeys"]
    a, b, ja, jb = c["a"], c["b"], c["ja"], c["jb"]
    k, delta = ctx.max_limbs, ctx.delta
    jct = lambda d, s=delta: JS.Ciphertext(data=d, scale=s)  # noqa: E731
    rows = range(B)
    if op == "encrypt":
        jpt = jax.jit(jax.vmap(lambda v: JS.encode(
            jctx, (v, jnp.zeros_like(v)), k).data))(jnp.asarray(c["vals"]))
        pt = TS.Plaintext(interop.residues(jpt, CPU), delta)
        ks = list(jax.random.split(jax.random.PRNGKey(40), B))
        got = TS.encrypt(ctx, keys, pt, JaxReplay(enc_keys=ks)).data
        one = [TS.encrypt(ctx, keys, TS.Plaintext(pt.data[i], delta),
                          JaxReplay(enc_keys=[ks[i]])).data for i in rows]
        want = jax.jit(jax.vmap(lambda p, key: JS.encrypt(
            jctx, jkeys, JS.Plaintext(p, delta), key).data))(jpt, jnp.stack(ks))
    elif op == "decrypt":
        got = TS.decrypt(ctx, keys, a).data
        one = [TS.decrypt(ctx, keys, _row(a, i)).data for i in rows]
        want = jax.vmap(lambda d: JS.decrypt(jctx, jkeys, jct(d)).data)(ja)
    elif op in ("add", "sub"):
        tf, jf = getattr(TS, op), getattr(JS, op)
        got = tf(ctx, a, b).data
        one = [tf(ctx, _row(a, i), _row(b, i)).data for i in rows]
        want = jax.vmap(lambda x, y: jf(jctx, jct(x), jct(y)).data)(ja, jb)
    elif op == "neg":
        got = TS.neg(ctx, a).data
        one = [TS.neg(ctx, _row(a, i)).data for i in rows]
        want = jax.vmap(lambda x: JS.neg(jctx, jct(x)).data)(ja)
    elif op in ("mul_pt", "rescale_pair"):
        # one plaintext shared by the batch (a [k, N] operand broadcasts)
        pair = ctx.pair_scale(k)
        jpt = jax.jit(lambda v: JS.encode(jctx, (v, jnp.zeros_like(v)), k,
                                          pair))(jnp.linspace(-1, 1, 16))
        pt = TS.Plaintext(interop.residues(jpt.data, CPU), pair)

        def port(x):
            y = TS.mul_pt(ctx, x, pt)
            return (TS.rescale_pair(ctx, y) if op == "rescale_pair" else y).data

        def jop(x):
            y = JS.mul_pt(jctx, jct(x), jpt)
            return (JS.rescale_pair(jctx, y) if op == "rescale_pair" else y).data

        got = port(a)
        one = [port(_row(a, i)) for i in rows]
        want = jax.jit(jax.vmap(jop))(ja)
    elif op == "mod_down_to":
        got = TS.mod_down_to(ctx, a, 2).data
        one = [TS.mod_down_to(ctx, _row(a, i), 2).data for i in rows]
        want = jax.vmap(lambda x: JS.mod_down_to(jctx, jct(x), 2).data)(ja)
    elif op == "rotate":
        got = TK.rotate(ctx, a, 3, c["rk"]).data
        one = [TK.rotate(ctx, _row(a, i), 3, c["rk"]).data for i in rows]
        want = jax.jit(jax.vmap(lambda x: JK.rotate(
            jctx, jct(x), 3, c["jrk"]).data))(ja)
    elif op == "mul_ct":
        def port(x, y):
            return TS.rescale_pair(ctx, TK.mul_ct(ctx, x, y, c["relin"])).data

        got = port(a, b)
        one = [port(_row(a, i), _row(b, i)) for i in rows]
        want = jax.jit(jax.vmap(lambda x, y: JS.rescale_pair(jctx, JK.mul_ct(
            jctx, jct(x), jct(y), c["jrelin"])).data))(ja, jb)
    else:
        method = op.split("_")[1]
        M = _gemv_matrix(ctx.slots)
        jmat = JG.gemv_materials(jctx, M, k, c["jrk"], method=method)
        mat = TG.gemv_materials(ctx, M, k, c["rk"], CPU, method)
        assert method in mat and method in jmat
        got = TG.gemv_apply(ctx, mat, a).data
        one = [TG.gemv_apply(ctx, mat, _row(a, i)).data for i in rows]
        want = jax.jit(jax.vmap(lambda x, m: JG.gemv_apply(jctx, m, jct(x)).data,
                                in_axes=(0, None)))(ja, jmat)
    return got, one, want


@pytest.mark.parametrize("op", ["encrypt", "decrypt", "add", "sub", "neg",
                                "mul_pt", "rescale_pair", "mod_down_to",
                                "rotate", "mul_ct", "gemv_diag", "gemv_bsgs"])
def test_batched_op_rows_bit_equal(crypto, op, monkeypatch):
    """Each row of the batched op equals the port's 1-D op and jax.vmap
    of the JAX op, bit for bit (the gemvs given the JAX package's
    diagonal plaintexts: the two embeddings may round an ulp apart,
    ROADMAP.md section 3)."""
    monkeypatch.setattr(TG, "_encode_diags",
                        reference_diag_encoding(crypto["jctx"]))
    got, one, want = _batched_case(crypto, op)
    assert got.shape[0] == B
    for i in range(B):
        assert torch.equal(got[i], one[i]), (op, i)
    assert np.array_equal(u32(got), np.asarray(want)), op


def test_batched_encode_and_decode(crypto):
    """Encode and decode of a batch: every row bit-equal to the 1-D call
    (the embedding's batched products sum as the 1-D ones); the JAX
    package's vmapped decode of the same plaintexts within 1e-12, and
    the JAX package's vmapped embedding within 1e-12 before rounding."""
    c = crypto
    ctx, jctx, k = c["ctx"], c["jctx"], c["ctx"].max_limbs
    vals = c["vals"]
    pt = TS.encode(ctx, (t64(vals), t64(np.zeros_like(vals))), k)
    for i in range(B):
        one = TS.encode(ctx, (t64(vals[i]), t64(np.zeros(ctx.slots))), k)
        assert torch.equal(pt.data[i], one.data)
    dec = TS.decrypt(ctx, c["keys"], c["a"])
    re, im = TS.decode_ri(ctx, dec)
    for i in range(B):
        re1, im1 = TS.decode_ri(ctx, TS.Plaintext(dec.data[i], dec.scale))
        assert torch.equal(re[i], re1) and torch.equal(im[i], im1)
    jre, jim = jax.jit(jax.vmap(lambda d: JS.decode_ri(
        jctx, JS.Plaintext(d, dec.scale))))(jnp.asarray(u32(dec.data)))
    assert np.max(np.abs(re.numpy() - np.asarray(jre))) <= 1e-12
    assert np.max(np.abs(im.numpy() - np.asarray(jim))) <= 1e-12
    assert np.max(np.abs(re.numpy() - vals)) < 1e-6
    m = tenc.embed_ri(t64(vals), t64(vals[::-1].copy()), ctx.slots)
    jm = jax.vmap(lambda a, b: jenc.embed_ri(a, b, ctx.slots))(
        jnp.asarray(vals), jnp.asarray(vals[::-1].copy()))
    assert np.max(np.abs(m.numpy() - np.asarray(jm))) <= 1e-12


def _protocol_inputs(nx=3, nu=2):
    rng = np.random.default_rng(21)
    xs = rng.uniform(-0.01, 0.01, (B, STEPS, nx))
    u0 = rng.uniform(-0.01, 0.01, (B, nu))
    return xs, u0


def _run_port(reg, state, xs, u0):
    u = t64(u0)
    zx, zu = torch.zeros(xs.shape[-1], dtype=torch.float64), \
        torch.zeros(u0.shape[-1], dtype=torch.float64)
    us = []
    for i in range(STEPS):
        u, state = reg(state, t64(xs[..., i, :]), u, zx, zu)
        us.append(u)
    return torch.stack(us, dim=-2), state


def _jax_protocol(reg_of):
    """jax.vmap of bench.py:592-601's loop: a scan of the regulator with
    u fed back, each loop from its own key."""
    xr, ur = jnp.zeros(3), jnp.zeros(2)

    def loop(u0, xs_seq, key):
        reg = reg_of()

        def body(carry, x):
            u, st = carry
            u2, st2 = reg(st, x, u, xr, ur)
            return (u2, st2), u2
        (_, (_, canary)), us = jax.lax.scan(body, (u0, jinit(key)), xs_seq)
        return us, canary
    return jax.jit(jax.vmap(loop))


@pytest.mark.parametrize("kind", ["reference", "fused"])
def test_batched_regulator_protocol(crypto, kind):
    """The 8-step protocol of bench.py:593-600 (u fed back, xr = ur = 0)
    over B loops with ks = split(PRNGKey(7), B): each row of the batched
    regulator equals the 1-D regulator given that row's draws, bit for
    bit (rows 0 and B-1), and jax.vmap of the JAX regulator to 1e-10
    (both sides encode their own gemv diagonals); one canary per loop."""
    c = crypto
    ctx, jctx = c["ctx"], c["jctx"]
    model, plant, _, _, _, jmodel, jplant = port_setup()
    ks = jax.random.split(jax.random.PRNGKey(7), B)
    if kind == "reference":
        reg = make_hempc_regulator(ctx, c["keys"], c["rk"], model, plant, 4)
        streams = regulator_enc_keys
        jreg_of = lambda: jregulator(jctx, c["jkeys"], c["jrk"],  # noqa: E731
                                     jmodel, jplant, 4)
    else:
        mats = TF.make_fused_materials(ctx, c["rk"], model, plant, 4, CPU)
        reg = TF.make_fused_regulator(ctx, c["keys"], model, plant, 4, mats)
        streams = fused_enc_keys
        jmats = JF.make_fused_materials(jctx, c["jrk"], jmodel, jplant, 4)
        jreg_of = lambda: JF.make_fused_regulator(  # noqa: E731
            jctx, c["jkeys"], jmodel, jplant, 4, jmats)
    xs, u0 = _protocol_inputs()
    state = hempc_init_state(RowReplay([streams(k) for k in ks], ctx.n), CPU,
                             (B,))
    us, (_, canary) = _run_port(reg, state, xs, u0)
    assert us.shape == (B, STEPS, 2) and canary.shape == (B,)
    for i in (0, B - 1):
        st = hempc_init_state(RowReplay([streams(ks[i])], ctx.n), CPU)
        us1, (_, c1) = _run_port(reg, st, xs[i], u0[i])
        assert torch.equal(us[i], us1) and float(canary[i]) == float(c1)
    jus, jcanary = _jax_protocol(jreg_of)(jnp.asarray(u0), jnp.asarray(xs), ks)
    assert np.max(np.abs(us.numpy() - np.asarray(jus))) <= 1e-10
    assert np.max(np.abs(canary.numpy() - np.asarray(jcanary))) <= 1e-10
    assert bool((canary > 0).all() and (canary < 1e-5).all())


@pytest.fixture(scope="module")
def loops(crypto):
    """simulate_batch over B encrypted loops (each its own disturbance
    and its own draws), loops 0 and B-1 alone through simulate with the
    same draws, and the batched plaintext twin."""
    c = crypto
    ctx = c["ctx"]
    model, plant, _, dt, _, _, _ = port_setup()
    p = np.zeros((B, STEPS, 1))
    for i in range(B):
        p[i, 3:, 0] = 0.1 * plant.ps[0] * (1 + i / B)
    reg = make_hempc_regulator(ctx, c["keys"], c["rk"], model, plant, 4)
    seeds = [100 + i for i in range(B)]
    x, u, (_, canary) = simulate_batch(
        model, plant, p, dt, STEPS, CPU, regulator=reg,
        regulator_state=hempc_init_state(RowDraws(seeds, CPU), CPU, (B,)),
        horizon=4)
    ones = {i: simulate(model, plant, p[i], dt, STEPS, CPU, regulator=reg,
                        regulator_state=hempc_init_state(
                            RowDraws([seeds[i]], CPU), CPU),
                        horizon=4, return_state=True) for i in (0, B - 1)}
    x_pt, u_pt, _ = simulate_batch(model, plant, p, dt, STEPS, CPU, horizon=4)
    return dict(x=x, u=u, canary=canary, ones=ones, x_pt=x_pt, u_pt=u_pt, p=p,
                model=model, plant=plant, dt=dt)


def test_simulate_batch_rows_match_simulate(loops):
    r = loops
    assert r["x"].shape == (B, STEPS + 1, 3) and r["u"].shape == (B, STEPS, 2)
    for i, (x1, u1, (_, c1)) in r["ones"].items():
        assert np.max(np.abs(r["x"][i] - x1)) <= 1e-12
        assert np.max(np.abs(r["u"][i] - u1)) <= 1e-12
        assert abs(float(r["canary"][i]) - float(c1)) <= 1e-12
    for i in range(B):
        x1, u1 = simulate(r["model"], r["plant"], r["p"][i], r["dt"], STEPS,
                          CPU, horizon=4)
        assert np.array_equal(r["x_pt"][i], x1)
        assert np.array_equal(r["u_pt"][i], u1)


def test_simulate_batch_matches_plaintext_twin(loops):
    r = loops
    for i in range(B):
        assert np.all(np.max(np.abs(r["x"][i] - r["x_pt"][i]), axis=0) < 5e-10)
        assert np.all(np.max(np.abs(r["u"][i] - r["u_pt"][i]), axis=0) < 5e-10)
    assert bool((r["canary"] > 0).all() and (r["canary"] < 1e-5).all())
    # the loops differ: each ran its own disturbance
    assert np.max(np.abs(r["x"][0] - r["x"][-1])) > 1e-6


def test_simulate_batch_of_one_is_simulate(crypto):
    c = crypto
    model, plant, _, dt, _, _, _ = port_setup()
    steps = 4
    p = np.zeros((steps, 1))
    p[1:, 0] = 0.1 * plant.ps[0]
    reg = make_hempc_regulator(c["ctx"], c["keys"], c["rk"], model, plant, 4)
    x, u, (_, canary) = simulate_batch(
        model, plant, p[None], dt, steps, CPU, regulator=reg,
        regulator_state=hempc_init_state(RowDraws([5], CPU), CPU, (1,)),
        horizon=4)
    x1, u1, (_, c1) = simulate(
        model, plant, p, dt, steps, CPU, regulator=reg,
        regulator_state=hempc_init_state(RowDraws([5], CPU), CPU), horizon=4,
        return_state=True)
    assert np.array_equal(x[0], x1) and np.array_equal(u[0], u1)
    assert float(canary[0]) == float(c1)


def _plant_cases():
    rng = np.random.default_rng(31)
    xs = tcstr.CSTR_STEADY_STATE["xs"]
    x = t64(xs + rng.uniform(-0.01, 0.01, (B, 3)) * xs)
    u = t64(np.array([300.0, 0.1]) + rng.uniform(-1, 1, (B, 2)) * [5, 0.01])
    p = t64(0.1 + rng.uniform(-0.01, 0.01, (B, 1)))
    return x, u, p


@pytest.mark.parametrize("fn", ["ode", "jacobian", "rk4", "stiff", "actuate",
                                "measure", "measure_forward", "select_target",
                                "select_target_no_bd", "estimate_forward",
                                "lqr"])
def test_batched_plant_and_stages_bit_equal(fn):
    """The plant, the ODE steps and the estimator / selector / regulator
    stages on [B, n] states give each row's 1-D result bit for bit."""
    x, u, p = _plant_cases()
    rng = np.random.default_rng(32)
    M = {n: t64(rng.normal(size=s)) for n, s in
         (("C", (3, 3)), ("Cd", (3, 2)), ("Lx", (3, 3)), ("Ld", (2, 3)),
          ("Bd", (3, 2)), ("Hr", (2, 3)), ("Ginv", (5, 5)), ("A", (3, 3)),
          ("B", (3, 2)), ("G", (2, 3)))}
    d = t64(rng.normal(size=(B, 2)))
    xs, us, ps = (t64(v) for v in (tcstr.CSTR_STEADY_STATE["xs"],
                                   tcstr.CSTR_STEADY_STATE["us"],
                                   tcstr.CSTR_STEADY_STATE["ps"]))
    ode, jac = tcstr.cstr_ode, tcstr.cstr_jacobian
    f = {
        "ode": lambda x, u, p, d: ode(x, u, p),
        "jacobian": lambda x, u, p, d: jac(x, u, p),
        "rk4": lambda x, u, p, d: tode.rk4_step(ode, x, u, p, 0.5),
        "stiff": lambda x, u, p, d: tode.stiff_step(ode, jac, x, u, p, 0.5),
        "actuate": lambda x, u, p, d: tst.actuate(
            ode, jac, x - xs, u - us, p - ps, xs, us, ps, 1.0),
        "measure": lambda x, u, p, d: tst.measure(M["C"], x),
        "measure_forward": lambda x, u, p, d: torch.cat(tst.measure_forward(
            M["C"], M["Cd"], M["Lx"], M["Ld"], x * 0.5, x, d), -1),
        "select_target": lambda x, u, p, d: torch.cat(tst.select_target(
            M["Bd"], M["Cd"], M["Hr"], M["Ginv"], d, u), -1),
        "select_target_no_bd": lambda x, u, p, d: torch.cat(tst.select_target(
            None, None, None, M["Ginv"], None, u), -1),
        "estimate_forward": lambda x, u, p, d: torch.cat(tst.estimate_forward(
            M["A"], M["B"], M["Bd"], x, d, u), -1),
        "lqr": lambda x, u, p, d: tst.lqr_control(M["G"], x, x * 0.9, u),
    }[fn]
    got = f(x, u, p, d)
    assert got.shape[0] == B
    for i in range(B):
        assert torch.equal(got[i], f(x[i], u[i], p[i], d[i])), (fn, i)


def _count_transforms(monkeypatch):
    counts = {"ntt": 0, "intt": 0}
    plain = {"ntt": TN.ntt_plain, "intt": TN.intt_plain}

    def counted(name):
        def fn(a, t):
            counts[name] += 1
            return plain[name](a, t)
        return fn

    monkeypatch.setattr(TN, "ntt_plain", counted("ntt"))
    monkeypatch.setattr(TN, "intt_plain", counted("intt"))
    return counts


@pytest.mark.parametrize("kind", ["reference", "fused"])
def test_transforms_per_step_do_not_grow_with_the_batch(crypto, monkeypatch,
                                                        kind):
    """One regulator step makes as many ntt / intt calls for one loop as
    for a batch of B: a batch is one call per op, not one per loop."""
    c = crypto
    ctx = c["ctx"]
    model, plant, _, _, _, _, _ = port_setup()
    if kind == "reference":
        reg = make_hempc_regulator(ctx, c["keys"], c["rk"], model, plant, 4)
    else:
        mats = TF.make_fused_materials(ctx, c["rk"], model, plant, 4, CPU)
        reg = TF.make_fused_regulator(ctx, c["keys"], model, plant, 4, mats)
    counts = _count_transforms(monkeypatch)
    per = {}
    for lead in ((), (1,), (B,)):
        state = hempc_init_state(TS.TorchSampler(0, CPU), CPU, lead)
        xs = torch.full((*lead, 3), 0.01, dtype=torch.float64)
        us = torch.full((*lead, 2), 0.001, dtype=torch.float64)
        counts.update(ntt=0, intt=0)
        u, state = reg(state, xs, us, xs * 0, us * 0)
        assert u.shape == (*lead, 2) and state[1].shape == lead
        per[lead] = dict(counts)
    assert per[()] == per[(1,)] == per[(B,)], per
    assert per[()]["ntt"] > 0 and per[()]["intt"] > 0


@pytest.mark.parametrize("logn", [16, 17])
def test_large_ring_routing_bit_equal_on_cpu(logn):
    """The route ntt / intt take on the card above 2^15 (a local mesh of
    N / 2^15 shards, its local stages through ntt / intt on 2^15 rows)
    gives the plain transform, bit for bit, here on [2, 2^logn]."""
    primes = tuple(find_ntt_primes(30, 2, 2 << logn))
    t = TN.ntt_tables(1 << logn, primes, CPU)
    gen = torch.Generator().manual_seed(logn)
    a = torch.stack([torch.randint(0, p, (1 << logn,), generator=gen)
                     for p in primes])
    fwd = TN.sharded_ring(a, t)
    assert torch.equal(fwd, TN.ntt_plain(a, t))
    assert torch.equal(TN.sharded_ring(fwd, t, inverse=True),
                       TN.intt_plain(fwd, t))
