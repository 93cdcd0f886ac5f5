"""The key-switch passes that the CUDA kernels K6-K8 take over
(hectr_tpu_torch/csrc/keyswitch.cu), on the CPU.

* Their plain versions and the new call forms (``_inner_product(...,
  perm=)``, ``mod_down_tail``) bit for bit against the JAX package, on
  chains shaped like FLAGSHIP's (two special primes, width-2 digit groups,
  an odd limb count so that the last group is truncated), both key layouts.
* A numpy emulation of each kernel's own arithmetic (32-bit lazy Shoup
  words, the float64 correction in the kernel's order, the compact
  layout's 64-bit sums folded every 16 digits) against the plain version,
  with residues 0 and p - 1 planted.  The kernels themselves run only on
  the card (tests/test_torch_cuda.py).
* The wrappers' refusals, which all come before any launch, and the bound
  helpers' byte counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hectr_tpu import config as jcfg
from hectr_tpu.ckks import gemv as JG
from hectr_tpu.ckks import keyswitch as JK
from hectr_tpu.ckks import scheme as JS
from hectr_tpu.ckks.context import make_context as jmake_context
from hectr_tpu_torch import bench, interop
from hectr_tpu_torch import config as tcfg
from hectr_tpu_torch.ckks import basecvt as BC
from hectr_tpu_torch.ckks import gemv as TG
from hectr_tpu_torch.ckks import keyswitch as TK
from hectr_tpu_torch.ckks import scheme as TS
from hectr_tpu_torch.ckks.context import make_context
from hectr_tpu_torch.ops import keyswitch_cuda as KC
from tests.test_torch_keyswitch import _reference_diag_encoding
from tests.test_torch_scheme import CPU, jencode, u32

torch.set_num_threads(1)

# FLAGSHIP's shape of chain (S = 2 specials, alpha = 2) at small rings:
# 2 base + 2 * depth scale primes
SHAPES = {8: 3, 9: 2, 10: 3}


def preset(logn, depth=None, alpha=2, specials=2):
    return dict(name=f"ks-kernels-{logn}-{alpha}", logn=logn, slots=16,
                scale_bits=50, limb_bits=25,
                mult_depth=SHAPES.get(logn, 3) if depth is None else depth,
                special_limbs=specials, digit_width=alpha)


def contexts(fields):
    return (make_context(tcfg.CKKSPreset(**fields)),
            jmake_context(jcfg.CKKSPreset(**fields)))


def residues(primes, lead, n, rng):
    """Uniform residues [*lead, L, n] with 0 and p - 1 in columns 0, 1."""
    p = np.array(primes, dtype=np.int64).reshape(-1, 1)
    a = rng.integers(0, p, size=(*lead, len(primes), n))
    a[..., 0] = 0
    a[..., 1] = p[:, 0] - 1
    return a.astype(np.int64)


def switching_key(ctx, k, rng, compact):
    """A random key over a level-k operand: [dnum, 4 or 2, k+S, N] int64,
    the Shoup companions of (b, a) in rows 2:4 unless compact."""
    primes = ctx.data_primes[:k] + ctx.special_primes
    ba = residues(primes, (ctx.dnum(k), 2), ctx.n, rng)
    if compact:
        return ba
    p = np.array(primes, dtype=np.int64).reshape(-1, 1)
    sh = ((ba.astype(object) << 32) // p).astype(np.int64)
    return np.concatenate([ba, sh], axis=1)


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


# ---------------------------------------------------------------------------
# the plain versions and the new call forms against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logn", sorted(SHAPES))
@pytest.mark.parametrize("compact", [False, True], ids=["stored", "compact"])
def test_inner_product_with_perm_and_mod_down_bit_equal_jax(logn, compact):
    ctx, jctx = contexts(preset(logn))
    rng = np.random.default_rng(logn)
    for k in (ctx.max_limbs, ctx.max_limbs - 1):      # full and truncated
        assert (k % 2 == 1) == (k < ctx.dnum(k) * ctx.alpha)
        key = switching_key(ctx, k, rng, compact)
        digits = residues(ctx.data_primes[:k] + ctx.special_primes,
                          (ctx.dnum(k),), ctx.n, rng)
        g = TK.galois_element(3, ctx.n)
        perm = TK.permutation(ctx.n, g, CPU)
        got = TK._inner_product(ctx, t64(digits), t64(key), k, sliced=True,
                                perm=perm)
        jperm = jnp.asarray(JK.eval_permutation(ctx.n, g))
        want = jax.jit(lambda d, key: JK._inner_product(
            jctx, d[..., jperm], key, k, sliced=True))(
                jnp.asarray(digits.astype(np.uint32)),
                jnp.asarray(key.astype(np.uint32)))
        assert np.array_equal(u32(got), np.asarray(want)), k
        # the same with the permutation taken before the call
        assert torch.equal(got, TK._inner_product(
            ctx, t64(digits).index_select(-1, perm), t64(key), k,
            sliced=True))
        acc = t64(residues(ctx.data_primes[:k] + ctx.special_primes, (2,),
                           ctx.n, rng))
        down = TK._mod_down_special(ctx, acc, k)
        jdown = jax.jit(lambda a: JK._mod_down_special(jctx, a, k))(
            jnp.asarray(acc.numpy().astype(np.uint32)))
        assert np.array_equal(u32(down), np.asarray(jdown)), k


def test_mod_down_tail_on_a_view_equals_contiguous():
    ctx = make_context(tcfg.CKKSPreset(**preset(9)))
    rng = np.random.default_rng(4)
    k = ctx.max_limbs - 1
    acc = t64(residues(ctx.data_primes[:k] + ctx.special_primes, (3, 2),
                       ctx.n, rng))
    ext = t64(residues(ctx.data_primes[:k], (3, 2), ctx.n, rng))
    pinv, pinv_sh = TK._ks_constants(ctx, k, CPU)
    p = ctx.tables(k, CPU).p
    view = acc[..., :k, :]
    assert KC.lead_stride(view) == (k + len(ctx.special_primes)) * ctx.n
    got = TK.mod_down_tail(view, ext, pinv, pinv_sh, p)
    assert torch.equal(got, TK.mod_down_tail_plain(view.contiguous(), ext,
                                                   pinv, pinv_sh, p))
    assert KC.lead_stride(acc.transpose(0, 1)[..., :k, :]) is None


@pytest.fixture(scope="module")
def flagship_like():
    """logN=9, 8 data limbs + 2 specials, alpha = 2, keys of the JAX
    package for the diagonals and the baby and giant steps below."""
    ctx, jctx = contexts(preset(9))
    jkeys = JS.keygen(jctx, jax.random.PRNGKey(0))
    keys = interop.keyset(jkeys.sk, jkeys.pk, CPU)
    rotations = [1, 2, 3, 4, 5, 8, 12]
    jrk = JK.gen_rotation_keys(jctx, jkeys, jax.random.PRNGKey(1),
                               rotations=rotations)
    rk = interop.rotation_keys({r: np.asarray(x) for r, x in jrk.items()}, CPU)
    v = np.linspace(-2, 2, 16)
    jct = jax.jit(lambda p: JS.encrypt(jctx, jkeys, p, jax.random.PRNGKey(2)))(
        jencode(jctx, v, np.zeros(16), ctx.max_limbs))
    ct = interop.ciphertext(jct.data, jct.scale, CPU)
    return ctx, jctx, keys, rk, jrk, ct, jct, v


@pytest.mark.parametrize("method", ["diag", "bsgs"])
def test_hoisted_gemvs_bit_equal_jax_with_perm_in_the_inner_product(
        flagship_like, monkeypatch, method):
    """The hoisted rotations hand their permutation to ``_inner_product``
    (the kernel reads the digits through it) instead of permuting the
    digit stack; the gemv stays the JAX package's, bit for bit."""
    ctx, jctx, keys, rk, jrk, ct, jct, v = flagship_like
    monkeypatch.setattr(TG, "_encode_diags", _reference_diag_encoding(jctx))
    M = np.zeros((16, 16))
    idx = np.arange(16)
    for r, w in ((0, 0.5), (1, -0.25), (5, 0.125)):
        M[idx, (idx + r) % 16] = w
    calls = []
    inner = TG._inner_product

    def spy(*args, **kw):
        calls.append(kw.get("perm") is not None)
        return inner(*args, **kw)

    monkeypatch.setattr(TG, "_inner_product", spy)
    k = ctx.max_limbs
    mat = JG.gemv_materials(jctx, M, k, jrk, method=method)
    want = jax.jit(lambda m, c: JG.gemv_apply(
        jctx, m, JS.Ciphertext(data=c, scale=jct.scale)).data)(mat, jct.data)
    got = TG.gemv(ctx, M, ct, rk, method=method)
    assert np.array_equal(u32(got.data), np.asarray(want))
    assert any(calls)
    re, _ = TS.decode_ri(ctx, TS.decrypt(ctx, keys, got))
    assert np.max(np.abs(re.numpy() - M @ v)) < 1e-7


# ---------------------------------------------------------------------------
# numpy emulations of the kernels' arithmetic (csrc/keyswitch.cu)
# ---------------------------------------------------------------------------

MASK = np.uint64(0xFFFFFFFF)


def u64(a):
    return np.asarray(a).astype(np.uint64)


def mul_shoup_lazy(a, w, w_shoup, p):
    """csrc/modmath.cuh: a * w - umulhi(a, w') * p, wrapping in 32 bits."""
    q = (u64(a) * u64(w_shoup)) >> np.uint64(32)
    return (u64(a) * u64(w) - q * u64(p)) & MASK


def add_lazy(a, b, p2):
    p2 = u64(p2)
    s = (u64(a) + u64(b)) & MASK
    return np.where(s >= p2, s - p2, s)


def sub_lazy(a, b, p2):
    p2 = u64(p2)
    d = (u64(a) + p2 - u64(b)) & MASK
    return np.where(d >= p2, d - p2, d)


def reduce(v, p):
    v, p = u64(v), u64(p)
    return np.where(v >= p, v - p, v)


def k6_emulated(x, c, grouped):
    """K6 column by column: canonical y, dummy rows (q = 1) skipped, the
    float64 quotients summed left to right, rint, lazy sums."""
    G, A = (c.dnum, c.alpha) if grouped else (1, c.g)
    x = x.reshape(-1, G, A, x.shape[-1])
    inv = c.inv.numpy().reshape(G, A)
    inv_sh = c.inv_shoup.numpy().reshape(G, A)
    q = c.q_col.numpy().reshape(G, A)
    M = c.M.numpy().reshape(G, A, c.t)
    M_sh = c.M_shoup.numpy().reshape(G, A, c.t)
    Qm = c.Qmod.numpy().reshape(G, c.t)
    Qm_sh = c.Qmod_shoup.numpy().reshape(G, c.t)
    p = c.p.numpy().reshape(c.t)
    out = np.empty((x.shape[0], G, c.t, x.shape[-1]), dtype=np.uint64)
    for g in range(G):
        real = [a for a in range(A) if q[g, a] != 1]
        y = {a: reduce(mul_shoup_lazy(x[:, g, a], inv[g, a], inv_sh[g, a],
                                      q[g, a]), q[g, a]) for a in real}
        s = y[real[0]].astype(np.float64) / np.float64(q[g, real[0]])
        for a in real[1:]:
            s = s + y[a].astype(np.float64) / np.float64(q[g, a])
        v = np.rint(s).astype(np.uint64)
        for t in range(c.t):
            p2 = np.uint64(2 * p[t])
            acc = np.zeros_like(v)
            for a in real:
                acc = add_lazy(acc, mul_shoup_lazy(y[a], M[g, a, t],
                                                   M_sh[g, a, t], p[t]), p2)
            corr = mul_shoup_lazy(v, Qm[g, t], Qm_sh[g, t], p[t])
            out[:, g, t] = reduce(sub_lazy(acc, corr, p2), np.uint64(p[t]))
    return out.astype(np.int64)


def k7_emulated(digits, key, p, perm=None):
    """K7: lazy Shoup sums with the stored companions, or 64-bit sums of
    the full products folded mod p every 16 digits (compact)."""
    *lead, dnum, R, C = digits.shape
    d = u64(digits.reshape(-1, dnum, R, C))
    if perm is not None:
        d = d[..., perm]
    pc = u64(p).reshape(R, 1)
    out = np.empty((d.shape[0], 2, R, C), dtype=np.uint64)
    for c in range(2):
        if key.shape[1] == 4:
            acc = np.zeros((d.shape[0], R, C), dtype=np.uint64)
            for j in range(dnum):
                acc = add_lazy(acc, mul_shoup_lazy(d[:, j], key[j, c],
                                                   key[j, 2 + c], pc), 2 * pc)
            out[:, c] = reduce(acc, pc)
        else:
            acc = np.zeros((d.shape[0], R, C), dtype=np.uint64)
            for j in range(dnum):
                prod = d[:, j] * u64(key[j, c])
                assert (acc <= np.iinfo(np.uint64).max - prod).all()
                acc = acc + prod
                if j % 16 == 15:
                    acc = acc % pc
            out[:, c] = acc % pc
    return out.astype(np.int64).reshape(*lead, 2, R, C)


def k8_emulated(acc, ext, pinv, pinv_sh, p):
    pc, pi, ps = (u64(a).reshape(-1, 1) for a in (p, pinv, pinv_sh))
    return reduce(mul_shoup_lazy(sub_lazy(acc, ext, 2 * pc), pi, ps, pc),
                  pc).astype(np.int64)


@pytest.mark.parametrize("logn", sorted(SHAPES))
@pytest.mark.parametrize("drop", [0, 1])
def test_k6_emulation_equals_plain_grouped_convert(logn, drop):
    ctx = make_context(tcfg.CKKSPreset(**preset(logn)))
    rng = np.random.default_rng(10 * logn + drop)
    k = ctx.max_limbs - drop
    dnum, alpha = ctx.dnum(k), ctx.alpha
    x = residues(ctx.data_primes[:k], (2,), ctx.n, rng)
    # the largest residue in every row of the last columns: v at its top
    x[..., -4:] = np.array(ctx.data_primes[:k]).reshape(-1, 1) - 1
    x = np.concatenate([x, np.zeros((2, dnum * alpha - k, ctx.n), np.int64)],
                       axis=1).reshape(2, dnum, alpha, ctx.n)
    c = BC.grouped_conv_constants(
        ctx.digit_groups(k), ctx.data_primes[:k] + ctx.special_primes, CPU)
    want = BC.grouped_convert_plain(t64(x), c).numpy()
    assert np.array_equal(k6_emulated(x, c, True).reshape(want.shape), want)
    assert torch.equal(BC.grouped_convert(t64(x), c), t64(want))
    # the mod-down's one-group form: the special rows to the data chain
    last = residues(ctx.special_primes, (2,), ctx.n, rng)
    b = BC.base_conv_constants(ctx.special_primes, ctx.data_primes[:k], CPU)
    want = BC.base_convert_plain(t64(last), b).numpy()
    assert np.array_equal(k6_emulated(last, b, False).reshape(want.shape),
                          want)


@pytest.mark.parametrize("alpha,depth", [(2, 3), (1, 8)],
                         ids=["alpha2", "dnum18"])
@pytest.mark.parametrize("compact", [False, True], ids=["stored", "compact"])
def test_k7_k8_emulation_equals_plain(alpha, depth, compact):
    """dnum18: 17 digits at the level below the top, so the compact sum
    folds once on the way."""
    ctx = make_context(tcfg.CKKSPreset(**preset(8, depth, alpha)))
    rng = np.random.default_rng(depth)
    k = ctx.max_limbs - 1
    t = ctx.tables_ks(k, CPU)
    key = switching_key(ctx, k, rng, compact)
    digits = residues(t.primes, (3, ctx.dnum(k)), ctx.n, rng)
    digits[..., -2:] = np.array(t.primes).reshape(-1, 1) - 1
    if compact:
        key[..., -2:] = np.array(t.primes).reshape(-1, 1) - 1
    perm = TK.eval_permutation(ctx.n, TK.galois_element(5, ctx.n))
    for pm in (None, perm):
        want = TK.key_inner_product(t64(digits), t64(key), t,
                                    None if pm is None else t64(pm)).numpy()
        got = k7_emulated(digits, key, t.p.numpy(), pm)
        assert np.array_equal(got, want), pm is None
    acc = residues(t.primes, (3, 2), ctx.n, rng)[..., :k, :]
    ext = residues(ctx.data_primes[:k], (3, 2), ctx.n, rng)
    pinv, pinv_sh = TK._ks_constants(ctx, k, CPU)
    want = TK.mod_down_tail(t64(acc), t64(ext), pinv, pinv_sh,
                            ctx.tables(k, CPU).p).numpy()
    got = k8_emulated(acc, ext, pinv.numpy(), pinv_sh.numpy(),
                      ctx.tables(k, CPU).p.numpy())
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the wrappers' refusals, the CPU path's launches, the bound helpers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def operands():
    ctx = make_context(tcfg.CKKSPreset(**preset(8)))
    rng = np.random.default_rng(0)
    k = ctx.max_limbs - 1
    t = ctx.tables_ks(k, CPU)
    return dict(
        ctx=ctx, k=k, t=t,
        grouped=t64(residues(ctx.data_primes[:k] + (1,), (), ctx.n, rng)
                    ).unflatten(-2, (ctx.dnum(k), ctx.alpha)),
        gc=BC.grouped_conv_constants(ctx.digit_groups(k), t.primes, CPU),
        last=t64(residues(ctx.special_primes, (2,), ctx.n, rng)),
        bc=BC.base_conv_constants(ctx.special_primes, ctx.data_primes[:k],
                                  CPU),
        digits=t64(residues(t.primes, (ctx.dnum(k),), ctx.n, rng)),
        key=t64(switching_key(ctx, k, rng, False)),
        acc=t64(residues(t.primes, (2,), ctx.n, rng)),
        ext=t64(residues(ctx.data_primes[:k], (2,), ctx.n, rng)),
        pinv=TK._ks_constants(ctx, k, CPU),
        perm=TK.permutation(ctx.n, TK.galois_element(1, ctx.n), CPU))


def refusals(o):
    """(call, the error it must raise, what the message names)."""
    k, t = o["k"], o["t"]
    pinv, pinv_sh = o["pinv"]
    p = o["ctx"].tables(k, CPU).p
    acc_k = o["acc"][..., :k, :]
    return [
        # a CPU tensor: right in every other way
        (lambda: KC.base_convert_cuda(o["grouped"], o["gc"], True),
         ValueError, "tensors on"),
        (lambda: KC.base_convert_cuda(o["last"], o["bc"], False),
         ValueError, "tensors on"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"], t.p),
         ValueError, "tensors on"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"][:, :2]
                                           .contiguous(), t.p, o["perm"]),
         ValueError, "tensors on"),
        (lambda: KC.mod_down_tail_cuda(acc_k, o["ext"], pinv, pinv_sh, p),
         ValueError, "tensors on"),
        # not int64
        (lambda: KC.base_convert_cuda(o["grouped"].int(), o["gc"], True),
         TypeError, "int64"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"].int(), t.p),
         TypeError, "int64"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"], t.p,
                                           o["perm"].int()),
         TypeError, "int64"),
        (lambda: KC.mod_down_tail_cuda(acc_k, o["ext"].double(), pinv,
                                       pinv_sh, p), TypeError, "int64"),
        # shapes the kernels do not take
        (lambda: KC.base_convert_cuda(o["grouped"][:, :1].contiguous(),
                                      o["gc"], True),
         ValueError, "base conversion"),
        (lambda: KC.base_convert_cuda(o["digits"], o["bc"], False),
         ValueError, "base conversion"),
        (lambda: KC.base_convert_cuda(o["grouped"].transpose(-1, -3), o["gc"],
                                      True), ValueError, "contiguous"),
        (lambda: KC.key_inner_product_cuda(o["digits"][:-1], o["key"], t.p),
         ValueError, "digits"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"][:, :3]
                                           .contiguous(), t.p),
         ValueError, "4 or 2"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"], t.p[:-1]),
         ValueError, "p of"),
        (lambda: KC.key_inner_product_cuda(o["digits"], o["key"], t.p,
                                           o["perm"][:-1]),
         ValueError, "perm of"),
        (lambda: KC.mod_down_tail_cuda(o["acc"], o["ext"], pinv, pinv_sh, p),
         ValueError, "differ"),
        (lambda: KC.mod_down_tail_cuda(acc_k, o["ext"], pinv[:-1], pinv_sh,
                                       p), ValueError, "pinv of"),
        # leading rows that do not flatten to one stride
        (lambda: KC.mod_down_tail_cuda(
            acc_k.expand(2, -1, -1, -1), o["ext"].expand(2, -1, -1, -1)
            .contiguous(), pinv, pinv_sh, p), ValueError, "strides"),
    ]


def test_wrappers_refuse_what_they_do_not_take_before_any_launch(operands):
    before = dict(KC.LAUNCHES)
    shapes = dict(KC.LAUNCH_SHAPES)
    for call, err, words in refusals(operands):
        with pytest.raises(err, match=words):
            call()
    assert KC.LAUNCHES == before and dict(KC.LAUNCH_SHAPES) == shapes


def test_cpu_tensors_take_the_plain_path(operands):
    o = operands
    before = dict(KC.LAUNCHES)
    k, t = o["k"], o["t"]
    assert torch.equal(BC.grouped_convert(o["grouped"], o["gc"]),
                       BC.grouped_convert_plain(o["grouped"], o["gc"]))
    assert torch.equal(BC.base_convert(o["last"], o["bc"]),
                       BC.base_convert_plain(o["last"], o["bc"]))
    assert torch.equal(TK.key_inner_product(o["digits"], o["key"], t),
                       TK.key_inner_product_plain(o["digits"], o["key"], t))
    pinv, pinv_sh = o["pinv"]
    p = o["ctx"].tables(k, CPU).p
    assert torch.equal(
        TK.mod_down_tail(o["acc"][..., :k, :], o["ext"], pinv, pinv_sh, p),
        TK.mod_down_tail_plain(o["acc"][..., :k, :], o["ext"], pinv, pinv_sh,
                               p))
    assert KC.LAUNCHES == before


def test_keyswitch_bound_bytes_by_hand():
    N = 1 << 15
    # FLAGSHIP's top level: k = 22, S = 2, alpha = 2, dnum = 11
    consts = 11 * 2 * 3 + 11 * 2 * 24 * 2 + 11 * 24 * 2 + 24
    assert bench.keyswitch_work("base_convert", (11, 2, N), 24) == (
        ((11 * 2 + 11 * 24) * N + consts) * 8, 11 * N * (2 + 48 + 24))
    assert bench.keyswitch_work("base_convert", (2, 1, 2, N), 22)[0] == (
        ((4 + 44) * N + 1 * 2 * 3 + 2 * 22 * 2 + 22 * 2 + 22) * 8)
    assert bench.keyswitch_work("key_inner_product", (11, 24, N)) == (
        ((11 * 24 + 11 * 4 * 24 + 2 * 24) * N + 24) * 8, 2 * 11 * 24 * N)
    assert bench.keyswitch_work("key_inner_product", (11, 24, N),
                                perm=True)[0] == (
        ((11 * 24 + 11 * 4 * 24 + 2 * 24) * N + 24 + N) * 8)
    assert bench.keyswitch_work("mod_down_tail", (2, 22, N)) == (
        (3 * 2 * 22 * N + 3 * 22) * 8, 2 * 22 * N)
    # the MB of the tables of the design: int64 in + out
    cases = [(("base_convert", (11, 2, N)), {"targets": 24}, 74.97),
             (("base_convert", (2, 1, 2, N)), {"targets": 22}, 12.58),
             (("key_inner_product", (11, 24, N)), {}, 358.6),
             (("mod_down_tail", (2, 22, N)), {}, 34.6),
             (("base_convert", (16, 2, N)), {"targets": 34}, 151.0),
             (("key_inner_product", (16, 34, N)), {"key_words": 2}, 445.6)]
    for args, kw, mb in cases:
        nbytes, _ = bench.keyswitch_work(*args, **kw)
        assert abs(nbytes / 1e6 - mb) < 0.05, (args, nbytes)
        ms, by = bench.keyswitch_bound(*args, mult_peak=5.58e12, **kw)
        assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    with pytest.raises(ValueError):
        bench.keyswitch_work("ntt", (2, N))
